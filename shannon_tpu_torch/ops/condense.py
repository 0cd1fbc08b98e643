"""de Bruijn graph condensation by pointer doubling.

Counterpart of ``shannon_tpu/ops/condense.py``:

  1. oriented node table: both strands of every canonical k-mer, sorted,
     palindromes deduped (K2 through ``unique_first_sorted``);
  2. links: one sort of the 2*C2 suffix/prefix (k-1)-mer records groups
     every edge endpoint; a group with one source and one target is a
     mergeable link, and each node's target run is its successor list;
  3. labels: pointer doubling to each chain's head, with a cycle check and
     a min-propagation pass that cuts isolated cycles at their lowest lane;
  4. per-contig reduction (klen, exact count sum, float32 abundance, head
     and tail lanes), contig edges, and the reverse-complement twin (K3).

Node lanes: capacity C2; contig-indexed arrays are valid in [0, n_contigs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shannon_tpu_torch.ops.count import Spectrum, unique_first_sorted
from shannon_tpu_torch.ops.kmers import PAD, revcomp_key
from shannon_tpu_torch.ops.spectrum import lookup_sorted


@dataclass
class ContigArrays:
    """Contig graph on the device (ops/condense.py:40 ContigArrays)."""

    # per oriented node [C2]
    node_key: torch.Tensor  # int64, PAD past n_nodes
    node_count: torch.Tensor  # int32
    node_cid: torch.Tensor  # int64 contig id, -1 on pads
    node_off: torch.Tensor  # int64 offset within the contig, -1 on pads
    # per contig [C2]
    klen: torch.Tensor  # int64 member k-mers
    abundance: torch.Tensor  # float32 = f32(count_sum) / f32(klen)
    count_sum: torch.Tensor  # int64 exact sum of member counts
    head_lane: torch.Tensor  # int64 node lane of the first k-mer
    tail_lane: torch.Tensor  # int64 node lane of the last k-mer
    out_edges: torch.Tensor  # [4, C2] int64 successor cid or -1
    rc_pair: torch.Tensor  # int64 reverse-complement twin cid
    n_nodes: int
    n_contigs: int


def nodes_stage(spec: Spectrum, k: int, canonical: bool):
    """Oriented node table (ops/condense.py:82 _nodes_stage)."""
    if not canonical:
        return spec.key, spec.count, spec.n
    pad = spec.key == PAD
    rc = torch.where(pad, PAD, revcomp_key(spec.key, k))
    keys, order = torch.sort(torch.cat([spec.key, rc]))
    counts = torch.cat([spec.count, spec.count])[order]
    # palindromes appear twice with the same count: keep the first
    key, (count,), n = unique_first_sorted(keys, (counts,), 2 * spec.capacity)
    return key, count, n


def links_stage(node_key: torch.Tensor, k: int):
    """Mergeable links and successor directory from one (k-1)-mer group
    join (ops/condense.py:109 _links_stage).  Returns (prev_link,
    rec_lane, firstP, p_cnt); the reference's next_link has no reader."""
    C2 = node_key.shape[0]
    dev = node_key.device
    m = 2 * C2
    pad = node_key == PAD
    suf = torch.where(pad, PAD, node_key & ((1 << (2 * (k - 1))) - 1))
    pre = torch.where(pad, PAD, node_key >> 2)
    lane = torch.arange(C2, device=dev)
    key = torch.cat([suf, pre])
    side = torch.cat([torch.zeros(C2, dtype=torch.int64, device=dev),
                      torch.ones(C2, dtype=torch.int64, device=dev)])
    # order by ((k-1)-mer, side, lane): sources before targets in a group
    # (real (k-1)-mer keys < 2^60, so key * 2 + side cannot overflow), lane
    # order within a side from the stable sort
    sort_key = torch.where(key == PAD, PAD, key * 2 + side)
    order = torch.sort(sort_key, stable=True).indices
    key_s, side_s, lane_s = key[order], side[order], torch.cat([lane, lane])[order]

    valid = key_s != PAD
    new_group = torch.ones(m, dtype=torch.bool, device=dev)
    new_group[1:] = key_s[1:] != key_s[:-1]
    gid = torch.cumsum(new_group, 0) - 1
    starts = torch.nonzero(new_group).flatten()
    ends = torch.cat([starts[1:], torch.tensor([m], device=dev)])
    is_src = side_s == 0
    src_before = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    src_before[1:] = torch.cumsum(is_src, 0)
    g0 = starts[gid]
    s_cnt = (src_before[ends] - src_before[starts])[gid]
    p_cnt = (ends - starts)[gid] - s_cnt
    first_p = g0 + s_cnt

    single = valid & (s_cnt == 1) & (p_cnt == 1)
    prev_cand = torch.where(single & ~is_src, lane_s[g0], -1)
    fp_out = torch.where(is_src & valid, first_p, 0)
    pc_out = torch.where(is_src & valid, p_cnt, 0)

    # back to node order: every lane has one source and one target record
    src_lane, dst_lane = lane_s[is_src], lane_s[~is_src]
    prev_link = torch.empty(C2, dtype=torch.int64, device=dev)
    prev_link[dst_lane] = prev_cand[~is_src]
    first_p_lane = torch.empty(C2, dtype=torch.int64, device=dev)
    first_p_lane[src_lane] = fp_out[is_src]
    p_cnt_lane = torch.empty(C2, dtype=torch.int64, device=dev)
    p_cnt_lane[src_lane] = pc_out[is_src]
    return prev_link, lane_s, first_p_lane, p_cnt_lane


def label_stage(prev_link: torch.Tensor):
    """Pointer doubling to each chain head with early exit
    (ops/condense.py:232 _label_stage).  Returns (head pointer, offset,
    any-cycle flag); capped at log2(C2) rounds, after which only lanes on
    cycles still see a predecessor at their root."""
    C2 = prev_link.shape[0]
    has_prev = prev_link >= 0
    ptr = torch.where(has_prev, prev_link, torch.arange(C2, device=prev_link.device))
    dist = has_prev.long()
    for _ in range(max(C2.bit_length(), 1)):
        nd = dist + dist[ptr]
        np_ = ptr[ptr]
        changed = bool((np_ != ptr).any())
        ptr, dist = np_, nd
        if not changed:
            break
    return ptr, dist, bool((prev_link[ptr] >= 0).any())


def cycle_fix(prev_link: torch.Tensor) -> torch.Tensor:
    """Cut isolated cycles at their minimum lane (ops/condense.py:264
    _cycle_fix): min-propagating pointer doubling, full log2(C2) rounds."""
    C2 = prev_link.shape[0]
    iota = torch.arange(C2, device=prev_link.device)
    ptr = torch.where(prev_link >= 0, prev_link, iota)
    mn = iota
    for _ in range(max(C2.bit_length(), 1)):
        mn = torch.minimum(mn, mn[ptr])
        ptr = ptr[ptr]
    cycle_head = (prev_link[ptr] >= 0) & (mn == iota)
    return torch.where(cycle_head, -1, prev_link)


def reduce_stage(
    node_key, node_count, n_nodes, prev2, head_ptr, dist,
    rec_lane, first_p, p_cnt, k: int, canonical: bool,
) -> ContigArrays:
    """Per-contig reductions, edges and rc twins from the labeled nodes
    (ops/condense.py:287 _reduce_stage).  Offsets within a contig are
    0..klen-1, so the reductions are scatters keyed by contig id."""
    C2 = node_key.shape[0]
    dev = node_key.device
    iota = torch.arange(C2, device=dev)
    real = node_key != PAD
    is_head = real & (prev2 < 0)
    n_contigs = int(is_head.sum())
    cid_of_lane = torch.where(is_head, torch.cumsum(is_head, 0) - 1, -1)
    node_cid = torch.where(real, cid_of_lane[head_ptr], -1)

    lanes = torch.nonzero(real).flatten()
    cid_r, off_r = node_cid[lanes], dist[lanes]
    klen = torch.zeros(C2, dtype=torch.int64, device=dev)
    klen.scatter_add_(0, cid_r, torch.ones_like(cid_r))
    csum = torch.zeros(C2, dtype=torch.int64, device=dev)
    csum.scatter_add_(0, cid_r, node_count[lanes].long())
    head_lane = torch.full((C2,), -1, dtype=torch.int64, device=dev)
    at_head = off_r == 0
    head_lane[cid_r[at_head]] = lanes[at_head]
    tail_lane = torch.full((C2,), -1, dtype=torch.int64, device=dev)
    at_tail = off_r == klen[cid_r] - 1
    tail_lane[cid_r[at_tail]] = lanes[at_tail]
    abundance = torch.where(
        klen > 0, csum.float() / klen.float().clamp(min=1), 0.0
    )

    # contig edges: the successor run of the tail node in the link records
    tl = tail_lane.clamp(0, C2 - 1)
    fp_t, pc_t = first_p[tl], p_cnt[tl]
    m = rec_lane.shape[0]
    rows = []
    for j in range(4):
        v_lane = rec_lane[(fp_t + j).clamp(0, m - 1)]
        hit_j = (j < pc_t) & (tail_lane >= 0)
        rows.append(torch.where(hit_j, node_cid[v_lane.clamp(0, C2 - 1)], -1))
    out_edges = torch.stack(rows)

    # rc twin: the contig whose head k-mer is revcomp(this tail k-mer)
    if canonical:
        rc_idx, rc_hit = lookup_sorted(node_key, revcomp_key(node_key[tl], k))
        rc_is_head = dist[rc_idx] == 0
        rc_pair = torch.where(
            (tail_lane >= 0) & rc_hit & rc_is_head, node_cid[rc_idx], iota
        )
    else:
        rc_pair = iota
    return ContigArrays(
        node_key=node_key,
        node_count=node_count,
        node_cid=node_cid,
        node_off=torch.where(real, dist, -1),
        klen=klen,
        abundance=abundance,
        count_sum=csum,
        head_lane=head_lane,
        tail_lane=tail_lane,
        out_edges=out_edges,
        rc_pair=rc_pair,
        n_nodes=n_nodes,
        n_contigs=n_contigs,
    )


def build_contig_arrays(spec: Spectrum, k: int, canonical: bool = True) -> ContigArrays:
    """Condense a (corrected) spectrum into its contig graph
    (ops/condense.py:202 build_contig_arrays)."""
    node_key, node_count, n_nodes = nodes_stage(spec, k, canonical)
    prev_link, rec_lane, first_p, p_cnt = links_stage(node_key, k)
    ptr, dist, has_cycle = label_stage(prev_link)
    if has_cycle:
        prev_link = cycle_fix(prev_link)
        ptr, dist, _ = label_stage(prev_link)
    return reduce_stage(
        node_key, node_count, n_nodes, prev_link, ptr, dist,
        rec_lane, first_p, p_cnt, k, canonical,
    )


def contig_base_streams(ca: ContigArrays, k: int):
    """(tails, heads): every node's last base in (cid, offset) order, and
    each contig's k-1 leading bases [n_contigs, k-1]
    (ops/condense.py:417 contig_base_streams)."""
    C2 = ca.node_key.shape[0]
    lanes = torch.nonzero(ca.node_cid >= 0).flatten()
    order = torch.argsort(ca.node_cid[lanes] * C2 + ca.node_off[lanes])
    tails = (ca.node_key[lanes[order]] & 3).to(torch.uint8)
    head = ca.node_key[ca.head_lane[: ca.n_contigs].clamp(0, C2 - 1)]
    shifts = 2 * (k - 1 - torch.arange(k - 1, device=head.device))
    heads = ((head[:, None] >> shifts[None, :]) & 3).to(torch.uint8)
    return tails, heads


# host code below: copied from shannon_tpu/ops/condense.py:448
# contig_sequences and :477 to_contig_graph, reading the port's arrays


def contig_sequences(ca: ContigArrays, k: int) -> list[str]:
    """Contig base strings from the device base streams."""
    n_contigs = ca.n_contigs
    klen = ca.klen[:n_contigs].cpu().numpy()
    tails_dev, heads_dev = contig_base_streams(ca, k)
    tails = tails_dev.cpu().numpy()
    heads = heads_dev.cpu().numpy()
    total_tails = int(klen.sum())
    tails = tails[:total_tails]

    lengths = klen + k - 1
    starts = np.zeros(n_contigs + 1, dtype=np.int64)
    np.cumsum(lengths, out=starts[1:])
    buf = np.zeros(int(starts[-1]), dtype=np.uint8)
    # contig c = heads[c] (k-1 leading bases) + its tail-base run
    idx_h = starts[:-1][:, None] + np.arange(k - 1, dtype=np.int64)[None, :]
    buf[idx_h.ravel()] = heads.ravel()
    tcum = np.zeros(n_contigs, dtype=np.int64)
    np.cumsum(klen[:-1], out=tcum[1:])
    within = np.arange(total_tails, dtype=np.int64) - np.repeat(tcum, klen)
    buf[np.repeat(starts[:-1] + k - 1, klen) + within] = tails
    chars = np.frombuffer(b"ACGT", dtype=np.uint8)[buf]
    return [
        chars[starts[i] : starts[i + 1]].tobytes().decode("ascii")
        for i in range(n_contigs)
    ]


def to_contig_graph(ca: ContigArrays, k: int, config) -> "ContigGraph":
    """The oracle-format ContigGraph (sequences, edges, rc pairing) of
    the device arrays, for the host assembly stages."""
    from shannon_tpu.oracle.graph import Contig, ContigGraph
    from shannon_tpu_torch.ops.tipclip import _adjacency_lists

    n = ca.n_contigs
    seqs = contig_sequences(ca, k)
    abund = ca.abundance[:n].cpu().numpy()
    klens = ca.klen[:n].cpu().numpy()
    contigs = [
        Contig(kmers=[], seq=seqs[i], abundance=float(abund[i]))
        for i in range(n)
    ]
    out_e = ca.out_edges[:, :n].cpu().numpy()
    out_edges = _adjacency_lists(out_e, n)
    mask = out_e >= 0
    src = np.broadcast_to(np.arange(n, dtype=np.int64), out_e.shape)[mask]
    dst = out_e[mask].astype(np.int64)
    if len(dst):
        pairs = np.unique(dst * n + src)
        counts = np.bincount(pairs // n, minlength=n)
        in_edges = [
            seg.tolist() for seg in np.split(pairs % n, np.cumsum(counts)[:-1])
        ]
    else:
        in_edges = [[] for _ in range(n)]
    g = ContigGraph(
        k=k,
        contigs=contigs,
        out_edges=out_edges,
        in_edges=in_edges,
        rc_pair=ca.rc_pair[:n].cpu().tolist(),
    )
    g._klen = klens.tolist()  # type: ignore[attr-defined]
    return g
