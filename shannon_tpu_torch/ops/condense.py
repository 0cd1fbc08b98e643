"""de Bruijn graph condensation by pointer doubling.

Counterpart of ``shannon_tpu/ops/condense.py``:

  1. oriented node table: both strands of every canonical k-mer, sorted,
     palindromes deduped (kernel K11, ``node_strands``: the spectrum's real
     reverse complements without the palindromes, sorted by ``torch.sort``,
     merged with the spectrum, with which they share no key);
  2. links: the 2*C2 suffix/prefix (k-1)-mer records in (k-1)-mer order
     group every edge endpoint; a group with one source and one target is
     a mergeable link, and each node's target run is its successor list
     (K12, ``group_links``: that order is the merge of five sorted runs of
     the node table, the targets and the sources of each first base, taken
     in key-range tiles, with no sort);
  3. labels: pointer doubling to each chain's head, with a cycle check and
     a min-propagation pass that cuts isolated cycles at their lowest lane
     (K13: ``label_round`` enqueues every round of the label stage at
     once, over a frontier, with one host read at its end; ``cycle_round``
     enqueues every round of the cut at once, over the cycle lanes the
     labels found, with an early stop and no host read);
  4. per-contig reduction (klen, exact count sum, float32 abundance, head
     and tail lanes), contig edges, and the reverse-complement twin (K14,
     ``contig_reduce``: contig ids from one look-back scan of the head
     lanes, integer atomics a member, then a pass over the contig slots);
  5. the base streams materialization reads (K15, ``base_streams``: each
     contig's tail start from one look-back scan of its klen, with the
     heads, then one pass over the real lanes).

On CUDA tensors each stage launches its hand-written kernels in
``csrc/condense.cu`` (around K11's ``torch.sort``) or raises; on CPU
tensors its ``_plain`` version runs.

Node lanes: capacity C2; contig-indexed arrays are valid in [0, n_contigs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shannon_tpu_torch import kernels
from shannon_tpu_torch.ops.count import Spectrum, unique_first_sorted
from shannon_tpu_torch.ops.kmers import PAD, revcomp_key
from shannon_tpu_torch.ops.spectrum import lookup_sorted_plain


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


# ---- K11: node table --------------------------------------------------------


def nodes_stage_plain(spec: Spectrum, k: int, canonical: bool):
    """Plain PyTorch K11 (ops/condense.py:82 _nodes_stage)."""
    if not canonical:
        return spec.key, spec.count, spec.n
    pad = spec.key == PAD
    rc = torch.where(pad, PAD, revcomp_key(spec.key, k))
    keys, order = torch.sort(torch.cat([spec.key, rc]))
    counts = torch.cat([spec.count, spec.count])[order]
    # palindromes appear twice with the same count: keep the first
    key, (count,), n = unique_first_sorted(keys, (counts,), 2 * spec.capacity)
    return key, count, n


def _nodes_stage_cuda(spec: Spectrum, k: int):
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    kernels.check_cuda("count", spec.count, torch.int32, 1)
    C = spec.capacity
    if spec.count.shape[0] != C:
        raise ValueError("key and count disagree on length")
    dev = spec.key.device
    n = min(spec.n, C)  # the real lanes: a table keeps at most C keys
    rc = torch.empty(n, dtype=torch.int64, device=dev)
    n_pal = torch.empty(1, dtype=torch.int64, device=dev)
    lib = kernels.library()
    lib.call("shannon_node_strands", dev, kernels.ptr(spec.key), n, k, kernels.ptr(rc),
             kernels.ptr(n_pal))
    rc_key, rc_lane = torch.sort(rc)
    node_key = torch.empty(2 * C, dtype=torch.int64, device=dev)
    node_count = torch.empty(2 * C, dtype=torch.int32, device=dev)
    lib.call(
        "shannon_node_merge", dev,
        kernels.ptr(spec.key), kernels.ptr(spec.count), n, kernels.ptr(rc_key),
        kernels.ptr(rc_lane), kernels.ptr(n_pal), 2 * C, kernels.ptr(node_key),
        kernels.ptr(node_count),
    )
    lib.count("node_strands")
    return node_key, node_count, 2 * n - int(n_pal)  # the one host read


def nodes_stage(spec: Spectrum, k: int, canonical: bool):
    """Oriented node table (ops/condense.py:82 _nodes_stage): (node_key
    [2C] sorted, PAD past n; node_count [2C] int32; n).  The identity when
    not canonical.  Kernel K11 on CUDA (the spectrum must hold canonical
    keys in its first min(n, C) lanes, sorted, as canonical counting writes
    them: the real reverse complements, sorted, merge with them), the plain
    version on CPU."""
    if not canonical:
        return spec.key, spec.count, spec.n
    if spec.key.is_cuda:
        return _nodes_stage_cuda(spec, k)
    return nodes_stage_plain(spec, k, canonical)


# ---- K12: links ---------------------------------------------------------------


def links_stage_plain(node_key: torch.Tensor, k: int):
    """Plain PyTorch K12 (ops/condense.py:109 _links_stage)."""
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


# Target lanes a K12 tile takes (its chunks' caps are in csrc/condense.cu).
LINK_TILE = 1024


def _links_stage_cuda(node_key: torch.Tensor, k: int, tile: int = LINK_TILE):
    kernels.check_cuda("node_key", node_key, torch.int64, 1)
    C2 = node_key.shape[0]
    dev = node_key.device
    # each tile edge's five lower bounds: sources of each first base, targets
    bounds = torch.empty(5 * (-(-C2 // tile) + 1), dtype=torch.int64, device=dev)
    prev_link = torch.empty(C2, dtype=torch.int64, device=dev)
    rec_lane = torch.empty(2 * C2, dtype=torch.int64, device=dev)
    first_p = torch.empty(C2, dtype=torch.int64, device=dev)
    p_cnt = torch.empty(C2, dtype=torch.int64, device=dev)
    lib = kernels.library()
    lib.call(
        "shannon_link_tiles", dev,
        kernels.ptr(node_key), C2, k, tile, kernels.ptr(bounds), bounds.shape[0],
        kernels.ptr(prev_link), kernels.ptr(rec_lane), kernels.ptr(first_p), kernels.ptr(p_cnt),
    )
    lib.count("group_links")
    return prev_link, rec_lane, first_p, p_cnt


def links_stage(node_key: torch.Tensor, k: int):
    """Mergeable links and successor directory from one (k-1)-mer group
    join (ops/condense.py:109 _links_stage).  Returns (prev_link [C2],
    rec_lane [2*C2], first_p [C2], p_cnt [C2]); the reference's next_link
    has no reader.  Kernel K12 on CUDA (the node table must be sorted,
    distinct, PAD past its real lanes, as nodes_stage writes it: the group
    join is a merge of its runs), the plain version on CPU."""
    if node_key.is_cuda:
        return _links_stage_cuda(node_key, k)
    return links_stage_plain(node_key, k)


# ---- K13: labels and cycle cuts ---------------------------------------------


def label_stage_plain(prev_link: torch.Tensor):
    """Plain PyTorch K13 labels (ops/condense.py:232 _label_stage)."""
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


# Node lanes K13's label stage takes: a lane's pointer is packed in 31 bits.
LABEL_MAX_LANES = (1 << 31) - 1


def _check_lanes(prev_link: torch.Tensor) -> None:
    if prev_link.shape[0] > LABEL_MAX_LANES:
        raise ValueError(f"{prev_link.shape[0]} node lanes exceed the 2^31 - 1 that K13's "
                         "packed pointers take")


def _label_launch(prev_link: torch.Tensor):
    """Enqueue every round of K13's label stage; (ptr, dist, ctl), nothing
    read back."""
    kernels.check_cuda("prev_link", prev_link, torch.int64, 1)
    C2 = prev_link.shape[0]
    dev = prev_link.device
    R = max(C2.bit_length(), 1)  # the round cap
    ptr = torch.empty(C2, dtype=torch.int64, device=dev)
    dist = torch.empty(C2, dtype=torch.int64, device=dev)
    ctl = torch.empty(2 * R + 1, dtype=torch.int32, device=dev)
    lib = kernels.library()
    # packed words and bitmaps, laid out by the kernel's source
    words = lib.scratch_words("shannon_label_rounds", C2)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    lib.call(
        "shannon_label_rounds", dev,
        kernels.ptr(prev_link), C2, kernels.ptr(scratch), words, kernels.ptr(ctl), ctl.shape[0],
        kernels.ptr(ptr), kernels.ptr(dist),
    )
    lib.count("label_round")
    return ptr, dist, ctl


def _label_stage_cuda(prev_link: torch.Tensor, info: dict | None):
    ptr, dist, ctl = _label_launch(prev_link)
    C2 = prev_link.shape[0]
    R = max(C2.bit_length(), 1)
    # the one host read: has_cycle, then each round's moved and staying lanes
    ctl = ctl.tolist() if C2 else [0] * (2 * R + 1)
    moved, stay = ctl[1 : R + 1], ctl[R + 1 :]
    run = next((t for t, n in enumerate(moved, 1) if n == 0), R) if C2 else 0
    if info is not None:
        info.update(rounds_run=run, frontier=([C2] + stay)[:run], host_reads=int(C2 > 0))
    return ptr, dist, bool(ctl[0])


def label_stage(prev_link: torch.Tensor, info: dict | None = None):
    """Pointer doubling to each chain head with early exit
    (ops/condense.py:232 _label_stage).  Returns (head pointer, offset,
    any-cycle flag); capped at log2(C2) rounds, after which only lanes on
    cycles still see a predecessor at their root.  Refuses tables of 2^31
    lanes or more.  Kernel K13 (``label_round``: every round enqueued at
    once over a frontier of the lanes whose pointer is no head yet, then one
    host read) on CUDA, the plain version on CPU.  With `info`, the CUDA
    route records the rounds run, each round's frontier and its host
    reads."""
    _check_lanes(prev_link)
    if prev_link.is_cuda:
        return _label_stage_cuda(prev_link, info)
    return label_stage_plain(prev_link)


def cycle_fix_plain(prev_link: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K13 cycle cut (ops/condense.py:264 _cycle_fix)."""
    C2 = prev_link.shape[0]
    iota = torch.arange(C2, device=prev_link.device)
    ptr = torch.where(prev_link >= 0, prev_link, iota)
    mn = iota
    for _ in range(max(C2.bit_length(), 1)):
        mn = torch.minimum(mn, mn[ptr])
        ptr = ptr[ptr]
    cycle_head = (prev_link[ptr] >= 0) & (mn == iota)
    return torch.where(cycle_head, -1, prev_link)


def _cycle_fix_cuda(prev_link: torch.Tensor, head_ptr: torch.Tensor | None,
                    info: dict | None) -> torch.Tensor:
    kernels.check_cuda("prev_link", prev_link, torch.int64, 1)
    C2 = prev_link.shape[0]
    dev = prev_link.device
    if head_ptr is None:
        head_ptr = _label_launch(prev_link)[0]
    kernels.check_cuda("head_ptr", head_ptr, torch.int64, 1)
    R = max(C2.bit_length(), 1)
    out = torch.empty(C2, dtype=torch.int64, device=dev)
    ctl = torch.empty(R + 1, dtype=torch.int32, device=dev)
    lib = kernels.library()
    # packed words and the cycle lanes' bitmap, laid out by the kernel's source
    words = lib.scratch_words("shannon_cycle_rounds", C2)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    lib.call(
        "shannon_cycle_rounds", dev,
        kernels.ptr(prev_link), kernels.ptr(head_ptr), C2, kernels.ptr(scratch), words,
        kernels.ptr(ctl), ctl.shape[0], kernels.ptr(out),
    )
    lib.count("cycle_round")
    if info is not None:  # read only for info: the call itself reads nothing back
        ctl = ctl.tolist() if C2 else [0] * (R + 1)
        changed = ctl[1:]
        run = next((t for t, n in enumerate(changed, 1) if n == 0), R) if C2 else 0
        info.update(rounds_run=run, frontier=ctl[0], changed=changed[:run], host_reads=0)
    return out


def cycle_fix(prev_link: torch.Tensor, head_ptr: torch.Tensor | None = None,
              info: dict | None = None) -> torch.Tensor:
    """Cut isolated cycles at their minimum lane (ops/condense.py:264
    _cycle_fix): min-propagating pointer doubling.  `head_ptr`, the label
    stage's pointers on prev_link, names the lanes whose walk reaches a
    cycle, the only lanes that can be cut; without it the CUDA route runs
    the label stage's rounds itself.  Kernel K13 (``cycle_round``: every
    round enqueued at once over those lanes, stopping after the first round
    that changes no minimum, at most log2(C2) rounds; the last launch writes
    the cut links; no host read) on CUDA, the plain version (the
    reference's full loop, which needs no head_ptr) on CPU.  With `info`,
    the CUDA route records the rounds run, the cycle lanes (frontier), the
    lanes whose minimum changed in each round and its host reads (0; the
    counts are read for info alone).  Refuses tables of 2^31 lanes or
    more."""
    _check_lanes(prev_link)
    if head_ptr is not None and head_ptr.shape != prev_link.shape:
        raise ValueError(f"head_ptr {tuple(head_ptr.shape)} and prev_link "
                         f"{tuple(prev_link.shape)} disagree")
    if prev_link.is_cuda:
        return _cycle_fix_cuda(prev_link, head_ptr, info)
    return cycle_fix_plain(prev_link)


# ---- K14: per-contig reduction -----------------------------------------------


def reduce_stage_plain(
    node_key, node_count, n_nodes, prev2, head_ptr, dist,
    rec_lane, first_p, p_cnt, k: int, canonical: bool,
) -> ContigArrays:
    """Plain PyTorch K14 (ops/condense.py:287 _reduce_stage).  Offsets
    within a contig are 0..klen-1, so the reductions are scatters keyed by
    contig id."""
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
        rc_idx, rc_hit = lookup_sorted_plain(node_key, revcomp_key(node_key[tl], k))
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


def _reduce_stage_cuda(
    node_key, node_count, n_nodes, prev2, head_ptr, dist,
    rec_lane, first_p, p_cnt, k: int, canonical: bool,
) -> ContigArrays:
    C2 = node_key.shape[0]
    for name, t, dtype in (
        ("node_key", node_key, torch.int64), ("node_count", node_count, torch.int32),
        ("prev2", prev2, torch.int64), ("head_ptr", head_ptr, torch.int64),
        ("dist", dist, torch.int64), ("rec_lane", rec_lane, torch.int64),
        ("first_p", first_p, torch.int64), ("p_cnt", p_cnt, torch.int64),
    ):
        kernels.check_cuda(name, t, dtype, 1)
        if t.shape[0] != (2 * C2 if name == "rec_lane" else C2):
            raise ValueError(f"{name} has {t.shape[0]} lanes for a {C2}-lane node table")
    if C2 >= 1 << 31:
        raise ValueError(f"{C2} node lanes exceed the int32 contig ids")
    dev = node_key.device

    def lanes(dtype=torch.int64):
        return torch.empty(C2, dtype=dtype, device=dev)

    ids = lanes(torch.int32)
    scratch = kernels.scan_scratch(C2, dev)
    node_cid, node_off, klen, csum = lanes(), lanes(), lanes(), lanes()
    head_lane, tail_lane, rc_pair = lanes(), lanes(), lanes()
    abundance = lanes(torch.float32)
    out_edges = torch.empty((4, C2), dtype=torch.int64, device=dev)
    lib = kernels.library()
    lib.call(
        "shannon_contig_reduce", dev,
        *(kernels.ptr(t) for t in (node_key, node_count, prev2, head_ptr, dist, rec_lane,
                                    first_p, p_cnt)),
        C2, k, int(canonical), kernels.ptr(scratch), scratch.shape[0], kernels.ptr(ids),
        *(kernels.ptr(t) for t in (node_cid, node_off, klen, csum, head_lane, tail_lane,
                                    abundance, out_edges, rc_pair)),
    )
    lib.count("contig_reduce")
    return ContigArrays(
        node_key=node_key,
        node_count=node_count,
        node_cid=node_cid,
        node_off=node_off,
        klen=klen,
        abundance=abundance,
        count_sum=csum,
        head_lane=head_lane,
        tail_lane=tail_lane,
        out_edges=out_edges,
        rc_pair=rc_pair,
        n_nodes=n_nodes,
        n_contigs=kernels.scan_total(scratch),  # the one host read
    )


def reduce_stage(
    node_key, node_count, n_nodes, prev2, head_ptr, dist,
    rec_lane, first_p, p_cnt, k: int, canonical: bool,
) -> ContigArrays:
    """Per-contig reductions, edges and rc twins from the labeled nodes
    (ops/condense.py:287 _reduce_stage).  Kernel K14 on CUDA (contig ids
    from one look-back scan of the head lanes, one host read), the plain
    version on CPU."""
    args = (node_key, node_count, n_nodes, prev2, head_ptr, dist,
            rec_lane, first_p, p_cnt, k, canonical)
    if node_key.is_cuda:
        return _reduce_stage_cuda(*args)
    return reduce_stage_plain(*args)


def build_contig_arrays(spec: Spectrum, k: int, canonical: bool = True) -> ContigArrays:
    """Condense a (corrected) spectrum into its contig graph
    (ops/condense.py:202 build_contig_arrays).  On CUDA every stage runs its
    kernels (K11-K14)."""
    node_key, node_count, n_nodes = nodes_stage(spec, k, canonical)
    prev_link, rec_lane, first_p, p_cnt = links_stage(node_key, k)
    ptr, dist, has_cycle = label_stage(prev_link)
    if has_cycle:
        prev_link = cycle_fix(prev_link, ptr)
        ptr, dist, _ = label_stage(prev_link)
    return reduce_stage(
        node_key, node_count, n_nodes, prev_link, ptr, dist,
        rec_lane, first_p, p_cnt, k, canonical,
    )


# ---- K15: base streams ----------------------------------------------------------


def contig_base_streams_plain(ca: ContigArrays, k: int):
    """Plain PyTorch K15 (ops/condense.py:417 contig_base_streams)."""
    C2 = ca.node_key.shape[0]
    lanes = torch.nonzero(ca.node_cid >= 0).flatten()
    order = torch.argsort(ca.node_cid[lanes] * C2 + ca.node_off[lanes])
    tails = (ca.node_key[lanes[order]] & 3).to(torch.uint8)
    head = ca.node_key[ca.head_lane[: ca.n_contigs].clamp(0, C2 - 1)]
    shifts = 2 * (k - 1 - torch.arange(k - 1, device=head.device))
    heads = ((head[:, None] >> shifts[None, :]) & 3).to(torch.uint8)
    return tails, heads


def _contig_base_streams_cuda(ca: ContigArrays, k: int):
    for name in ("node_key", "node_cid", "node_off", "klen", "head_lane"):
        kernels.check_cuda(name, getattr(ca, name), torch.int64, 1)
    C2 = ca.node_key.shape[0]
    n = ca.n_contigs
    if ca.node_cid.shape[0] != C2 or ca.node_off.shape[0] != C2:
        raise ValueError("node_key, node_cid and node_off disagree on length")
    if ca.klen.shape[0] < n or ca.head_lane.shape[0] < n:
        raise ValueError(f"klen and head_lane must cover the {n} contigs")
    if C2 >= 1 << 31:
        raise ValueError(f"{C2} node lanes exceed the int32 contig lengths")
    dev = ca.node_key.device
    # every real lane, [0, min(n_nodes, C2)), has a contig id, so that is
    # sum(klen[:n]): the tails' length, with no scan and no host read
    n_tails = min(ca.n_nodes, C2) if n else 0
    lib = kernels.library()
    scratch = torch.zeros(lib.scratch_words("shannon_base_streams", n), dtype=torch.int64,
                          device=dev)
    tstart = torch.empty(n, dtype=torch.int64, device=dev)
    tails = torch.empty(n_tails, dtype=torch.uint8, device=dev)
    heads = torch.empty((n, k - 1), dtype=torch.uint8, device=dev)
    lib.call(
        "shannon_base_streams", dev,
        kernels.ptr(ca.node_key), kernels.ptr(ca.node_cid), kernels.ptr(ca.node_off), C2,
        n_tails, kernels.ptr(ca.klen), kernels.ptr(ca.head_lane), n, k, kernels.ptr(scratch),
        scratch.shape[0], kernels.ptr(tstart), kernels.ptr(tails), kernels.ptr(heads),
    )
    lib.count("base_streams")
    return tails, heads


def contig_base_streams(ca: ContigArrays, k: int):
    """(tails, heads): every node's last base in (cid, offset) order
    [sum klen] uint8, and each contig's k-1 leading bases [n_contigs, k-1]
    uint8 (ops/condense.py:417 contig_base_streams).  Kernel K15 on CUDA
    (each contig's tail start from one look-back scan of klen[:n_contigs],
    the heads in the same pass, then a pass over the real lanes; no host
    read), the plain version on CPU."""
    if ca.node_key.is_cuda:
        return _contig_base_streams_cuda(ca, k)
    return contig_base_streams_plain(ca, k)


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
    from shannon_tpu_torch.oracle.graph import Contig, ContigGraph
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
