"""Port parity: tip clipping (condensation, host clip rounds, drop of
doomed k-mers, renumbering of the node table) against
shannon_tpu.ops.tipclip.clip_tips_graph and its spectrum-only view
clip_tips_spectrum on JAX-CPU, from the same corrected spectrum; and the
drop and the renumbering alone (the plain versions of K18 and K19)
against _drop_contigs and _device_clip_remap on the same inputs; and numpy
transcriptions of K18's merge join and K19's look-back pass with its rank
structure (csrc/tipclip.cu) against the plain versions, on the clip's own
inputs and on edge tables, and through them against the reference.

Tolerance: exact — clipped spectrum and post-clip ContigArrays equal over
their full capacity."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.correction import correct_spectrum
from shannon_tpu.ops.count import count_spectrum_packed
from shannon_tpu.ops import condense as jcd
from shannon_tpu.ops import tipclip as jtc
from shannon_tpu.ops.tipclip import clip_tips_graph as ref_clip
from shannon_tpu.sim import random_seq, sample_reads, simulate_gene_isoforms, simulate_transcripts
from shannon_tpu_torch import convert, kernels
from shannon_tpu_torch.ops import tipclip as ttc
from shannon_tpu_torch.ops.condense import build_contig_arrays
from shannon_tpu_torch.ops.tipclip import clip_tips_graph

from test_torch_condense import assert_contig_arrays_equal
from test_torch_kernels import (DROP_CASES, REMAP_SIZES, check_drop_count, drop_case,
                                remap_args_of_clip, remap_case)


def _corrected(cfg: AssemblyConfig, seed: int, error_rate: float, genes: bool = False):
    rng = np.random.default_rng(seed)
    if genes:
        ts, _ = simulate_gene_isoforms(rng, n_genes=3)
    else:
        ts = simulate_transcripts(rng, n=4, length=300)
        ts.append(ts[0][:150] + random_seq(rng, 200))  # a shared prefix branch
    reads = sample_reads(
        rng, ts, abundances=list(rng.uniform(1, 5, len(ts))), coverage=20,
        read_length=70, error_rate=error_rate,
    )
    b = pack_reads(reads, pad_length=96)
    canonical = not cfg.strand_specific
    spec = count_spectrum_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), cfg.k, 1 << 15, canonical,
        b.pad_length,
    )
    ref = correct_spectrum(
        spec, cfg.k, 1, cfg.sibling_ratio, cfg.correction_rounds, canonical,
        error_rate=cfg.error_rate,
    )
    port = convert.spectrum_from_numpy(
        np.asarray(ref.hi), np.asarray(ref.lo), np.asarray(ref.count), int(ref.n)
    )
    return port, ref


def _assert_clip_same(cfg, port, ref):
    canonical = not cfg.strand_specific
    p_spec, p_ca = clip_tips_graph(port, cfg, canonical)
    r_spec, r_ca = ref_clip(ref, cfg, canonical)
    hi, lo, count, n = convert.spectrum_to_numpy(p_spec)
    assert n == int(r_spec.n)
    np.testing.assert_array_equal(hi, np.asarray(r_spec.hi))
    np.testing.assert_array_equal(lo, np.asarray(r_spec.lo))
    np.testing.assert_array_equal(count, np.asarray(r_spec.count))
    assert (p_ca is None) == (r_ca is None)
    if p_ca is not None:
        assert_contig_arrays_equal(p_ca, r_ca)
    return p_spec, p_ca


@pytest.mark.parametrize("error_rate", [0.0, 0.01, 0.03])
@pytest.mark.parametrize("k", [15, 24])
def test_clip_tips_graph_matches_reference(error_rate, k):
    cfg = AssemblyConfig(k=k)
    port, ref = _corrected(cfg, seed=k + int(error_rate * 100), error_rate=error_rate)
    p_spec, _ = _assert_clip_same(cfg, port, ref)
    if error_rate >= 0.01:
        assert p_spec.n < port.n  # something was clipped


def test_clip_tips_graph_gene_isoforms_matches_reference():
    cfg = AssemblyConfig(k=21)
    port, ref = _corrected(cfg, seed=9, error_rate=0.02, genes=True)
    _assert_clip_same(cfg, port, ref)


def test_clip_tips_graph_strand_specific_matches_reference():
    cfg = AssemblyConfig(k=21, strand_specific=True)
    port, ref = _corrected(cfg, seed=11, error_rate=0.02)
    _assert_clip_same(cfg, port, ref)


@pytest.mark.parametrize("strand_specific", [False, True])
def test_clip_tips_spectrum_matches_reference(strand_specific):
    """The spectrum-only view == jtc.clip_tips_spectrum, notes included."""
    cfg = AssemblyConfig(k=21, strand_specific=strand_specific)
    port, ref = _corrected(cfg, seed=13, error_rate=0.02)
    canonical = not strand_specific
    notes: dict = {}
    got = ttc.clip_tips_spectrum(port, cfg, canonical, notes)
    want = jtc.clip_tips_spectrum(ref, cfg, canonical)
    hi, lo, count, n = convert.spectrum_to_numpy(got)
    assert n == int(want.n) < port.n
    np.testing.assert_array_equal(hi, np.asarray(want.hi))
    np.testing.assert_array_equal(lo, np.asarray(want.lo))
    np.testing.assert_array_equal(count, np.asarray(want.count))
    assert notes["tc_contigs"] > 0


# ---- stage by stage: the drop (K18) and the remap (K19) --------------------


def _clip_stage(cfg: AssemblyConfig, seed: int, error_rate: float):
    """One clip's device-stage inputs in both packages: the corrected
    spectra, the port's contig arrays and the reference's (through convert),
    the host clip state (the port's copy of the host rounds), its doom
    flags over node lanes, and the arguments _remap_clipped hands to
    _device_clip_remap."""
    port, ref = _corrected(cfg, seed=seed, error_rate=error_rate)
    canonical = not cfg.strand_specific
    ca = build_contig_arrays(port, cfg.k, canonical)
    jca = jcd.ContigArrays(*(jnp.asarray(x) for x in convert.contig_arrays_to_numpy(ca)))
    n = ca.n_contigs
    klen = ca.klen[:n].numpy()
    st = ttc._host_clip_rounds(
        klen, ca.count_sum[:n].numpy(), ttc._adjacency_lists(ca.out_edges[:, :n].numpy(), n), cfg
    )
    assert st.doomed.any() and not st.cycle_merged
    doomed = torch.zeros(ca.node_key.shape[0], dtype=torch.bool)
    doomed[:n] = torch.from_numpy(st.doomed)
    dropped = ttc._drop_contigs(port, ca, doomed)
    return port, ref, ca, jca, doomed, remap_args_of_clip(ca, st, klen, dropped.n)


CLIP_POINTS = [(15, 0.01), (24, 0.03)]


@pytest.mark.parametrize("k,error_rate", CLIP_POINTS)
def test_drop_contigs_matches_reference(k, error_rate):
    """K18's plain version == _drop_contigs, from one clip's doom flags."""
    port, ref, ca, jca, doomed, _ = _clip_stage(AssemblyConfig(k=k), k, error_rate)
    got = ttc._drop_contigs(port, ca, doomed)
    want = jtc._drop_contigs(ref, jca, jnp.asarray(doomed.numpy()))
    hi, lo, count, n = convert.spectrum_to_numpy(got)
    assert n == int(want.n) < port.n
    np.testing.assert_array_equal(hi, np.asarray(want.hi))
    np.testing.assert_array_equal(lo, np.asarray(want.lo))
    np.testing.assert_array_equal(count, np.asarray(want.count))


@pytest.mark.parametrize("k,error_rate", CLIP_POINTS)
@pytest.mark.parametrize("cap", ["full", "below_kept"])
def test_device_clip_remap_matches_reference(k, error_rate, cap):
    """K19's plain version == _device_clip_remap on the arguments one clip
    gives it (cast to int32 for the reference), at the clip's out_cap and
    at an out_cap below the kept nodes, where n_nodes still counts them
    all."""
    *_, args = _clip_stage(AssemblyConfig(k=k), k, error_rate)
    ca, *maps, n_new, out_cap = args
    n_keep = ttc._device_clip_remap(*args).n_nodes
    if cap == "below_kept":
        out_cap = n_keep // 2
    got = ttc._device_clip_remap(ca, *maps, n_new, out_cap)
    jca = jcd.ContigArrays(*(jnp.asarray(x) for x in convert.contig_arrays_to_numpy(ca)))
    want = jtc._device_clip_remap(
        jca, *(jnp.asarray(m.numpy().astype(np.int32)) for m in maps), jnp.int32(n_new),
        out_cap=out_cap,
    )
    assert got.n_nodes == n_keep == int(want.n_nodes)
    assert (out_cap < n_keep) == (cap == "below_kept")
    assert_contig_arrays_equal(got, want)


def test_clip_stages_run_plain_on_cpu(monkeypatch):
    """On CPU tensors the drop and the remap are their plain versions and
    reach no kernel."""
    port, _, ca, _, doomed, args = _clip_stage(AssemblyConfig(k=15), 15, 0.01)

    def no_library():
        raise AssertionError("a CPU clip stage reached the kernel library")

    monkeypatch.setattr(kernels, "library", no_library)
    got, want = ttc._drop_contigs(port, ca, doomed), ttc._drop_contigs_plain(port, ca, doomed)
    assert got.n == want.n and torch.equal(got.key, want.key)
    got, want = ttc._device_clip_remap(*args), ttc._device_clip_remap_plain(*args)
    for f in ("node_key", "node_count", "node_cid", "node_off", "abundance", "head_lane",
              "tail_lane"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.n_nodes == want.n_nodes


def test_clip_disabled_returns_input():
    cfg = AssemblyConfig(k=21, tip_klen=-1)
    port, _ = _corrected(cfg, seed=12, error_rate=0.01)
    spec, ca = clip_tips_graph(port, cfg)
    assert spec is port and ca is None


# ---- the designs of K18 and K19, transcribed --------------------------------

PAD = np.int64((1 << 63) - 1)
# (lanes a tile, lanes a thread): the kernels' SCAN_TILE and SCAN_ITEMS, and
# a small tile that puts many tile and thread edges into a small table
DROP_TILES = [(4096, 16), (64, 4)]
# K19's rank words are 32-lane ballots, so only the tile varies
REMAP_TILES = [4096, 64]


def _partition(lo: int, hi: int, pred) -> int:
    """The first index in [lo, hi) where pred is false, pred true on a
    prefix: what warp_partition returns (common.cuh)."""
    while lo < hi:
        mid = (lo + hi) // 2
        if pred(mid):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge_split(a, na: int, b, nb: int, d: int) -> int:
    """a's lanes among the first d merged lanes, ties to a (merge_split)."""
    return _partition(max(d - nb, 0), min(d, na), lambda i: a[i] <= b[d - 1 - i])


def drop_join_transcription(key, count, node_key, node_cid, doomed, tile: int, items: int):
    """numpy transcription of drop_join_kernel and its tail fill
    (csrc/tipclip.cu): (out_key, out_count, n).  Tiles of `tile` merged
    lanes in ticket order, threads of `items` lanes in thread order (the
    block scan lays their kept lanes end to end)."""
    C, C2 = key.shape[0], node_key.shape[0]
    na = _partition(0, C, lambda i: key[i] != PAD)
    nb = _partition(0, C2, lambda i: node_key[i] != PAD)
    N = na + nb
    out_key = np.full(C, -7, np.int64)  # every lane must be written
    out_count = np.full(C, -7, np.int32)
    prefix = 0
    for d0 in range(0, N, tile):
        d1 = min(d0 + tile, N)
        a0, a1 = _merge_split(key, na, node_key, nb, d0), _merge_split(key, na, node_key, nb, d1)
        b0, b1 = d0 - a0, d1 - a1
        la, L = a1 - a0, d1 - d0
        lb = L - la
        assert la <= tile and lb <= tile
        s = np.concatenate([key[a0:a1], node_key[b0:b1]])
        edge = node_key[b1] if b1 < nb else PAD
        lanes = []
        for first in range(0, min(tile, L), items):
            ai = _partition(max(first - lb, 0), min(first, la),
                            lambda m: s[m] <= s[la + first - 1 - m])
            bi = first - ai
            ka = s[ai] if ai < la else PAD
            kb = s[la + bi] if bi < lb else edge
            for _j in range(min(items, L - first)):
                if ka <= kb:
                    cid = node_cid[b0 + bi] if ka == kb else -1
                    if cid < 0 or not doomed[min(cid, C2 - 1)]:
                        lanes.append(ai)
                    ai += 1
                    ka = s[ai] if ai < la else PAD
                else:
                    bi += 1
                    kb = s[la + bi] if bi < lb else edge
        for q, t in enumerate(lanes):
            out_key[prefix + q] = s[t]
            out_count[prefix + q] = count[a0 + t]
        prefix += len(lanes)
    out_key[prefix:] = PAD
    out_count[prefix:] = 0
    return out_key, out_count, prefix


def _drop_transcribed(spec, ca, doomed, tile, items):
    return drop_join_transcription(
        spec.key.numpy(), spec.count.numpy(), ca.node_key.numpy(), ca.node_cid.numpy(),
        doomed.numpy(), tile, items)


@pytest.mark.parametrize("tile,items", DROP_TILES)
@pytest.mark.parametrize("case", DROP_CASES)
def test_drop_join_transcription_matches_plain(case, tile, items):
    """K18's merge join, transcribed, == _drop_contigs_plain: the merge-path
    split of tiles and threads, the join (ties to the spectrum, the node
    head past the tile), the doom test with its clamp and the compaction."""
    spec, ca, doomed = drop_case(case)
    key, count, n = _drop_transcribed(spec, ca, doomed, tile, items)
    want = ttc._drop_contigs_plain(spec, ca, doomed)
    assert n == want.n
    np.testing.assert_array_equal(key, want.key.numpy())
    np.testing.assert_array_equal(count, want.count.numpy())
    check_drop_count(case, spec, want)
    if case == "absent":  # every absent key is kept
        real = spec.key[: spec.n].numpy()
        absent = real[~np.isin(real, ca.node_key.numpy())]
        assert absent.size and np.isin(absent, key).all()


@pytest.mark.parametrize("tile,items", DROP_TILES)
@pytest.mark.parametrize("k,error_rate", CLIP_POINTS)
def test_drop_join_transcription_matches_reference(k, error_rate, tile, items):
    """K18's merge join, transcribed, == the reference's _drop_contigs on one
    clip's doom flags."""
    port, ref, ca, jca, doomed, _ = _clip_stage(AssemblyConfig(k=k), k, error_rate)
    key, count, n = _drop_transcribed(port, ca, doomed, tile, items)
    want = jtc._drop_contigs(ref, jca, jnp.asarray(doomed.numpy()))
    got = convert.spectrum_to_numpy(
        ttc.Spectrum(key=torch.from_numpy(key), count=torch.from_numpy(count), n=n))
    assert n == int(want.n) < port.n
    for g, w in zip(got[:3], (want.hi, want.lo, want.count)):
        np.testing.assert_array_equal(g, np.asarray(w))


def remap_transcription(args, tile: int) -> ttc.ContigArrays:
    """numpy transcription of remap_nodes_kernel and remap_tail_kernel
    (csrc/tipclip.cu) on _device_clip_remap's arguments: the look-back pass
    with its rank structure (a word of keep bits a 32-lane ballot, the
    tile's kept lanes before each word from the block scan of the words'
    counts, each tile's inclusive value), each kept lane placed at its word's
    count plus the kept lanes below it in the word, then the tail fill and
    the new contigs' head and tail lanes read from the rank structure."""
    ca, new_cid, off_shift, hlane, tlane, klen, csum, rc, out_e, n_new, out_cap = args
    node_key, node_count, node_cid, node_off = (
        getattr(ca, f).numpy() for f in ("node_key", "node_count", "node_cid", "node_off"))
    new_cid, off_shift, hlane, tlane, klen, csum = (
        x.numpy() for x in (new_cid, off_shift, hlane, tlane, klen, csum))
    C2, npad = node_key.shape[0], new_cid.shape[0]
    tiles, words = -(-C2 // tile), tile // 32
    cid = np.full(tiles * tile, -1, np.int64)
    cid[:C2] = node_cid
    keep = (cid >= 0) & (new_cid[np.clip(cid, 0, npad - 1)] >= 0)
    out = {"node_key": np.full(out_cap, -7, np.int64), "node_count": np.full(out_cap, -7, np.int32),
           "node_cid": np.full(out_cap, -7, np.int64), "node_off": np.full(out_cap, -7, np.int64)}
    bits = np.zeros(tiles * words, np.uint64)
    word_count = np.zeros(tiles * words, np.int64)
    incl, prefix = [], 0
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    for t in range(tiles):
        flags = keep[t * tile:(t + 1) * tile].reshape(words, 32)  # a ballot a word
        per = flags.sum(1)
        r = np.cumsum(per) - per  # each word's exclusive count in the tile
        ballots = (flags * weights).sum(1).astype(np.uint64)
        bits[t * words:(t + 1) * words] = ballots
        word_count[t * words:(t + 1) * words] = r
        s_lane = np.full(int(per.sum()), -1)
        for w, j in zip(*np.nonzero(flags)):
            below = bin(int(ballots[w]) & ((1 << int(j)) - 1)).count("1")
            s_lane[r[w] + below] = 32 * w + j
        assert (s_lane >= 0).all()
        for q, lane in enumerate(t * tile + s_lane):
            slot = prefix + q
            if slot >= out_cap:
                break
            oc = min(max(cid[lane], 0), npad - 1)
            out["node_key"][slot] = node_key[lane]
            out["node_count"][slot] = node_count[lane]
            out["node_cid"][slot] = new_cid[oc]
            out["node_off"][slot] = node_off[lane] + off_shift[oc]
        prefix += int(per.sum())
        incl.append(prefix)
    n_keep = prefix
    for f, fill in (("node_key", PAD), ("node_count", 0), ("node_cid", -1), ("node_off", -1)):
        out[f][n_keep:] = fill

    def new_lane(h: int) -> int:
        h = min(max(h, 0), C2 - 1)
        t, w, b = h // tile, h >> 5, h & 31
        before = incl[t - 1] if t > 0 else 0
        return before + int(word_count[w]) + bin(int(bits[w]) & ((2 << b) - 1)).count("1") - 1

    head = np.array([new_lane(h) if h >= 0 else -1 for h in hlane], np.int64)
    tail = np.array([new_lane(h) if h >= 0 else -1 for h in tlane], np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ab = np.where(klen > 0, csum.astype(np.float32) / klen.astype(np.float32), np.float32(0))
    t = torch.from_numpy
    return ttc.ContigArrays(
        node_key=t(out["node_key"]), node_count=t(out["node_count"]),
        node_cid=t(out["node_cid"]), node_off=t(out["node_off"]), klen=args[5],
        abundance=t(ab.astype(np.float32)), count_sum=args[6], head_lane=t(head),
        tail_lane=t(tail), out_edges=out_e, rc_pair=rc, n_nodes=n_keep, n_contigs=n_new,
    )


def _assert_remap_equal(got: ttc.ContigArrays, want: ttc.ContigArrays) -> None:
    for f in ("node_key", "node_count", "node_cid", "node_off", "klen", "count_sum",
              "head_lane", "tail_lane", "out_edges", "rc_pair"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and torch.equal(g, w), f
    assert torch.equal(got.abundance.view(torch.int32), want.abundance.view(torch.int32))
    assert (got.n_nodes, got.n_contigs) == (want.n_nodes, want.n_contigs)


@pytest.mark.parametrize("tile", REMAP_TILES)
@pytest.mark.parametrize("cap", ["given", "below_kept", "above_table"])
@pytest.mark.parametrize("C2", REMAP_SIZES)
def test_remap_transcription_matches_plain(C2, cap, tile):
    """K19's look-back pass and rank structure, transcribed, ==
    _device_clip_remap_plain on edge tables: new_lane from the rank
    structure == the plain cumsum - 1 at h = -1, at dropped lanes, past
    out_cap, at C2 - 1 and past C2, with C2 at and beside the word and tile
    edges and out_cap below the kept nodes and above the table."""
    args = remap_case(C2, cap)
    want = ttc._device_clip_remap_plain(*args)
    _assert_remap_equal(remap_transcription(args, tile), want)
    hl = args[3]
    assert (hl == -1).any() and (hl >= C2).any() and (hl == C2 - 1).any()
    if cap == "below_kept":
        assert want.n_nodes > args[-1]


@pytest.mark.parametrize("tile", REMAP_TILES)
@pytest.mark.parametrize("cap", ["full", "below_kept"])
@pytest.mark.parametrize("k,error_rate", CLIP_POINTS)
def test_remap_transcription_matches_reference(k, error_rate, cap, tile):
    """K19's design, transcribed, == _device_clip_remap_plain and the
    reference's _device_clip_remap on the arguments one clip gives it, at
    its out_cap and below the kept nodes."""
    *_, args = _clip_stage(AssemblyConfig(k=k), k, error_rate)
    ca, *maps, n_new, out_cap = args
    if cap == "below_kept":
        out_cap = ttc._device_clip_remap_plain(*args).n_nodes // 2
    args = (ca, *maps, n_new, out_cap)
    got = remap_transcription(args, tile)
    _assert_remap_equal(got, ttc._device_clip_remap_plain(*args))
    jca = jcd.ContigArrays(*(jnp.asarray(x) for x in convert.contig_arrays_to_numpy(ca)))
    want = jtc._device_clip_remap(
        jca, *(jnp.asarray(m.numpy().astype(np.int32)) for m in maps), jnp.int32(n_new),
        out_cap=out_cap,
    )
    assert_contig_arrays_equal(got, want)
