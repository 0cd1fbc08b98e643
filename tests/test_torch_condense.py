"""Port parity: condensation (node table, group-join links, pointer-doubling
labels with cycle cuts, per-contig reduction, base streams and the host
ContigGraph) against shannon_tpu.ops.condense on JAX-CPU.  Both packages
condense the same spectrum (via convert); the stage tests feed each plain
stage of the port the JAX package's output of the stage before it.

Tolerance: exact — every ContigArrays array equal over its full capacity
(abundances bitwise), contig sequences and graphs equal."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.dna import revcomp_str
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops import condense as jcd
from shannon_tpu.ops.count import count_spectrum_packed, spectrum_from_arrays
from shannon_tpu.sim import random_seq, sample_reads, simulate_isoforms, simulate_transcripts
from shannon_tpu_torch import convert
from shannon_tpu_torch.ops import condense as tcd
from test_torch_kernels import (
    REDUCE_TABLES, STAGE_SPECTRUM_LANES, STAGE_TABLE_LANES, STAGE_TABLES, label_links,
    reduce_tables, stage_tables,
)

CASES = {
    "multi": lambda rng: simulate_transcripts(rng, n=3, length=250),
    "isoforms": lambda rng: simulate_isoforms(rng, exon_length=120),
    "repeat": lambda rng: (
        lambda a, b, c, d, r: [a + r + b, c + r + d]
    )(*simulate_transcripts(rng, n=4, length=150), random_seq(rng, 60)),
    "cycle": lambda rng: [random_seq(rng, 50) * 4],  # tandem repeat -> cycle
    "homopolymer": lambda rng: ["A" * 120],  # self-loop k-mer
    # a k-mer across the junction of h and revcomp(h) is its own reverse
    # complement when k is even
    "palindrome": lambda rng: (
        lambda a, h, b: [a + h + revcomp_str(h) + b]
    )(random_seq(rng, 80), random_seq(rng, 40), random_seq(rng, 80)),
    # disjoint isolated cycles of three lengths beside two chains
    "cycles": lambda rng: [random_seq(rng, n) * 4 for n in (37, 52, 71)]
    + simulate_transcripts(rng, n=2, length=200),
    "empty": lambda rng: [],
}


def _spectra(case: str, k: int, canonical: bool = True, error_rate: float = 0.0):
    rng = np.random.default_rng(len(case) * 31 + k)
    ts = CASES[case](rng)
    if not ts:
        ref = spectrum_from_arrays(np.zeros(0, np.uint64), np.zeros(0, np.int32), 1 << 13)
        return convert.spectrum_from_numpy(ref.hi, ref.lo, ref.count, 0), ref
    reads = sample_reads(rng, ts, coverage=12, read_length=60, error_rate=error_rate)
    b = pack_reads(reads, pad_length=64)
    ref = count_spectrum_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), k, 1 << 13, canonical, b.pad_length
    )
    port = convert.spectrum_from_numpy(
        np.asarray(ref.hi), np.asarray(ref.lo), np.asarray(ref.count), int(ref.n)
    )
    return port, ref


def assert_contig_arrays_equal(port: tcd.ContigArrays, ref) -> None:
    names = (
        "node_hi node_lo node_count node_cid node_off klen abundance count_sum "
        "head_lane tail_lane out_edges rc_pair n_nodes n_contigs"
    ).split()
    got = convert.contig_arrays_to_numpy(port)
    want = ref.tree_flatten()[0]
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("k", [15, 24])
def test_build_contig_arrays_matches_reference(case, k):
    port, ref = _spectra(case, k)
    ca = tcd.build_contig_arrays(port, k)
    assert_contig_arrays_equal(ca, jcd.build_contig_arrays(ref, k))


@pytest.mark.parametrize("k", [5, 31])
def test_build_contig_arrays_with_errors_matches_reference(k):
    port, ref = _spectra("isoforms", k, error_rate=0.02)
    assert_contig_arrays_equal(tcd.build_contig_arrays(port, k), jcd.build_contig_arrays(ref, k))


def test_strand_specific_matches_reference():
    port, ref = _spectra("repeat", 21, canonical=False)
    ca = tcd.build_contig_arrays(port, 21, canonical=False)
    assert_contig_arrays_equal(ca, jcd.build_contig_arrays(ref, 21, canonical=False))


@pytest.mark.parametrize("case", ["isoforms", "cycle"])
def test_contig_graph_matches_reference(case):
    k = 19
    port, ref = _spectra(case, k, error_rate=0.01)
    cfg = AssemblyConfig(k=k)
    ca = tcd.build_contig_arrays(port, k)
    g = tcd.to_contig_graph(ca, k, cfg)
    r = jcd.to_contig_graph(jcd.build_contig_arrays(ref, k), k, cfg)
    assert [c.seq for c in g.contigs] == [c.seq for c in r.contigs]
    assert [c.abundance for c in g.contigs] == [c.abundance for c in r.contigs]
    assert g.out_edges == r.out_edges and g.in_edges == r.in_edges
    assert g.rc_pair == r.rc_pair and g._klen == r._klen
    tails, heads = tcd.contig_base_streams(ca, k)
    r_tails, r_heads = jcd.contig_base_streams(jcd.build_contig_arrays(ref, k), k)
    np.testing.assert_array_equal(tails.numpy(), np.asarray(r_tails)[: tails.shape[0]])
    np.testing.assert_array_equal(heads.numpy(), np.asarray(r_heads)[: ca.n_contigs])


def test_contig_arrays_convert_round_trip():
    port, ref = _spectra("isoforms", 17)
    r = jcd.build_contig_arrays(ref, 17)
    back = convert.contig_arrays_from_numpy(*(np.asarray(x) for x in r.tree_flatten()[0]))
    assert_contig_arrays_equal(back, r)
    ca = tcd.build_contig_arrays(port, 17)
    for f in ("node_key", "node_cid", "node_off", "klen", "abundance", "out_edges", "rc_pair"):
        assert torch.equal(getattr(back, f), getattr(ca, f)), f


# ---- stage by stage ---------------------------------------------------------

STAGE_POINTS = [(c, k, True) for c in sorted(CASES) for k in (15, 24)] + [
    (c, 21, False) for c in ("cycles", "palindrome", "repeat")
]


@functools.lru_cache(maxsize=None)
def _reference_stages(case: str, k: int, canonical: bool) -> dict:
    """Every stage output of the JAX package on one spectrum, as numpy (the
    lanes, pointers and ids int64, node keys int64 with PAD)."""
    port, ref = _spectra(case, k, canonical)
    node_hi, node_lo, node_count, n_nodes = jcd._nodes_stage(ref, k, canonical)
    _next, prev_link, rec_lane, first_p, p_cnt = jcd._links_stage(node_hi, node_lo, k)
    ptr, dist, has_cycle = jcd._label_stage(prev_link)
    cut = jcd._cycle_fix(prev_link)
    prev2, ptr2, dist2 = prev_link, ptr, dist
    if bool(has_cycle):
        prev2 = cut
        ptr2, dist2, _ = jcd._label_stage(cut)
    ca = jcd._reduce_stage(
        node_hi, node_lo, node_count, n_nodes, prev2, ptr2, dist2, rec_lane, first_p, p_cnt,
        k, canonical,
    )
    tails, heads = jcd.contig_base_streams(ca, k)

    def i64(x):
        return np.asarray(x).astype(np.int64)

    return dict(
        spec=port, node_key=convert.hilo_to_key(node_hi, node_lo),
        node_count=np.asarray(node_count), n_nodes=int(n_nodes),
        prev_link=i64(prev_link), rec_lane=i64(rec_lane), first_p=i64(first_p),
        p_cnt=i64(p_cnt), ptr=i64(ptr), dist=i64(dist), has_cycle=bool(has_cycle),
        cut=i64(cut), prev2=i64(prev2), ptr2=i64(ptr2), dist2=i64(dist2), ca=ca,
        tails=np.asarray(tails), heads=np.asarray(heads),
    )


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _eq(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
    assert got.numpy().dtype == want.dtype, what


def _check_nodes(r, k, canonical):
    key, count, n = tcd.nodes_stage_plain(r["spec"], k, canonical)
    _eq(key, r["node_key"], "node_key")
    _eq(count, r["node_count"], "node_count")
    assert n == r["n_nodes"]


def _check_links(r, k, canonical):
    got = tcd.links_stage_plain(_t(r["node_key"]), k)
    for name, g in zip(("prev_link", "rec_lane", "first_p", "p_cnt"), got):
        _eq(g, r[name], name)


def _check_labels(r, k, canonical):
    ptr, dist, has_cycle = tcd.label_stage_plain(_t(r["prev_link"]))
    _eq(ptr, r["ptr"], "ptr")
    _eq(dist, r["dist"], "dist")
    assert has_cycle == r["has_cycle"]
    # the cut on every input (the identity where nothing cycles), then the
    # labels on the links the pipeline goes on with
    _eq(tcd.cycle_fix_plain(_t(r["prev_link"])), r["cut"], "cut")
    ptr2, dist2, again = tcd.label_stage_plain(_t(r["prev2"]))
    _eq(ptr2, r["ptr2"], "ptr2")
    _eq(dist2, r["dist2"], "dist2")
    assert not again


def _check_reduce(r, k, canonical):
    ca = tcd.reduce_stage_plain(
        _t(r["node_key"]), _t(r["node_count"]), r["n_nodes"], _t(r["prev2"]),
        _t(r["ptr2"]), _t(r["dist2"]), _t(r["rec_lane"]), _t(r["first_p"]),
        _t(r["p_cnt"]), k, canonical,
    )
    assert_contig_arrays_equal(ca, r["ca"])


def _check_streams(r, k, canonical):
    ca = convert.contig_arrays_from_numpy(*(np.asarray(x) for x in r["ca"].tree_flatten()[0]))
    tails, heads = tcd.contig_base_streams_plain(ca, k)
    assert tails.dtype == heads.dtype == torch.uint8
    assert tails.shape[0] == int(ca.klen.sum())
    _eq(tails, r["tails"][: tails.shape[0]], "tails")
    _eq(heads, r["heads"][: ca.n_contigs], "heads")


STAGES = {
    "nodes": _check_nodes, "links": _check_links, "labels": _check_labels,
    "reduce": _check_reduce, "streams": _check_streams,
}


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("case,k,canonical", STAGE_POINTS)
def test_plain_stage_matches_reference(stage, case, k, canonical):
    """Each plain stage of the port (the version its kernel is held to on
    the card) equals the JAX stage on the JAX package's own inputs."""
    STAGES[stage](_reference_stages(case, k, canonical), k, canonical)


@pytest.mark.parametrize("case", ["palindrome", "cycles", "empty"])
def test_stage_cases_hold_what_they_name(case):
    """The palindrome case dedupes palindromic nodes at even k, the cycles
    case cuts several cycles of both strands, the empty case has no contig."""
    r = _reference_stages(case, 24, True)
    n = r["spec"].n
    if case == "palindrome":
        assert 0 < r["n_nodes"] < 2 * n
    elif case == "cycles":
        assert r["has_cycle"]
        assert int(((r["cut"] < 0) & (r["prev_link"] >= 0)).sum()) >= 6
    else:
        assert n == 0 and r["n_nodes"] == 0 and int(r["ca"].n_contigs) == 0


# ---- K13's label stage design, transcribed ------------------------------------

LABEL_POISON = np.uint64(0xFFFFFFFFFFFFFFFF)


def _label_transcription(prev: np.ndarray):
    """csrc/condense.cu label_heads / label_first / label_round / label_tail
    in numpy: packed words (ptr in bits 0-30, bit 31 set where ptr is a
    head, dist above), two buffers poisoned where no round wrote, the head
    bitmap, frontier bitmaps of 32-bit words (poisoned until a round writes
    them), ctl's counts of the lanes that moved and stayed, a round that
    returns at once after one in which nothing moved or stayed, and the
    tail, which unpacks every lane from the last round's buffer.  Returns
    (ptr, dist, has_cycle, rounds run, the frontier of each round run)."""
    C2 = len(prev)
    R = max(C2.bit_length(), 1)
    n_words = -(-C2 // 32)
    mask, head, hi = np.uint64(0x7FFFFFFF), np.uint64(1 << 31), np.uint64(32)
    words = [np.full(C2, LABEL_POISON) for _ in range(2)]
    fronts = [np.full(n_words, 0xFFFFFFFF, np.uint64) for _ in range(2)]
    moved, stay = np.zeros(R + 1, np.int64), np.zeros(R + 1, np.int64)

    def bitmap(flags: np.ndarray) -> np.ndarray:
        flags = np.concatenate([flags, np.zeros(32 * n_words - C2, bool)])
        shifted = flags.reshape(n_words, 32) << np.arange(32, dtype=np.uint64)
        return shifted.sum(1).astype(np.uint64)

    def lanes_of(bits: np.ndarray) -> np.ndarray:
        set_ = (bits[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
        return np.nonzero(set_.reshape(-1))[0]

    head_bits = bitmap(prev < 0)

    def is_head(p: np.ndarray) -> np.ndarray:
        return ((head_bits[p >> 5] >> (p & 31).astype(np.uint64)) & np.uint64(1)) == 1

    # round 1, every lane: heads write nothing, final words go to both buffers
    pv = prev
    pp = np.where(pv < 0, -1, prev[np.maximum(pv, 0)])
    real = pv >= 0
    first = real & (pp < 0)
    w = np.where(first, (np.uint64(1) << hi) | head | pv.astype(np.uint64),
                 (np.uint64(2) << hi) | pp.astype(np.uint64)
                 | np.where(is_head(np.maximum(pp, 0)) & (pp >= 0), head, np.uint64(0)))
    final = real & ((w & head) != 0)
    words[1][real] = w[real]
    words[0][final] = w[final]
    go = real & ~final
    fronts[0] = bitmap(go)
    moved[1], stay[1] = int((real & (pp >= 0) & (pp != pv)).sum()), int(go.sum())
    # rounds 2..R
    for t in range(2, R + 1):
        if moved[t - 1] == 0 or stay[t - 1] == 0:
            continue
        w_in, w_out = words[(t - 1) % 2], words[t % 2]
        f = lanes_of(fronts[t % 2])
        assert len(f) == stay[t - 1]
        w = w_in[f]
        done = (w & head) != 0
        w_out[f[done]] = w[done]
        g, wg = f[~done], w[~done]
        wp = w_in[(wg & mask).astype(np.int64)]
        w_out[g] = (((wg >> hi) + (wp >> hi)) << hi) | (wp & head) | (wp & mask)
        flags = np.zeros(C2, bool)
        flags[g] = True
        fronts[(t + 1) % 2] = bitmap(flags)
        moved[t], stay[t] = int(((wp & mask) != (wg & mask)).sum()), len(g)
    # the tail, every lane
    last = next((t for t in range(1, R) if moved[t] == 0), R)
    heads = is_head(np.arange(C2))
    w = words[last % 2][~heads]
    ptr, dist = np.arange(C2), np.zeros(C2, np.int64)
    ptr[~heads], dist[~heads] = (w & mask).astype(np.int64), (w >> hi).astype(np.int64)
    has_cycle = bool(((w & head) == 0).any())
    return ptr, dist, has_cycle, last, [C2] + stay[1:last].tolist()


def _label_rounds_reference(prev: np.ndarray) -> int:
    """The rounds the reference's loop runs (shannon_tpu/ops/condense.py:232)."""
    C2 = len(prev)
    ptr = np.where(prev >= 0, prev, np.arange(C2))
    for r in range(1, max(C2.bit_length(), 1) + 1):
        nxt = ptr[ptr]
        if (nxt == ptr).all():
            return r
        ptr = nxt
    return r


LABEL_CASES = [(kind, C2) for kind in ("isolated", "chains_pow2", "chains_pow2_plus1", "cycles",
                                       "self", "random", "one_cycle", "cycles_pow2",
                                       "cycles_pow2_plus1")
               for C2 in (1, 2, 31, 32, 33, 100, 1000)]
LABEL_CASES += [("one_chain", C2) for C2 in (1, 2, 3, 31, 32, 33, 64, 65, 257, 1024, 1025)]
LABEL_CASES += [("one_cycle", C2) for C2 in (3, 64, 65, 257, 1024, 1025)]


@pytest.mark.parametrize("kind,C2", LABEL_CASES)
def test_k13_frontier_transcription_matches_reference(kind, C2):
    """K13's label stage design (packed words, done only at a head, final
    words in both buffers, the frontier bitmaps, the early stop) against
    the reference's _label_stage, cycle lanes' pointers and offsets
    included, and the rounds it runs against the reference's loop."""
    prev = label_links(kind, C2, seed=C2)
    ptr, dist, has_cycle = (np.asarray(x) for x in jcd._label_stage(jnp.asarray(prev, jnp.int32)))
    got = _label_transcription(prev)
    np.testing.assert_array_equal(got[0], ptr.astype(np.int64))
    np.testing.assert_array_equal(got[1], dist.astype(np.int64))
    assert got[2] == bool(has_cycle)
    assert got[3] == _label_rounds_reference(prev)
    assert got[4][0] == C2 and all(a >= b for a, b in zip(got[4], got[4][1:]))
    if kind == "self" or (kind == "cycles" and C2 >= 2):
        assert has_cycle
    if kind == "one_chain" and C2 > 2 and (C2 - 1) & (C2 - 2) == 0:
        assert got[3] == C2.bit_length()  # 2^j + 1 lanes: the round cap


def _cycle_transcription(prev: np.ndarray, head_ptr: np.ndarray):
    """csrc/condense.cu cycle_first / cycle_round / cycle_tail in numpy:
    the cycle lanes S (prev[head_ptr] >= 0) as a bitmap of 32-bit words,
    packed words (ptr in bits 0-30, the running minimum in bits 32-62) in
    two buffers poisoned where no round wrote (every read of a lane of S
    must find a word a round wrote), round 1 from prev for the lanes of S
    alone, rounds 2..R over the bitmap's lanes, ctl's count of the lanes
    whose minimum changed, a round that returns at once after one that
    changed none, and the tail, which cuts a lane of S whose minimum is
    itself.  Returns (the cut links, rounds run, |S|, each round's
    changed count)."""
    C2 = len(prev)
    R = max(C2.bit_length(), 1)
    n_words = -(-C2 // 32)
    mask, hi = np.uint64(0x7FFFFFFF), np.uint64(32)
    words = [np.full(C2, LABEL_POISON) for _ in range(2)]
    ctl = np.zeros(R + 1, np.int64)

    # the first launch, every lane: the bitmap of S, and round 1 on S
    in_s = prev[head_ptr] >= 0
    flags = np.concatenate([in_s, np.zeros(32 * n_words - C2, bool)])
    bits = (flags.reshape(n_words, 32) << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint64)
    lanes = np.nonzero(in_s)[0]
    pv = prev[lanes]
    assert (pv >= 0).all() and (prev[pv] >= 0).all()  # S holds no head, and is closed
    words[1][lanes] = (np.minimum(pv, lanes).astype(np.uint64) << hi) | prev[pv].astype(np.uint64)
    ctl[0], ctl[1] = len(lanes), int((pv < lanes).sum())
    # rounds 2..R over the bitmap's lanes
    for t in range(2, R + 1):
        if ctl[t - 1] == 0:
            continue
        w_in, w_out = words[(t - 1) % 2], words[t % 2]
        set_ = (bits[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
        f = np.nonzero(set_.reshape(-1))[0]
        w = w_in[f]
        wp = w_in[(w & mask).astype(np.int64)]
        assert (w != LABEL_POISON).all() and (wp != LABEL_POISON).all()
        m, mp = w >> hi, wp >> hi
        w_out[f] = (np.minimum(m, mp) << hi) | (wp & mask)
        ctl[t] = int((mp < m).sum())
    # the tail, every lane
    last = next((t for t in range(1, R) if ctl[t] == 0), R)
    w = words[last % 2][lanes]
    assert (w != LABEL_POISON).all()
    out = prev.copy()
    out[lanes[(w >> hi).astype(np.int64) == lanes]] = -1
    return out, last, int(ctl[0]), ctl[1 : last + 1].tolist()


def _cycle_rounds_reference(prev: np.ndarray, in_s: np.ndarray) -> int:
    """The first round of the reference's loop (shannon_tpu/ops/condense.py:264)
    that changes no minimum on the lanes of S, else its R rounds."""
    C2 = len(prev)
    R = max(C2.bit_length(), 1)
    ptr = np.where(prev >= 0, prev, np.arange(C2))
    mn = np.arange(C2)
    for r in range(1, R + 1):
        nxt = np.minimum(mn, mn[ptr])
        if (nxt[in_s] == mn[in_s]).all():
            return r
        ptr, mn = ptr[ptr], nxt
    return R


@pytest.mark.parametrize("kind,C2", LABEL_CASES)
def test_k13_cycle_transcription_matches_reference(kind, C2):
    """K13's cycle cut design (S from the label stage's pointers, packed
    (pointer, minimum) words, rounds over S alone, the early stop) against
    the reference's _cycle_fix, rho shapes and self-loops included; it
    stops at the first round that changes no minimum on S, never after R."""
    prev = label_links(kind, C2, seed=C2)
    head_ptr = np.asarray(jcd._label_stage(jnp.asarray(prev, jnp.int32))[0]).astype(np.int64)
    want = np.asarray(jcd._cycle_fix(jnp.asarray(prev, jnp.int32))).astype(np.int64)
    cut, rounds, n_s, changed = _cycle_transcription(prev, head_ptr)
    np.testing.assert_array_equal(cut, want)
    in_s = prev[head_ptr] >= 0
    assert n_s == int(in_s.sum())
    assert rounds == _cycle_rounds_reference(prev, in_s) <= max(C2.bit_length(), 1)
    assert len(changed) == rounds and all(changed[:-1])
    assert ((cut < 0) & (prev >= 0) & ~in_s).sum() == 0  # only lanes of S are cut
    if kind == "one_cycle":
        # the minimum travels the whole cycle: changes up to round
        # ceil(log2(C2)), so every one of the R rounds runs
        assert n_s == C2 and int((cut < 0).sum()) == 1
        assert rounds == max(C2.bit_length(), 1)
    if kind in ("isolated", "chains_pow2", "chains_pow2_plus1", "one_chain"):
        assert n_s == 0 and rounds == 1


@pytest.mark.parametrize("kind", ["cycles", "self", "random", "one_cycle", "cycles_pow2_plus1",
                                  "chains_pow2"])
@pytest.mark.parametrize("C2", [1, 33, 1000])
def test_cycle_fix_head_ptr_route_matches_reference(kind, C2):
    """cycle_fix with the label stage's pointers equals the one-argument
    call and the reference's _cycle_fix on the plain route."""
    prev = label_links(kind, C2, seed=C2 + 1)
    want = np.asarray(jcd._cycle_fix(jnp.asarray(prev, jnp.int32))).astype(np.int64)
    t_prev = _t(prev)
    head_ptr = tcd.label_stage(t_prev)[0]
    with_ptr = tcd.cycle_fix(t_prev, head_ptr)
    _eq(with_ptr, want, "cut with head_ptr")
    _eq(tcd.cycle_fix(t_prev), want, "cut")
    with pytest.raises(ValueError, match="disagree"):
        tcd.cycle_fix(t_prev, head_ptr[:-1])


def test_label_stage_refuses_2_31_lanes():
    """K13 packs a pointer in 31 bits: label_stage refuses a table of 2^31
    lanes before anything runs (a meta tensor holds no data)."""
    big = torch.empty(1 << 31, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        tcd.label_stage(big)
    with pytest.raises(ValueError, match="2\\^31"):
        tcd.cycle_fix(big, big)
    assert tcd.LABEL_MAX_LANES == (1 << 31) - 1


# ---- K11's and K12's designs, transcribed ---------------------------------------

PAD_KEY = np.int64((1 << 63) - 1)
POISON = np.int64(-7)  # no lane of an output may keep it


def _merge_split(a: np.ndarray, b: np.ndarray, d: int) -> int:
    """common.cuh merge_split: a's lanes among the first d of the merge of a
    and b, ties to a (the warp's 32-ary search finds the same first index
    where the monotone test fails as this binary search)."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _nodes_transcription(key: np.ndarray, count: np.ndarray, n: int, k: int,
                         tile: int = 2048):
    """csrc/condense.cu node_rc_kernel, the sort and node_merge_kernel in
    numpy: the reverse complements of the n real lanes with PAD on the
    palindromes and their count, a sort with its indices, then tiles of
    `tile` node lanes, each split on its two diagonals, loaded (a reverse
    complement's count through its index) and written a lane at a time
    from a binary search of the lane's diagonal in the tile."""
    C2 = 2 * len(key)
    a = key[:n]
    r = tcd.revcomp_key(torch.from_numpy(a.copy()), k).numpy()
    pal = r == a
    rc = np.where(pal, PAD_KEY, r)
    rc_lane = np.argsort(rc, kind="stable")
    rc_key = rc[rc_lane]
    nb = n - int(pal.sum())
    N, b = n + nb, rc_key[:nb]
    node_key = np.full(C2, POISON)
    node_count = np.full(C2, -7, np.int32)
    for d0 in range(0, C2, tile):
        e = min(d0 + tile, C2)
        d1 = min(e, N)
        if d0 < d1:
            a0, a1 = _merge_split(a, b, d0), _merge_split(a, b, d1)
            b0, la, L = d0 - a0, a1 - a0, d1 - d0
            lb = L - la
            s_key = np.concatenate([a[a0:a1], rc_key[b0:b0 + lb]])
            s_count = np.concatenate([count[a0:a1], count[rc_lane[b0:b0 + lb]]])
            for p in range(L):
                lo, hi = max(0, p - lb), min(p, la)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if s_key[mid] < s_key[la + p - 1 - mid]:
                        lo = mid + 1
                    else:
                        hi = mid
                bi = p - lo
                slot = lo if lo < la and (bi >= lb or s_key[lo] < s_key[la + bi]) else la + bi
                node_key[d0 + p], node_count[d0 + p] = s_key[slot], s_count[slot]
        node_key[max(d1, d0):e], node_count[max(d1, d0):e] = PAD_KEY, 0
    return node_key, node_count, 2 * n - int(pal.sum())


# K12's geometry: (target lanes a tile, records of a source run a chunk
# takes, targets a chunk takes, outputs a merge thread takes), the source's
# and one small enough that nearly every tile is cut into chunks
LINK_GEOMETRIES = {"source": (1024, 512, 1056, 8), "small": (5, 3, 6, 2)}


def _links_transcription(node_key: np.ndarray, k: int, tile: int, src_cap: int,
                         tgt_cap: int, items: int):
    """csrc/condense.cu link_bounds_kernel and link_tiles_kernel in numpy:
    five lower bounds a tile edge, then for each tile its pads and its
    chunks: the caps, the chunk's end below the smallest (k-1)-mer past
    them, the three merge-path levels over slots (source run r at r *
    src_cap, the targets at 4 * src_cap) by their order keys ((k-1)-mer <<
    3 | run) with `items` outputs a thread, the slot -> place inverse,
    rec_lane, and each record's group walk, a run at a time."""
    C2 = len(node_key)
    hs = 2 * (k - 1)
    mask = (1 << hs) - 1
    n_tiles = -(-C2 // tile)
    queries = []
    for t in range(n_tiles + 1):
        v = int(node_key[t * tile]) if t * tile < C2 else int(PAD_KEY)
        x = 0 if t == 0 else v >> 2
        for r in range(5):
            if v != PAD_KEY:
                queries.append(x << 2 if r == 4 else (r << hs) | x)
            else:
                queries.append(int(PAD_KEY) if r == 4 else (r + 1) << hs)
    bounds = np.searchsorted(node_key, np.array(queries, np.int64)).reshape(-1, 5)
    n = int(bounds[n_tiles, 4])
    prev_link, first_p, p_cnt = (np.full(C2, POISON) for _ in range(3))
    rec_lane = np.full(2 * C2, POISON)
    caps = [src_cap] * 4 + [tgt_cap]

    def run_of(slot):
        return min(slot // src_cap, 4)

    def kmer(v, r):
        return int(v) >> 2 if r == 4 else int(v) & mask

    def merge(s_key, a, b, out, d0, d1):  # link_merge; a, b lists of slots
        def order(slot):
            return kmer(s_key[slot], run_of(slot)) << 3 | run_of(slot)
        lo, hi = max(0, d0 - len(b)), min(d0, len(a))
        while lo < hi:
            mid = (lo + hi) // 2
            if order(a[mid]) < order(b[d0 - 1 - mid]):
                lo = mid + 1
            else:
                hi = mid
        i, j = lo, d0 - lo
        for d in range(d0, d1):
            ka = order(a[i]) if i < len(a) else 1 << 64
            kb = order(b[j]) if j < len(b) else 1 << 64
            assert ka != kb
            if ka < kb:
                out[d], i = a[i], i + 1
            else:
                out[d], j = b[j], j + 1

    def level(pairs, total):  # a thread's `items` outputs, split at a pair's end
        for d in range(0, total, items):
            e = min(d + items, total)
            for a, b, out, base in pairs:
                lo, hi = max(d, base), min(e, base + len(a) + len(b))
                if lo < hi:
                    merge(s_key, a, b, out, lo - base, hi - base)

    for t in range(n_tiles):
        lo0, hi0 = t * tile, min(t * tile + tile, C2)
        for lane in range(max(lo0, n), hi0):
            prev_link[lane], first_p[lane], p_cnt[lane] = -1, 0, 0
            rec_lane[n + lane] = rec_lane[C2 + lane] = lane
        pos, end = [int(x) for x in bounds[t]], [int(x) for x in bounds[t + 1]]
        out = pos[4] + sum(pos[b] - int(bounds[0, b]) for b in range(4))
        while True:
            left = [end[r] - pos[r] for r in range(5)]
            cnt = [min(left[r], caps[r]) for r in range(5)]
            ys = [kmer(node_key[pos[r] + caps[r]], r) if left[r] > caps[r] else None
                  for r in range(5)]
            if sum(cnt) == 0:
                break
            y = min((v for v in ys if v is not None), default=None)
            s_key = {}
            for r in range(5):
                for q in range(cnt[r]):
                    s_key[r * src_cap + q] = node_key[pos[r] + q]
            lens = []
            for r in range(5):
                km = [kmer(s_key[r * src_cap + q], r) for q in range(cnt[r])]
                lens.append(cnt[r] if y is None else int(np.searchsorted(km, y)))
            runs = [[r * src_cap + q for q in range(lens[r])] for r in range(5)]
            n01, S = lens[0] + lens[1], sum(lens[:4])
            M = S + lens[4]
            s_a, s_b = [None] * M, [None] * max(S, 1)
            s_a01, s_a23 = [None] * n01, [None] * (S - n01)
            level([(runs[0], runs[1], s_a01, 0), (runs[2], runs[3], s_a23, n01)], S)
            s_a[:S] = s_a01 + s_a23
            level([(s_a[:n01], s_a[n01:S], s_b, 0)], S)
            level([(s_b[:S], runs[4], s_a, 0)], M)
            place = {slot: j for j, slot in enumerate(s_a)}  # the slot -> place inverse
            assert len(place) == M

            def lane_of(slot):
                r = run_of(slot)
                return pos[r] + slot - r * src_cap

            def kmer_at(j):
                return kmer(s_key[s_a[j]], run_of(s_a[j]))

            for j in range(M):
                rec_lane[out + j] = lane_of(s_a[j])
            for r in range(5):  # the group join, a run's records in lane order
                for q in range(lens[r]):
                    slot = r * src_cap + q
                    j, x, lane = place[slot], kmer(s_key[slot], r), pos[r] + q
                    if r == 4:
                        g0 = j
                        while g0 > 0 and kmer_at(g0 - 1) == x:
                            g0 -= 1
                        fp = g0
                        while run_of(s_a[fp]) < 4:
                            fp += 1
                        e = j + 1
                        while e < M and kmer_at(e) == x:
                            e += 1
                        prev_link[lane] = lane_of(s_a[g0]) if fp - g0 == 1 and e - fp == 1 else -1
                    else:
                        fp = j + 1
                        while fp < M and run_of(s_a[fp]) < 4 and kmer_at(fp) == x:
                            fp += 1
                        e = fp
                        while e < M and kmer_at(e) == x:
                            e += 1
                        first_p[lane], p_cnt[lane] = out + fp, e - fp
            pos = [pos[r] + lens[r] for r in range(5)]
            out += M
    return prev_link, rec_lane, first_p, p_cnt, n_tiles


@functools.lru_cache(maxsize=None)
def _stress_reference(case: str) -> dict:
    """The JAX package's node table (canonical cases) and links of one
    stage_tables case, as numpy."""
    keys, counts, k, canonical = stage_tables(case)
    out = {"k": k, "canonical": canonical}
    if canonical:
        ref = spectrum_from_arrays(keys.astype(np.uint64), counts, STAGE_SPECTRUM_LANES)
        node_hi, node_lo, node_count, n_nodes = jcd._nodes_stage(ref, k, True)
        spec = convert.spectrum_from_numpy(np.asarray(ref.hi), np.asarray(ref.lo),
                                           np.asarray(ref.count), int(ref.n))
        out.update(spec=spec, node_count=np.asarray(node_count), n_nodes=int(n_nodes))
    else:
        table = np.full(STAGE_TABLE_LANES, PAD_KEY)
        table[: len(keys)] = keys
        node_hi, node_lo = (jnp.asarray(x) for x in convert.key_to_hilo(table))
    _next, prev_link, rec_lane, first_p, p_cnt = jcd._links_stage(node_hi, node_lo, k)
    out.update(node_key=convert.hilo_to_key(node_hi, node_lo), prev_link=prev_link,
               rec_lane=rec_lane, first_p=first_p, p_cnt=p_cnt)
    return {name: np.asarray(x).astype(np.int64) if name in LINK_OUTPUTS else x
            for name, x in out.items()}


LINK_OUTPUTS = ("prev_link", "rec_lane", "first_p", "p_cnt")
DESIGN_POINTS = [("stage", p) for p in STAGE_POINTS] + [("stress", c) for c in STAGE_TABLES]
# K11 takes canonical spectra (it is the identity on the other points)
NODE_POINTS = [("stage", p) for p in STAGE_POINTS if p[2]] + [
    ("stress", c) for c, (_k, canonical) in STAGE_TABLES.items() if canonical]


def _design_reference(kind: str, point) -> dict:
    if kind == "stage":
        r = _reference_stages(*point)
        return {**r, "k": point[1], "canonical": point[2]}
    return _stress_reference(point)


@pytest.mark.parametrize("kind,point", NODE_POINTS)
def test_k11_transcription_matches_reference(kind, point):
    """K11's design (the real reverse complements less the palindromes,
    sorted, merged with the spectrum in tiles split on their diagonals)
    against the reference's _nodes_stage, at the source's tile and at 7
    lanes a tile (a tile edge inside every run of the merge)."""
    r = _design_reference(kind, point)
    spec = r["spec"]
    key, count = spec.key.numpy(), spec.count.numpy()
    n = min(spec.n, spec.capacity)
    for tile in (2048, 7):
        got = _nodes_transcription(key, count, n, r["k"], tile)
        np.testing.assert_array_equal(got[0], r["node_key"], err_msg=f"node_key, tile {tile}")
        np.testing.assert_array_equal(got[1], r["node_count"], err_msg=f"count, tile {tile}")
        assert got[2] == r["n_nodes"]


@pytest.mark.parametrize("geometry", list(LINK_GEOMETRIES))
@pytest.mark.parametrize("kind,point", DESIGN_POINTS)
def test_k12_transcription_matches_reference(kind, point, geometry):
    """K12's design (key-range tiles from five lower bounds an edge, chunks
    under the caps, three merge-path levels, the group walks) against the
    reference's _links_stage, pads included, at the source's geometry and
    at a small one (5 target lanes a tile: a C2 no tile width divides)."""
    r = _design_reference(kind, point)
    got = _links_transcription(r["node_key"], r["k"], *LINK_GEOMETRIES[geometry])
    for name, g in zip(LINK_OUTPUTS, got):
        np.testing.assert_array_equal(g, r[name], err_msg=name)


def test_k12_stress_cases_hold_what_they_name():
    """"tips" puts more than twice the source cap of one run into one
    source-geometry tile (so that tile takes several chunks), "four_runs"
    has groups of four sources in four runs, "no_A" / "no_T" an empty
    source run, "palindromes" only palindromes."""
    src_cap = LINK_GEOMETRIES["source"][1]
    tile = LINK_GEOMETRIES["source"][0]
    r = _stress_reference("tips")
    key, k = r["node_key"], r["k"]
    hs = 2 * (k - 1)
    real = key[key != PAD_KEY]
    edges = [0] + [int(real[t]) >> 2 for t in range(tile, len(real), tile)] + [1 << hs]
    suf, first = real & ((1 << hs) - 1), real >> hs
    per_tile = [int(((suf >= a) & (suf < b) & (first == 3)).sum()) for a, b in zip(edges, edges[1:])]
    assert max(per_tile) > 2 * src_cap
    r = _stress_reference("four_runs")
    real = r["node_key"][r["node_key"] != PAD_KEY]
    suf = real & ((1 << hs) - 1)
    assert (np.unique(suf, return_counts=True)[1] == 4).sum() >= 250
    for case, missing in (("no_A", 0), ("no_T", 3)):
        r = _stress_reference(case)
        key = r["node_key"]
        assert not ((key != PAD_KEY) & (key >> (2 * r["k"] - 2) == missing)).any()
    r = _stress_reference("palindromes")
    assert r["n_nodes"] == r["spec"].n == 16


# ---- K14: edge tables, and its design transcribed --------------------------------

# node lanes of the scan's tile (SCAN_TILE in csrc/scan.cuh) and one either side
TILE_EDGES = [("singletons", c2) for c2 in (4095, 4096, 4097)]
REDUCE_POINTS = [(case, 4096) for case in REDUCE_TABLES] + TILE_EDGES


@functools.lru_cache(maxsize=None)
def _reduce_reference(case: str, C2: int) -> dict:
    """K14's inputs for one reduce_tables case, from the JAX package's
    links and labels (cycles cut, as build_contig_arrays cuts them), and its
    _reduce_stage on them, as _reference_stages runs it."""
    node_key, node_count, n_nodes, k, canonical = reduce_tables(case, C2)
    node_hi, node_lo = (jnp.asarray(x) for x in convert.key_to_hilo(node_key))
    _next, prev, rec_lane, first_p, p_cnt = jcd._links_stage(node_hi, node_lo, k)
    ptr, dist, has_cycle = jcd._label_stage(prev)
    if bool(has_cycle):
        prev = jcd._cycle_fix(prev)
        ptr, dist, _ = jcd._label_stage(prev)
    ca = jcd._reduce_stage(node_hi, node_lo, jnp.asarray(node_count), n_nodes, prev, ptr, dist,
                           rec_lane, first_p, p_cnt, k, canonical)

    def i64(x):
        return np.asarray(x).astype(np.int64)

    return dict(node_key=node_key, node_count=node_count, n_nodes=n_nodes, prev2=i64(prev),
                ptr2=i64(ptr), dist2=i64(dist), rec_lane=i64(rec_lane), first_p=i64(first_p),
                p_cnt=i64(p_cnt), has_cycle=bool(has_cycle), ca=ca, k=k, canonical=canonical)


@pytest.mark.parametrize("case,C2", REDUCE_POINTS)
def test_reduce_plain_on_edge_tables_matches_reference(case, C2):
    """K14's plain version against the reference's _reduce_stage on tables
    with no lane, only pads, one contig of every node, every node a contig,
    rc twins and palindromes, one strand only, and cycles cut."""
    r = _reduce_reference(case, C2)
    _check_reduce(r, r["k"], r["canonical"])


def test_reduce_edge_tables_hold_what_they_name():
    def n_contigs(case, C2=4096):
        return int(_reduce_reference(case, C2)["ca"].n_contigs)

    assert len(_reduce_reference("empty", 4096)["node_key"]) == 0
    assert n_contigs("empty") == n_contigs("all_pad") == 0
    assert n_contigs("one_contig") == 1
    for C2 in (4096, 4095, 4097):
        assert n_contigs("singletons", C2) == _reduce_reference("singletons", C2)["n_nodes"]
    r = _reduce_reference("twins_palindromes", 4096)
    key = r["node_key"][: r["n_nodes"]]
    assert (tcd.revcomp_key(torch.from_numpy(key), r["k"]).numpy() == key).any()
    rc = np.asarray(r["ca"].rc_pair)[: n_contigs("twins_palindromes")]
    assert (rc != np.arange(len(rc))).any() and (rc == np.arange(len(rc))).any()
    assert _reduce_reference("cycles", 4096)["has_cycle"]
    assert not _reduce_reference("non_canonical", 4096)["canonical"]


def _reduce_transcription(r: dict, threads: int = 256, items: int = 16):
    """csrc/condense.cu contig_heads / contig_lanes / contig_slots in numpy:
    tiles of threads x items lanes, lane base + j * threads + t for thread t
    and row j, ranked by each (row, warp) ballot's count scanned in lane
    order, the tiles' prefixes in tile order (what the look-back gives);
    ids (-1 real, -2 pad), the head's slots, then the members' count sums
    and (offset << 32) | lane maxima, then the contig slots, n_contigs from
    the scan's total.  Every output starts poisoned.  Returns the arrays in
    ContigArrays order and n_contigs."""
    node_key, count = r["node_key"], r["node_count"].astype(np.int64)
    prev2, head_ptr, dist = r["prev2"], r["ptr2"], r["dist2"]
    rec_lane, first_p, p_cnt, k = r["rec_lane"], r["first_p"], r["p_cnt"], r["k"]
    C2, tile, warps = len(node_key), threads * items, threads // 32

    def poisoned(dtype=np.int64):
        return np.full(C2, -7, dtype)

    ids, count_sum, head_lane = poisoned(), poisoned(), poisoned()
    tail = np.full(C2, np.uint64(7 << 40), np.uint64)
    prefix = 0
    for t0 in range(0, C2, tile):
        lanes = t0 + np.arange(items)[:, None] * threads + np.arange(threads)[None, :]
        inside = lanes < C2
        at = np.minimum(lanes, C2 - 1)
        real = inside & (node_key[at] != PAD_KEY)
        head = (real & (prev2[at] < 0)).reshape(items, warps, 32)
        per = head.sum(2).ravel()  # (row, warp) counts in lane order
        before = (np.cumsum(per) - per).reshape(items, warps, 1)
        within = np.cumsum(head, 2) - head
        cid = (prefix + before + within).reshape(items, threads)
        head = head.reshape(items, threads)
        h_lanes, h_cid = lanes[head], cid[head]
        ids[h_lanes] = h_cid
        head_lane[h_cid], count_sum[h_cid] = h_lanes, count[h_lanes]
        tail[h_cid] = h_lanes.astype(np.uint64)
        others = inside & ~head
        ids[lanes[others]] = np.where(real[others], -1, -2)
        prefix += int(head.sum())
    n = prefix
    assert (ids != -7).all()

    pad = ids == -2
    h = ids[head_ptr.clip(0, max(C2 - 1, 0))] if C2 else ids
    node_cid = np.where(pad, -1, np.where(h >= 0, h, -1))
    node_off = np.where(pad, -1, dist)
    member = (ids == -1) & (node_cid >= 0)
    lanes = np.nonzero(member)[0]
    np.add.at(count_sum, node_cid[lanes], count[lanes])
    packed = (dist[lanes].astype(np.uint64) << np.uint64(32)) | lanes.astype(np.uint64)
    np.maximum.at(tail, node_cid[lanes], packed)

    klen, abundance, tail_lane = np.zeros(C2, np.int64), np.zeros(C2, np.float32), poisoned()
    out_edges, rc_pair = np.full((4, C2), -1, np.int64), np.arange(C2, dtype=np.int64)
    c = np.arange(n)
    tl = (tail[:n] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    klen[:n] = (tail[:n] >> np.uint64(32)).astype(np.int64) + 1
    tail_lane[:n], tail_lane[n:] = tl, -1
    count_sum[n:], head_lane[n:] = 0, -1
    abundance[:n] = count_sum[:n].astype(np.float32) / klen[:n].astype(np.float32)
    fp, pc = first_p[tl], p_cnt[tl]
    for j in range(4):
        hit = j < pc
        out_edges[j, c[hit]] = node_cid[rec_lane[fp[hit] + j]]
    if r["canonical"] and n:
        q = tcd.revcomp_key(torch.from_numpy(node_key[tl]), k).numpy()
        idx = np.minimum(np.searchsorted(node_key, q), C2 - 1)
        twin = (node_key[idx] == q) & (dist[idx] == 0)
        rc_pair[c[twin]] = node_cid[idx[twin]]
    return (node_cid, node_off, klen, abundance, count_sum, head_lane, tail_lane, out_edges,
            rc_pair), n


REDUCE_GEOMETRIES = {"source": (256, 16), "small": (64, 2)}


@pytest.mark.parametrize("geometry", list(REDUCE_GEOMETRIES))
@pytest.mark.parametrize("case,C2", REDUCE_POINTS)
def test_k14_transcription_matches_reference(case, C2, geometry):
    """K14's design (head ids from a tiled ballot scan with the tiles'
    prefixes in order, the members' atomic sums and packed maxima, the
    contig slots from n_contigs) against the reference's _reduce_stage over
    every lane, at the source's tile of 4,096 lanes and at 128 (so the
    small tables span many tiles)."""
    r = _reduce_reference(case, C2)
    got, n = _reduce_transcription(r, *REDUCE_GEOMETRIES[geometry])
    want = dict(zip(
        "node_hi node_lo node_count node_cid node_off klen abundance count_sum head_lane "
        "tail_lane out_edges rc_pair n_nodes n_contigs".split(), r["ca"].tree_flatten()[0]))
    assert n == int(want["n_contigs"])
    names = "node_cid node_off klen abundance count_sum head_lane tail_lane out_edges rc_pair"
    for name, g in zip(names.split(), got):
        w = np.asarray(want[name])
        if name == "abundance":
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=name)
        else:
            np.testing.assert_array_equal(g, w.astype(np.int64), err_msg=name)


# ---- K15: the base streams on the edge tables, and its design transcribed --------

# n_contigs at K15's scan tile of 256 contigs and at 16 of them, and one
# either side: singletons tables of C2 - 3 nodes, every node a contig
STREAM_TILE_EDGES = [("singletons", c2) for c2 in (258, 259, 260, 4098, 4099, 4100)]
STREAM_POINTS = REDUCE_POINTS + STREAM_TILE_EDGES


def _streams_input(case: str, C2: int):
    """The reference's ContigArrays of one edge table (cycles cut), in the
    port's layout."""
    r = _reduce_reference(case, C2)
    return r, convert.contig_arrays_from_numpy(
        *(np.asarray(x) for x in r["ca"].tree_flatten()[0]))


@pytest.mark.parametrize("case,C2", STREAM_POINTS)
def test_streams_plain_on_edge_tables_matches_reference(case, C2):
    """K15's plain version against the reference's contig_base_streams (its
    first sum-klen tails, its first n_contigs head rows) on tables with no
    lane, only pads, one contig of every node, every node a contig (at
    n_contigs 255-257 and 4,095-4,097 too), rc twins and palindromes, one
    strand only, and cycles cut."""
    r, ca = _streams_input(case, C2)
    k = r["k"]
    tails, heads = tcd.contig_base_streams_plain(ca, k)
    r_tails, r_heads = jcd.contig_base_streams(r["ca"], k)
    total = int(ca.klen[: ca.n_contigs].sum())
    assert tails.shape == (total,) and heads.shape == (ca.n_contigs, k - 1)
    _eq(tails, np.asarray(r_tails)[:total], "tails")
    _eq(heads, np.asarray(r_heads)[: ca.n_contigs], "heads")


@pytest.mark.parametrize("case,C2", STREAM_POINTS)
def test_streams_length_is_n_nodes_on_edge_tables(case, C2):
    """What lets K15 size its tails with no scan and no host read: on every
    edge table, in the reference's arrays and in the port's K14 (plain) on
    the same labels, sum(klen[:n_contigs]) == n_nodes, and node_cid >= 0
    on exactly the lanes [0, n_nodes)."""
    r, ref_ca = _streams_input(case, C2)
    port_ca = tcd.reduce_stage_plain(
        _t(r["node_key"]), _t(r["node_count"]), r["n_nodes"], _t(r["prev2"]), _t(r["ptr2"]),
        _t(r["dist2"]), _t(r["rec_lane"]), _t(r["first_p"]), _t(r["p_cnt"]), r["k"],
        r["canonical"])
    for ca in (ref_ca, port_ca):
        assert ca.n_nodes == r["n_nodes"] <= ca.node_key.shape[0]
        assert int(ca.klen[: ca.n_contigs].sum()) == ca.n_nodes
        real = (ca.node_cid >= 0).numpy()
        assert real[: ca.n_nodes].all() and not real[ca.n_nodes:].any()
    if case == "singletons":
        assert ref_ca.n_contigs == C2 - 3


def _streams_transcription(ca, k: int, tile: int = 256):
    """csrc/condense.cu stream_heads_kernel / tails_stream_kernel in numpy:
    tiles of `tile` contigs, a thread each, their tail starts from the
    tile's exclusive scan of klen and the tiles' prefixes in tile order
    (what the look-back gives); each tile's heads written as 4-byte words
    over its stretch of the [n_contigs, k-1] array from the gathered head
    keys; then every lane of [0, n_tails) with a contig id stores its last
    base at tstart[cid] + off.  Outputs start poisoned.  Returns (tails,
    heads, the scan's total)."""
    node_key, node_cid, node_off = (x.numpy() for x in (ca.node_key, ca.node_cid, ca.node_off))
    n, C2, w = ca.n_contigs, len(node_key), k - 1
    n_tails = min(ca.n_nodes, C2) if n else 0
    klen, head_lane = ca.klen.numpy()[:n], ca.head_lane.numpy()[:n]
    tstart = np.full(n, -7, np.int64)
    heads = np.full(n * w, 0xEE, np.uint8)
    prefix = 0
    for base in range(0, n, tile):
        end = min(base + tile, n)
        keys = node_key[np.clip(head_lane[base:end], 0, C2 - 1)]
        lens = klen[base:end]
        tstart[base:end] = prefix + np.cumsum(lens) - lens
        prefix += int(lens.sum())
        n_bytes = (end - base) * w
        for t in range(0, n_bytes, 4):
            c, j = divmod(t, w)
            for b in range(min(4, n_bytes - t)):
                heads[base * w + t + b] = (int(keys[c]) >> (2 * (w - j))) & 3
                j += 1
                if j == w:
                    c, j = c + 1, 0
    tails = np.full(n_tails, 0xEE, np.uint8)
    cid, off, key = node_cid[:n_tails], node_off[:n_tails], node_key[:n_tails]
    has = cid >= 0
    slot = tstart[cid[has]] + off[has]
    inside = (slot >= 0) & (slot < n_tails)
    tails[slot[inside]] = key[has][inside] & 3
    return tails, heads.reshape(n, w), prefix


# contigs a tile: the kernel's, and a small one so the small tables span
# many tiles
STREAM_GEOMETRIES = {"source": 256, "small": 8}


@pytest.mark.parametrize("geometry", list(STREAM_GEOMETRIES))
@pytest.mark.parametrize("case,C2", STREAM_POINTS)
def test_k15_transcription_matches_plain(case, C2, geometry):
    """K15's design (tail starts from a tiled look-back scan over the
    contigs alone, heads as words from one gathered key a contig, tails
    over the real lanes alone) against the plain twin, at the kernel's
    tile of 256 contigs and at 8; the scan's total is the tails' length."""
    r, ca = _streams_input(case, C2)
    tails, heads, total = _streams_transcription(ca, r["k"], STREAM_GEOMETRIES[geometry])
    want_tails, want_heads = tcd.contig_base_streams_plain(ca, r["k"])
    assert total == tails.shape[0] == want_tails.shape[0]
    np.testing.assert_array_equal(tails, want_tails.numpy())
    np.testing.assert_array_equal(heads, want_heads.numpy())
