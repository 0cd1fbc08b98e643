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
from test_torch_kernels import label_links

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
                                       "self", "random") for C2 in (1, 2, 31, 32, 33, 100, 1000)]
LABEL_CASES += [("one_chain", C2) for C2 in (1, 2, 3, 31, 32, 33, 64, 65, 257, 1024, 1025)]


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


def test_label_stage_refuses_2_31_lanes():
    """K13 packs a pointer in 31 bits: label_stage refuses a table of 2^31
    lanes before anything runs (a meta tensor holds no data)."""
    big = torch.empty(1 << 31, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        tcd.label_stage(big)
    assert tcd.LABEL_MAX_LANES == (1 << 31) - 1
