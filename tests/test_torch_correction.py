"""Port parity: error correction (histogram, abundance cut, probe tables,
the rescue rounds, the error-capped prune rounds and the fixpoint after
their first round, compaction, the whole stage, and the single-round steps
abundance_filter and sibling_prune_round)
against shannon_tpu.ops.correction on JAX-CPU, a transcription of K8's
frontier schedule with the probe symmetry it rests on, and transcriptions
of K20's cut kernel and of the abundance filter's count-predicate
compaction, and of the sibling-prune round on CUDA (K22's real lanes, then
K23's decision as one compaction's predicate).  Both packages start from
the same counted spectrum (via convert).  The plain versions run here (CPU
tensors); tests/test_torch_kernels.py holds kernels K7-K10, K16, K20 and
K23 against them on the card.

Tolerance: exact — corrected keys and counts equal over the whole table;
probe tables equal on real lanes where hit (idx is a contract only
there); round outputs and their changed flags equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops import correction as jcor
from shannon_tpu.ops.count import Spectrum as JSpectrum, count_spectrum_packed
from shannon_tpu.oracle.correction import choose_min_abundance
from shannon_tpu.sim import sample_reads, simulate_isoforms, simulate_transcripts
from shannon_tpu_torch import convert, kernels
from shannon_tpu_torch.ops import correction as tcor
from shannon_tpu_torch.ops.count import Spectrum
from shannon_tpu_torch.ops.kmers import PAD, canonical_key
from shannon_tpu_torch.ops.spectrum import probe_keys
from test_torch_count import CONTRACT_PRODUCERS, _contract_producer
from test_torch_kernels import (
    K20_CUTS, K20_N_REAL, CONTRACT_CASES, EDGE_SIZES, _histogram_spectrum, contract_case, cut_table, keep_case,
    k22_tables, k23_float_grid, prune_grid,
)


def _spectra(k: int, seed: int = 0, error_rate: float = 0.01, canonical: bool = True):
    rng = np.random.default_rng(seed)
    ts = simulate_transcripts(rng, n=2, length=300) + simulate_isoforms(rng, exon_length=120)
    reads = sample_reads(
        rng, ts, abundances=[1, 3, 5, 1], coverage=25, read_length=70,
        error_rate=error_rate,
    )
    b = pack_reads(reads, pad_length=96)
    ref = count_spectrum_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), k, 1 << 15, canonical,
        b.pad_length,
    )
    port = convert.spectrum_from_numpy(
        np.asarray(ref.hi), np.asarray(ref.lo), np.asarray(ref.count), int(ref.n)
    )
    return port, ref


def _assert_same(port, ref):
    hi, lo, count, n = convert.spectrum_to_numpy(port)
    assert n == int(ref.n)
    np.testing.assert_array_equal(hi, np.asarray(ref.hi))
    np.testing.assert_array_equal(lo, np.asarray(ref.lo))
    np.testing.assert_array_equal(count, np.asarray(ref.count))


@pytest.mark.parametrize("max_count", [8, 64, 1024])
def test_count_histogram_matches_reference(max_count):
    """K16's plain version == count_histogram; 1024 is the auto cut's
    width."""
    port, ref = _spectra(21)
    np.testing.assert_array_equal(
        tcor.count_histogram(port, max_count).numpy(),
        np.asarray(jcor.count_histogram(ref, max_count)),
    )


def test_count_histogram_runs_plain_on_cpu_and_bounds_max_count(monkeypatch):
    """On CPU tensors count_histogram is its plain version and reaches no
    kernel, and takes a max_count past K16's shared-memory bins (8,192) as
    the reference does (test_torch_kernels holds the kernel there)."""
    def no_library():
        raise AssertionError("a CPU histogram reached the kernel library")

    monkeypatch.setattr(kernels, "library", no_library)
    port, ref = _spectra(21)
    assert torch.equal(tcor.count_histogram(port, 1024), tcor.count_histogram_plain(port, 1024))
    wide = 8193
    np.testing.assert_array_equal(
        tcor.count_histogram(port, wide).numpy(), np.asarray(jcor.count_histogram(ref, wide))
    )


def _jax_spectrum(spec: Spectrum) -> JSpectrum:
    hi, lo = convert.key_to_hilo(spec.key)
    return JSpectrum(hi=jnp.asarray(hi), lo=jnp.asarray(lo),
                     count=jnp.asarray(spec.count.numpy()), n=jnp.int32(spec.n))


@pytest.mark.parametrize("case", CONTRACT_CASES + ["count1_heavy", "wide"])
@pytest.mark.parametrize("max_count", [1024, 65_536])
def test_count_histogram_contract_tables_match_reference(case, max_count):
    """K16's plain version == count_histogram on the Spectrum contract's
    edge tables (C twelve times n, n == C, n == 0 with C > 0, n above C)
    and on 2^20-lane tables of skewed counts from -3 up to 20,000 and
    100,000; and what K16 relies on: the counts of the real lanes
    count[:min(n, C)] alone, with no key read, give the same histogram."""
    if case in CONTRACT_CASES:
        spec = contract_case(case)[0]
    else:
        spec = _histogram_spectrum(case)
    want = np.asarray(jcor.count_histogram(_jax_spectrum(spec), max_count))
    np.testing.assert_array_equal(tcor.count_histogram(spec, max_count).numpy(), want)
    m = min(spec.n, spec.capacity)
    real = np.bincount(np.clip(spec.count[:m].numpy(), 0, max_count), minlength=max_count + 1)
    real[0] = 0
    np.testing.assert_array_equal(real, want)


def _k16_split(offset: int, n: int) -> list[int]:
    """numpy transcription of K16's split of count[0, n) at a view that
    starts `offset` int32 lanes past a 16-byte boundary: the scalar head up
    to the first boundary, whole 16-byte vectors, the scalar tail; the
    lanes each part reads, in order."""
    head = min((16 - 4 * offset) % 16 // 4, n)
    n4 = (n - head) >> 2
    tail = head + 4 * n4
    return list(range(head)) + list(range(head, tail)) + list(range(tail, n))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_k16_split_reads_each_real_lane_once(offset):
    for n in [0, 1, 2, 3, 4, 5, 7, 8, 9, 1023, 1_038_091]:
        assert _k16_split(offset, n) == list(range(n))


@pytest.mark.parametrize("side", ["sib", "ext"])
@pytest.mark.parametrize("k", [5, 16, 24, 31])
def test_probe_resolve_matches_reference(side, k):
    port, ref = _spectra(k)
    r_idx, r_hit = (np.asarray(x) for x in jcor._probe_resolve(ref, k, True, side))
    idx, hit = (x.numpy() for x in tcor.probe_resolve(port, k, True, side))
    n = port.n  # pad lanes carry no probes the decisions read
    np.testing.assert_array_equal(hit[:, :n], r_hit[:, :n])
    sel = r_hit[:, :n]
    np.testing.assert_array_equal(idx[:, :n][sel], r_idx[:, :n][sel])


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("min_abundance", [1, 2])
@pytest.mark.parametrize("error_rate", [0.0, 0.01])
def test_correct_spectrum_matches_reference(k, min_abundance, error_rate):
    port, ref = _spectra(k, seed=k)
    args = (k, min_abundance, 0.1, 8, True, error_rate)
    want = jcor.correct_spectrum(ref, *args)
    _assert_same(tcor.correct_spectrum(port, *args), want)


def test_correct_spectrum_strand_specific_matches_reference():
    port, ref = _spectra(21, seed=3, canonical=False)
    args = (21, 2, 0.1, 8, False, 0.01)
    _assert_same(tcor.correct_spectrum(port, *args), jcor.correct_spectrum(ref, *args))


def test_abundance_filter_only_matches_reference():
    port, ref = _spectra(21, seed=4)
    args = (21, 3, 0.0, 8, True, 0.01)  # sibling_ratio 0: filter only
    _assert_same(tcor.correct_spectrum(port, *args), jcor.correct_spectrum(ref, *args))


def test_auto_min_abundance_is_resolved_inside():
    """min_abundance=0 means auto in the port's correct_spectrum (the
    reference resolves it only in its pipeline)."""
    port, ref = _spectra(21, seed=5, error_rate=0.02)
    auto = choose_min_abundance(np.asarray(jcor.count_histogram(ref, 1024)))
    assert tcor.auto_min_abundance(port) == auto
    _assert_same(
        tcor.correct_spectrum(port, 21, 0, 0.1, 8, True, 0.01),
        jcor.correct_spectrum(ref, 21, auto, 0.1, 8, True, 0.01),
    )


def test_compact_keeps_order():
    port, _ = _spectra(15, seed=6)
    keep = torch.zeros(port.capacity, dtype=torch.bool)
    keep[: port.n : 3] = True
    out = tcor.compact(port, keep)
    assert out.n == int(keep.sum())
    assert torch.equal(out.key[: out.n], port.key[: port.n : 3])
    assert torch.equal(out.count[: out.n], port.count[: port.n : 3])


def _round_inputs(k: int, cut: int):
    """Both packages' probe tables and cut counts of one spectrum."""
    port, ref = _spectra(k, seed=k)
    jsib = jcor._probe_resolve(ref, k, True, "sib")
    jext = jcor._probe_resolve(ref, k, True, "ext")
    jraw, jcounts = jcor._cut_counts(ref, cut)
    tsib = tcor.probe_resolve(port, k, True, "sib")
    text = tcor.probe_resolve(port, k, True, "ext")
    traw, tcounts = tcor.cut_counts(port, cut)
    return (jcounts, jraw, jsib, jext), (tcounts, traw, tsib, text)


def _rounds(spec: str, k: int) -> int:
    return k + 2 if spec == "k+2" else int(spec)


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("cut", [1, 2])
@pytest.mark.parametrize("rounds", ["1", "2", "3", "k+2"])
def test_rescue_round_matches_reference(k, cut, rounds):
    """Up to `rounds` Jacobi rescue rounds (K8's plain version) ==
    _rescue_chunk(rounds=...), counts and the last round's changed flag;
    k + 2 is the oracle's cap, which correct_spectrum passes."""
    (jcounts, jraw, jsib, jext), (tcounts, traw, tsib, text) = _round_inputs(k, cut)
    r = _rounds(rounds, k)
    want, w_changed = jcor._rescue_chunk(jcounts, jraw, *jsib, *jext, rounds=r)
    before = tcounts.clone()
    got, changed = tcor.rescue_rounds(tcounts, traw, *tsib, *text, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert changed == bool(w_changed)
    assert torch.equal(tcounts, before)  # the input is never written


def _chain_table(k: int, canonical: bool, n_alive: int = 10, n_chain: int = 40):
    """Both packages' tables of one random sequence's k-mers: the first
    n_alive of count 5, then a chain of n_chain of count 1 running off the
    last alive one.  At cut 2 each chain k-mer is rescued one round after
    the one before it (its left extension), so the chain needs n_chain
    rounds, more than the cap k + 2."""
    rng = np.random.default_rng(k)
    seq = rng.integers(0, 4, n_alive + n_chain + k - 1)
    keys = []
    for i in range(n_alive + n_chain):
        v = 0
        for b in seq[i : i + k]:
            v = (v << 2) | int(b)
        keys.append(int(canonical_key(torch.tensor([v]), k)[0]) if canonical else v)
    counts = [5] * n_alive + [1] * n_chain
    assert len(set(keys)) == len(keys)
    order = np.argsort(keys)
    cap = 128
    key = np.full(cap, PAD, np.int64)
    key[: len(keys)] = np.asarray(keys, np.int64)[order]
    count = np.zeros(cap, np.int32)
    count[: len(keys)] = np.asarray(counts, np.int32)[order]
    port = Spectrum(key=torch.from_numpy(key), count=torch.from_numpy(count), n=len(keys))
    hi, lo = convert.key_to_hilo(key)
    ref = JSpectrum(hi=jnp.asarray(hi), lo=jnp.asarray(lo), count=jnp.asarray(count),
                    n=jnp.int32(len(keys)))
    return port, ref


def _chain_inputs(k: int, canonical: bool):
    port, ref = _chain_table(k, canonical)
    jsib = jcor._probe_resolve(ref, k, canonical, "sib")
    jext = jcor._probe_resolve(ref, k, canonical, "ext")
    tsib = tcor.probe_resolve(port, k, canonical, "sib")
    text = tcor.probe_resolve(port, k, canonical, "ext")
    return (*jcor._cut_counts(ref, 2), jsib, jext), (*tcor.cut_counts(port, 2), tsib, text)


@pytest.mark.parametrize("k", [16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_rescue_rounds_past_the_cap_match_reference(k, canonical):
    """A chain that needs more rounds than the cap: at k + 2 rounds the
    last round still rescues (changed stays True) and the chain's tail stays
    cut; with rounds to spare the whole chain comes back.  Both == the
    reference."""
    (jraw, jcounts, jsib, jext), (traw, tcounts, tsib, text) = _chain_inputs(k, canonical)
    for r in (k + 2, 64):
        want, w_changed = jcor._rescue_chunk(jcounts, jraw, *jsib, *jext, rounds=r)
        info = {}
        got, changed = tcor.rescue_rounds(tcounts, traw, *tsib, *text, r, info)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert changed == bool(w_changed) == (r == k + 2)
        assert info["rounds_run"] == min(r, 41) and info["rescued"][: min(r, 40)] == [1] * min(r, 40)


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_probe_relation_is_symmetric(k, canonical):
    """What K8's frontier rests on (csrc/rescue.cu): for every hit x -> y of
    a real lane in one probe family (siblings, extensions), y has a hit
    y -> x in the same family, on canonical and strand-specific tables."""
    port, _ = _spectra(k, canonical=canonical)
    n = port.n
    for side in ("sib", "ext"):
        idx, hit = (x.numpy() for x in tcor.probe_resolve(port, k, canonical, side))
        p, x = np.nonzero(hit[:, :n])
        y = idx[p, x]
        assert len(x) > n and (y < n).all()
        back = hit[:, y] & (idx[:, y] == x)
        assert back.any(0).all(), f"{int((~back.any(0)).sum())} one-way {side} hits"


def _frontier_rescue(counts, raw, sidx, shit, eidx, ehit, rounds: int, seed: int):
    """A numpy transcription of K8's schedule (csrc/rescue.cu): one state
    byte a lane (0 cut, 1 alive, t + 1 rescued in round t, 255 never), the
    rounds in place in a random lane order, round 1 over every lane and
    round t + 1 over the cut extension targets of round t's rescues, each
    listed once.  Returns (counts, last round's changed, frontier sizes)."""
    rng = np.random.default_rng(seed)
    C = counts.shape[0]
    state = np.full(C, 255, np.int64)
    state[(counts == 0) & (raw > 0)] = 0
    state[counts > 0] = 1
    out = counts.copy()
    frontier, sizes, changed = np.arange(C), [], True
    while changed and len(sizes) < rounds:
        t = len(sizes) + 1
        sizes.append(len(frontier))
        pushed, n_resc = {}, 0
        for i in rng.permutation(frontier):
            if state[i] != 0:
                continue
            ext = [bool(ehit[p, i]) and 1 <= state[eidx[p, i]] <= t for p in range(8)]
            sib = [bool(shit[p, i]) and 1 <= state[sidx[p, i]] <= t for p in range(8)]
            rext, lext, rsib, lsib = any(ext[0::2]), any(ext[1::2]), any(sib[0::2]), any(sib[1::2])
            if not ((lext and not rsib) or (rext and not lsib)):
                continue
            state[i], out[i] = t + 1, raw[i]
            n_resc += 1
            for p in range(8):
                if ehit[p, i] and state[eidx[p, i]] == 0:
                    pushed.setdefault(int(eidx[p, i]), None)
        frontier = np.fromiter(pushed, np.int64, len(pushed))
        changed = n_resc > 0
    return out, changed, sizes


@pytest.mark.parametrize("table", ["reads", "chain"])
@pytest.mark.parametrize("k", [16, 24, 31])
@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_schedule_matches_reference(table, k, seed):
    """The transcription of K8's frontier schedule == _rescue_chunk at 1, 3
    and k + 2 rounds, whatever the lane order (two seeds); after round 1 it
    evaluates a small fraction of the cut lanes."""
    if table == "reads":
        (jcounts, jraw, jsib, jext), _ = _round_inputs(k, 2)
    else:
        (jraw, jcounts, jsib, jext), _ = _chain_inputs(k, True)
    np_in = [np.asarray(x) for x in (jcounts, jraw, *jsib, *jext)]
    for r in (1, 3, k + 2):
        want, w_changed = jcor._rescue_chunk(jcounts, jraw, *jsib, *jext, rounds=r)
        got, changed, sizes = _frontier_rescue(*np_in, r, seed)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert changed == bool(w_changed)
    n_cut = int(((np_in[0] == 0) & (np_in[1] > 0)).sum())
    assert len(sizes) > 1 and max(sizes[1:]) < n_cut / 10


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("cut", [1, 2])
@pytest.mark.parametrize("error_rate", [0.0, 0.01])
def test_prune_round_matches_reference(k, cut, error_rate):
    """One Jacobi prune round (K9's plain version) == _prune_chunk(rounds=1)."""
    (jcounts, _, jsib, _), (tcounts, _, tsib, _) = _round_inputs(k, cut)
    eps3 = jnp.float32(error_rate) / jnp.float32(3.0)
    want, w_changed = jcor._prune_chunk(
        jcounts, *jsib, jnp.float32(0.1), eps3, rounds=1, use_cap=error_rate > 0
    )
    ratio, t_eps3 = tcor.prune_constants(0.1, error_rate)
    assert np.float32(t_eps3) == np.asarray(eps3) and np.float32(ratio) == np.float32(0.1)
    got, changed = tcor.prune_round(tcounts, *tsib, ratio, t_eps3, error_rate > 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert changed == bool(w_changed)


@pytest.mark.parametrize("k", [5, 24, 31])
@pytest.mark.parametrize("rounds", [0, 1, 2, 8])
@pytest.mark.parametrize("error_rate", [0.0, 0.01])
def test_prune_rounds_plain_matches_reference(k, rounds, error_rate):
    """K9's plain loop == _prune_chunk(rounds=...) from the cut counts,
    counts and the last round's changed flag (True at rounds 0, as the
    reference's loop returns); its info counts the rounds run and each
    one's pruned lanes, and no round after the first prunes any."""
    (jcounts, _, jsib, _), (tcounts, _, tsib, _) = _round_inputs(k, 2)
    eps3 = jnp.float32(error_rate) / jnp.float32(3.0)
    want, w_changed = jcor._prune_chunk(
        jcounts, *jsib, jnp.float32(0.1), eps3, rounds=rounds, use_cap=error_rate > 0
    )
    ratio, t_eps3 = tcor.prune_constants(0.1, error_rate)
    before, info = tcounts.clone(), {}
    got, changed = tcor.prune_rounds(tcounts, *tsib, ratio, t_eps3, error_rate > 0, rounds, info)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert changed == bool(w_changed)
    assert torch.equal(tcounts, before)  # the input is never written
    assert info["rounds_run"] == len(info["pruned"]) == min(rounds, 2)
    assert info["pruned"][1:] in ([], [0])
    if rounds:
        assert info["pruned"][0] == int((got != tcounts).sum()) > 0


def _arbitrary_round(seed: int, C: int = 3000):
    """A prune round's inputs with no structure: counts from 0 to 2^31 - 1
    (a quarter 0, most small, some near the top of int32), each lane's 8
    probe rows hit at random and pointing anywhere, so the sibling relation
    is not symmetric."""
    rng = np.random.default_rng(seed)
    counts = np.exp2(rng.uniform(0, 31, C)).astype(np.int64)
    counts = np.where(rng.random(C) < 0.5, counts % 64, counts)
    counts[rng.random(C) < 0.25] = 0
    counts[rng.integers(0, C, 20)] = (1 << 31) - 1
    idx = rng.integers(0, C, (8, C))
    hit = rng.random((8, C)) < 0.6
    return (torch.from_numpy(counts.clip(0, (1 << 31) - 1).astype(np.int32)),
            torch.from_numpy(idx), torch.from_numpy(hit))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("ratio", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("error_rate", [0.0, 0.01, 0.05])
def test_prune_fixpoint_after_one_round(seed, ratio, error_rate):
    """The argument K9's loop rests on (csrc/correction.cu): counts only
    fall, and both halves of the decision grow with the sibling maximum,
    so a second prune round on round 1's output changes nothing, on
    arbitrary non-symmetric tables, with and without the error cap."""
    counts, idx, hit = _arbitrary_round(seed)
    r, eps3 = tcor.prune_constants(ratio, error_rate)
    one, changed = tcor.prune_round_plain(counts, idx, hit, r, eps3, error_rate > 0)
    assert changed  # the table gives round 1 something to prune
    two, again = tcor.prune_round_plain(one, idx, hit, r, eps3, error_rate > 0)
    assert not again and torch.equal(two, one)
    got, last = tcor.prune_rounds(counts, idx, hit, r, eps3, error_rate > 0, 8)
    assert torch.equal(got, one) and not last


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("cut", [1, 2])
def test_compact_matches_reference(k, cut):
    """K10's plain version == _compact on a mask that keeps entries from
    all over the table."""
    port, ref = _spectra(k, seed=k)
    keep = (np.asarray(ref.count) >= cut) & (np.arange(port.capacity) % 3 != 0)
    keep &= np.arange(port.capacity) < port.n
    _assert_same(tcor.compact(port, torch.from_numpy(keep)), jcor._compact(ref, jnp.asarray(keep)))


@pytest.mark.parametrize("C", EDGE_SIZES)
@pytest.mark.parametrize("keep", ["all", "none", "random"])
def test_compact_plain_at_tile_edges_matches_reference(C, keep):
    """K10's plain version == _compact at the sizes that pin the
    single-pass scan's tile edges (K10's cuda tests use the same inputs):
    every lane kept, none, or 30% of the real lanes."""
    keys, counts, mask = keep_case(C, keep)
    hi, lo = convert.key_to_hilo(keys)
    ref = JSpectrum(hi=jnp.asarray(hi), lo=jnp.asarray(lo), count=jnp.asarray(counts),
                    n=jnp.int32(int((keys != PAD).sum())))
    port = Spectrum(key=torch.from_numpy(keys), count=torch.from_numpy(counts), n=C)
    _assert_same(tcor.compact(port, torch.from_numpy(mask)), jcor._compact(ref, jnp.asarray(mask)))


@pytest.mark.parametrize("error_rate", [0.01, 0.02])
def test_prune_round_float_edges_match_reference(error_rate):
    """Counts 1..64 against sibling maxima 1..4095: c equal to
    f32(0.1) * max (c = 1, max = 10) or just off it, and maxima whose
    lam = eps3 * max puts the error cap where float32 rounding decides
    (c = 6 at max 300 for 0.01 and max 150 for 0.02, where float64 decides
    otherwise; c = 33 at max 2400 and c = 46 at max 3750 for 0.02, where a
    square root one ulp low decides otherwise).  The plain K9 round equals
    the reference's and an independent numpy float32 evaluation."""
    counts, idx, hit, c, m = prune_grid(64)
    ratio, eps3 = tcor.prune_constants(0.1, error_rate)
    f = np.float32
    F = m.astype(f)
    lam = f(eps3) * F
    cap = np.maximum(f(3), (lam + f(4) * np.sqrt(lam)) + f(1))
    doomed = (c.astype(f) < f(ratio) * F) & (c.astype(f) <= cap)
    cap64 = np.maximum(3, error_rate / 3 * m + 4 * np.sqrt(error_rate / 3 * m) + 1)
    assert ((c <= cap64) != (c.astype(f) <= cap)).any()  # float32 rounding decides some lanes
    assert (c.astype(f) == f(ratio) * F).any()  # and some lanes sit on the ratio
    want = np.concatenate([counts[:4095], np.where(doomed, 0, c)])
    got, changed = tcor.prune_round(
        torch.from_numpy(counts), torch.from_numpy(idx), torch.from_numpy(hit), ratio, eps3, True
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert changed
    ref, _ = jcor._prune_chunk(
        jnp.asarray(counts), jnp.asarray(idx.astype(np.int32)), jnp.asarray(hit),
        jnp.float32(0.1), jnp.float32(error_rate) / jnp.float32(3.0), rounds=1, use_cap=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cut", [0, 1, 2, 5])
def test_cut_counts_matches_reference(cut):
    """K20's cut mode == _cut_counts: (raw, counts after the cut)."""
    port, ref = _spectra(24, seed=9)
    want = [np.asarray(x) for x in jcor._cut_counts(ref, cut)]
    got = tcor.cut_counts(port, cut)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    assert torch.equal(got[1], tcor.cut_counts_plain(port, cut)[1])


@pytest.mark.parametrize("min_abundance", [0, 1, 2, 3])
def test_abundance_filter_matches_reference(min_abundance):
    port, ref = _spectra(24, seed=10)
    got = tcor.abundance_filter(port, min_abundance)
    _assert_same(got, jcor.abundance_filter(ref, min_abundance))
    assert got.n == int((port.count[: port.n] >= min_abundance).sum())


# csrc/correction.cu: a block of abundance_cut_kernel (256 threads x 16
# lanes), and the compaction tile's geometry (scan.cuh: 256 threads x 16
# lanes), with a small one of many tiles
CUT_THREADS, CUT_LANES = 256, 16
K20_GEOMETRIES = {"source": (256, 16), "small": (4, 16)}


def k20_cut_transcription(count: np.ndarray, n_real: int, m: int, offset: int = 0):
    """numpy transcription of abundance_cut_kernel: blocks of 4,096 lanes.
    Where count (a view `offset` lanes past a 16-byte boundary) and the
    outputs are aligned and the block is whole, quad q of thread t is the 4
    lanes from base + 4 (256 q + t), loaded as one 16-byte load where its
    first lane is below n_real (lanes past n_real zeroed).  Else lane by
    lane below n_real.  No key is read.  Returns (raw, cut, the lanes
    read)."""
    C = count.shape[0]
    raw, cut = np.empty(C, np.int32), np.empty(C, np.int32)
    read = np.zeros(C, bool)
    tile = CUT_THREADS * CUT_LANES
    t = np.arange(CUT_THREADS)
    for base in range(0, C, tile):
        if offset % 4 == 0 and base + tile <= C:
            groups = base + 4 * (np.arange(4)[:, None] * CUT_THREADS + t)[..., None] \
                + np.arange(4)
            groups = groups.reshape(-1, 4)
            loaded = groups[:, 0] < n_real
            c = np.where(loaded[:, None], count[groups], 0)
            read[groups[loaded]] = True
            c = np.where(groups < n_real, c, 0)
            lanes = groups.reshape(-1)
            c = c.reshape(-1)
        else:
            lanes = np.arange(base, min(base + tile, C))
            c = np.where(lanes < n_real, count[lanes], 0)
            read[lanes[lanes < n_real]] = True
        raw[lanes] = c
        cut[lanes] = np.where(c < m, 0, c)
    return raw, cut, read


def k20_filter_transcription(key: np.ndarray, count: np.ndarray, n_real: int, m: int,
                             threads: int = 256, items: int = 16, offset: int = 0):
    """numpy transcription of the abundance filter on CUDA
    (filter_count_kernel on K10's compaction tile, then scan_fill_tail):
    tiles of threads x items lanes over [0, n_real) alone; a thread's keep
    bits count >= m from one 16-byte load a 4 lanes where its lanes are
    below n_real and aligned, else lane by lane below n_real; the block's
    exclusive scan of the bits' counts; each tile's prefix, the earlier
    tiles' kept lanes (the look-back); the kept lanes' keys and counts out
    in lane order; PAD / 0 from n on.  Returns (key, count, n) and asserts
    each output lane is written once."""
    C, tile = key.shape[0], threads * items
    out_key, out_count = np.empty(C, np.int64), np.empty(C, np.int32)
    written = np.zeros(C, np.int64)
    prefix = 0
    for base in range(0, n_real, tile):
        firsts = base + items * np.arange(threads)
        lanes = firsts[:, None] + np.arange(items)
        vec = (firsts + items <= n_real) & ((offset + firsts) % 4 == 0)
        safe = np.minimum(lanes, C - 1)
        bits = np.where(vec[:, None], count[safe] >= m,
                        (lanes < n_real) & (count[safe] >= m))
        per_thread = bits.sum(1)
        r = np.cumsum(per_thread) - per_thread  # the block's exclusive scan
        kept = int(per_thread.sum())
        s_lane = np.empty(kept, np.int64)
        for t in range(threads):
            s_lane[r[t]:r[t] + per_thread[t]] = lanes[t][bits[t]] - base
        slots = prefix + np.arange(kept)
        out_key[slots] = key[base + s_lane]
        out_count[slots] = count[base + s_lane]
        written[slots] += 1
        prefix += kept
    out_key[prefix:], out_count[prefix:] = PAD, 0
    written[prefix:] += 1
    assert (written == 1).all()
    return out_key, out_count, prefix


def _k20_check(spec: Spectrum, m: int, offset: int = 0, geometry: str = "source") -> None:
    """K20's transcriptions == abundance_cut_plain / cut_counts /
    abundance_filter on the CPU == _cut_counts / abundance_filter of the
    reference, for a table under the contract."""
    n_real = min(spec.n, spec.capacity)
    key, count = spec.key.numpy(), spec.count.numpy()
    plain = tcor.abundance_cut_plain(spec, m)
    raw, cut, read = k20_cut_transcription(count, n_real, m, offset)
    assert read[:n_real].all() and not read[-(-n_real // 4) * 4:].any()
    for got, want in zip((raw, cut), plain):
        np.testing.assert_array_equal(got, want.numpy())
    for got, want in zip((raw, cut), tcor.cut_counts(spec, m)):
        np.testing.assert_array_equal(got, want.numpy())
    ref = _jax_spectrum(spec)
    for got, want in zip((raw, cut), jcor._cut_counts(ref, m)):
        np.testing.assert_array_equal(got, np.asarray(want))
    f_key, f_count, f_n = k20_filter_transcription(key, count, n_real, m,
                                                   *K20_GEOMETRIES[geometry], offset)
    port = tcor.abundance_filter(spec, m)
    assert f_n == port.n == int(plain[2].sum())
    np.testing.assert_array_equal(f_key, port.key.numpy())
    np.testing.assert_array_equal(f_count, port.count.numpy())
    want = jcor.abundance_filter(ref, m)
    assert f_n == int(want.n)
    np.testing.assert_array_equal(f_key, convert.hilo_to_key(np.asarray(want.hi),
                                                             np.asarray(want.lo)))
    np.testing.assert_array_equal(f_count, np.asarray(want.count))


@pytest.mark.parametrize("n_real", K20_N_REAL)
@pytest.mark.parametrize("m", K20_CUTS)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("geometry", list(K20_GEOMETRIES))
def test_k20_transcription_matches_plain_and_reference(n_real, m, offset, geometry):
    """K20's cut mode and the count-predicate compaction on tables whose real
    lanes end inside a group of 16 (n_real mod 4 != 0), on a tile edge and
    beside it, fill the table (C = 8,195, not a multiple of 16), or are
    none; read from an aligned table and from a view one lane past a
    16-byte boundary (every load lane by lane)."""
    _k20_check(cut_table(n_real, offset), m, offset, geometry)


_PRODUCED: dict = {}


@pytest.mark.parametrize("producer", CONTRACT_PRODUCERS)
@pytest.mark.parametrize("m", [0, 1, 2, "above"])
def test_k20_transcription_on_contract_producers(producer, m):
    """K20's transcriptions on the table of every producer of the Spectrum
    contract (tests/test_torch_count.py), overflowed tables included, at a
    cut of 0, 1, 2 and one above the table's largest count."""
    if producer not in _PRODUCED:
        _PRODUCED[producer] = _contract_producer(producer)
    spec = _PRODUCED[producer]
    if m == "above":
        m = int(spec.count.max()) + 1
    _k20_check(spec, m)


def k23_decision(count: np.ndarray, rmax: np.ndarray, lmax: np.ndarray, ratio: float):
    """numpy transcription of prune_kept: kept iff neither f32(count) <
    f32(ratio) * f32(rmax) nor f32(count) < f32(ratio) * f32(lmax), each
    product one rounded float32 multiply (no FMA)."""
    f, r = count.astype(np.float32), np.float32(ratio)
    return ~((f < r * rmax.astype(np.float32)) | (f < r * lmax.astype(np.float32)))


def k23_prune_filter_transcription(key, count, rmax, lmax, n_real: int, ratio: float,
                                   threads: int = 256, items: int = 16, offset: int = 0):
    """numpy transcription of sibling_prune_round's compaction on CUDA
    (prune_filter_kernel on K10's compaction tile, then scan_fill_tail),
    given rmax and lmax of the real lanes (n_real each): tiles of threads x
    items lanes over [0, n_real) alone; a thread's keep bits are K23's
    decision (k23_decision) of its lanes, from one 16-byte load of count,
    rmax and lmax a 4 lanes where its lanes are below n_real and aligned
    (count a view `offset` lanes past a 16-byte boundary, the maxima
    aligned), else lane by lane below n_real; the block's exclusive scan of
    the bits' counts; each tile's prefix, the earlier tiles' kept lanes (the
    look-back); the kept lanes' keys and counts out in lane order; PAD / 0
    from n on.  Returns (key, count, n) and asserts that each output lane is
    written once, that no lane at or past n_real is read, and that no key
    but a kept lane's is read."""
    C, tile = key.shape[0], threads * items
    assert len(rmax) == len(lmax) == n_real
    r_all, l_all = np.zeros(C, np.int32), np.zeros(C, np.int32)  # never read past n_real
    r_all[:n_real], l_all[:n_real] = rmax, lmax
    out_key, out_count = np.empty(C, np.int64), np.empty(C, np.int32)
    written = np.zeros(C, np.int64)
    read, key_read, kept_lanes = np.zeros(C, bool), np.zeros(C, bool), np.zeros(C, bool)
    prefix = 0
    for base in range(0, n_real, tile):
        firsts = base + items * np.arange(threads)
        lanes = firsts[:, None] + np.arange(items)
        vec = (firsts + items <= n_real) & ((offset + firsts) % 4 == 0)
        live = np.where(vec[:, None], True, lanes < n_real)
        read[lanes[live]] = True
        safe = np.minimum(lanes, C - 1)
        bits = live & k23_decision(count[safe], r_all[safe], l_all[safe], ratio)
        per_thread = bits.sum(1)
        r = np.cumsum(per_thread) - per_thread  # the block's exclusive scan
        kept = int(per_thread.sum())
        s_lane = np.empty(kept, np.int64)
        for t in range(threads):
            s_lane[r[t]:r[t] + per_thread[t]] = lanes[t][bits[t]] - base
        slots = prefix + np.arange(kept)
        out_key[slots] = key[base + s_lane]
        out_count[slots] = count[base + s_lane]
        key_read[base + s_lane] = kept_lanes[base + s_lane] = True
        written[slots] += 1
        prefix += kept
    out_key[prefix:], out_count[prefix:] = PAD, 0
    written[prefix:] += 1
    assert (written == 1).all()
    assert not read[n_real:].any() and not (key_read & ~kept_lanes).any()
    return out_key, out_count, prefix


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.5])
def test_k23_transcription_matches_reference(k, canonical, ratio):
    """The sibling-prune round on CUDA, transcribed: K22 over the real
    lanes (k22_transcription, its maxima of those lanes alone), then K23's
    decision as the predicate of one compaction over [0, min(n, C)) at the
    source's tile (256 x 16) and a small one (4 x 16), from an aligned
    count and from one a lane past a 16-byte boundary; equal to the JAX
    package's sibling_prune_round and to the port's CPU round on k22_tables
    (n < C, n == C, n == 1, n == 0, n > C, palindromes at even k).  At ratio
    0 every real lane stays."""
    from test_torch_search import k22_transcription

    ratio32, _ = tcor.prune_constants(ratio, 0.0)
    for name, spec in k22_tables(k, canonical).items():
        n_real = min(spec.n, spec.capacity)
        key, count = spec.key.numpy(), spec.count.numpy()
        rmax, lmax, _walks = k22_transcription(key, count, n_real, k, canonical)
        want = jcor.sibling_prune_round(_jax_spectrum(spec), k, jnp.float32(ratio), canonical)
        want_key = convert.hilo_to_key(np.asarray(want.hi), np.asarray(want.lo))
        port = tcor.sibling_prune_round(spec, k, ratio, canonical)
        assert port.n == int(want.n), name
        if ratio == 0.0:
            assert port.n == n_real, name
        for geometry in K20_GEOMETRIES.values():
            for offset in (0, 1):
                got = k23_prune_filter_transcription(key, count, rmax[:n_real], lmax[:n_real],
                                                     n_real, ratio32, *geometry, offset)
                assert got[2] == port.n, (name, geometry, offset)
                np.testing.assert_array_equal(got[0], want_key, err_msg=name)
                np.testing.assert_array_equal(got[1], np.asarray(want.count), err_msg=name)
                np.testing.assert_array_equal(got[0], port.key.numpy(), err_msg=name)
                np.testing.assert_array_equal(got[1], port.count.numpy(), err_msg=name)


@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.5])
def test_k23_decision_on_the_float_grid(ratio):
    """K23's decision, transcribed, == prune_keep_plain on the float grid
    of its cuda test (counts 0..255 against maxima 0..4095), where the
    float32 products decide lanes that exact products would decide
    otherwise; and the compaction of the grid's first tiles == the plain
    filter's there."""
    spec, rmax, lmax, ratio32 = k23_float_grid(ratio)
    n = spec.n
    count, r, l = spec.count.numpy(), rmax.numpy(), lmax.numpy()
    got = k23_decision(count[:n], r[:n], l[:n], ratio32)
    want = tcor.prune_keep_plain(spec, rmax, lmax, ratio32).numpy()
    np.testing.assert_array_equal(got, want[:n])
    assert not want[n:].any() and got.any() and not got.all()
    # the products of the same float32 values, unrounded (exact in float64)
    exact = ~((count[:n] < ratio32 * r[:n].astype(np.float64))
              | (count[:n] < ratio32 * l[:n].astype(np.float64)))
    if ratio != 0.5:  # halving is exact in float32
        assert (exact != got).any()
    lanes = 3 * 4096 + 5
    head = Spectrum(key=spec.key[:lanes].clone(), count=spec.count[:lanes].clone(), n=lanes)
    f_key, f_count, f_n = k23_prune_filter_transcription(
        head.key.numpy(), head.count.numpy(), r[:lanes], l[:lanes], lanes, ratio32)
    plain = tcor.prune_filter_plain(head, rmax[:lanes], lmax[:lanes], ratio32)
    assert f_n == plain.n
    np.testing.assert_array_equal(f_key, plain.key.numpy())
    np.testing.assert_array_equal(f_count, plain.count.numpy())


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.5])
def test_sibling_prune_round_matches_reference(k, canonical, ratio):
    """One round: K22's sibling maxima, K23's keep flags, compaction."""
    port, ref = _spectra(k, seed=k + 20, canonical=canonical)
    want = jcor.sibling_prune_round(ref, k, jnp.float32(ratio), canonical)
    _assert_same(tcor.sibling_prune_round(port, k, ratio, canonical), want)
    if ratio == 0.0:
        assert int(want.n) == port.n  # nothing is below 0 x its siblings
    else:
        assert int(want.n) < port.n


def _zero_count_table(canonical: bool):
    """k = 5, both packages: a real lane of count 0 whose right sibling has
    count 5 (doomed by any positive ratio), a real lane of count 0 with no
    sibling in the table (kept: 0 < ratio x 0 is false), and lanes of
    counts 1 and 3; keys canonical when `canonical`."""
    k = 5

    def orient(v: int) -> int:
        return int(canonical_key(torch.tensor([v]), k)[0]) if canonical else v

    x = orient(0b0110110100)
    probes = probe_keys(torch.tensor([x]), k, "sib", canonical)[0::2, 0].tolist()
    sib = next(p for p in probes if p != x)
    keys = [x, sib, orient(0b1111000011), orient(0b0001111000), orient(0b0100000110)]
    counts = [0, 5, 0, 1, 3]
    assert len(set(keys)) == len(keys)
    order = np.argsort(keys)
    cap = 16
    key = np.full(cap, PAD, np.int64)
    key[: len(keys)] = np.asarray(keys, np.int64)[order]
    count = np.zeros(cap, np.int32)
    count[: len(keys)] = np.asarray(counts, np.int32)[order]
    port = Spectrum(key=torch.from_numpy(key), count=torch.from_numpy(count), n=len(keys))
    hi, lo = convert.key_to_hilo(key)
    ref = JSpectrum(hi=jnp.asarray(hi), lo=jnp.asarray(lo), count=jnp.asarray(count),
                    n=jnp.int32(len(keys)))
    return k, port, ref


@pytest.mark.parametrize("canonical", [True, False])
def test_count_zero_lanes_match_reference(canonical):
    """Hazard 1 of K23: no count > 0 guard, so a real lane of count 0
    beside a positive sibling is dropped; K20's keep at min_abundance 0
    keeps real lanes of count 0, which counts > 0 would not."""
    k, port, ref = _zero_count_table(canonical)
    got = tcor.sibling_prune_round(port, k, 0.1, canonical)
    _assert_same(got, jcor.sibling_prune_round(ref, k, jnp.float32(0.1), canonical))
    assert 0 in got.count[: got.n].tolist() and got.n < port.n
    kept = tcor.abundance_filter(port, 0)
    _assert_same(kept, jcor.abundance_filter(ref, 0))
    assert kept.n == port.n
