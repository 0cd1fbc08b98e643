"""Port parity: error correction (histogram, abundance cut, probe tables,
the rescue rounds, one error-capped prune round, compaction, the whole
stage, and the single-round steps abundance_filter and sibling_prune_round)
against shannon_tpu.ops.correction on JAX-CPU, and a transcription of K8's
frontier schedule with the probe symmetry it rests on.  Both packages start from
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
from test_torch_kernels import EDGE_SIZES, keep_case, prune_grid


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
    kernel, so it takes a max_count past K16's limit as the reference does
    (the CUDA wrapper raises there; test_torch_kernels holds that)."""
    def no_library():
        raise AssertionError("a CPU histogram reached the kernel library")

    monkeypatch.setattr(kernels, "library", no_library)
    port, ref = _spectra(21)
    assert torch.equal(tcor.count_histogram(port, 1024), tcor.count_histogram_plain(port, 1024))
    wide = tcor.HISTOGRAM_MAX_COUNT + 1
    np.testing.assert_array_equal(
        tcor.count_histogram(port, wide).numpy(), np.asarray(jcor.count_histogram(ref, wide))
    )


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
