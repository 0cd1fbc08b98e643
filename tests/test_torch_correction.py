"""Port parity: error correction (histogram, probe tables, one rescue
round, one error-capped prune round, compaction, the whole stage) against
shannon_tpu.ops.correction on JAX-CPU.  Both packages start from the same
counted spectrum (via convert).  The plain versions run here (CPU tensors);
tests/test_torch_kernels.py holds kernels K7-K10 against them on the card.

Tolerance: exact — corrected keys and counts equal over the whole table;
probe tables equal on real lanes where hit (idx is a contract only
there); round outputs and their changed flags equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops import correction as jcor
from shannon_tpu.ops.count import count_spectrum_packed
from shannon_tpu.oracle.correction import choose_min_abundance
from shannon_tpu.sim import sample_reads, simulate_isoforms, simulate_transcripts
from shannon_tpu_torch import convert
from shannon_tpu_torch.ops import correction as tcor
from test_torch_kernels import prune_grid


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


@pytest.mark.parametrize("max_count", [8, 64])
def test_count_histogram_matches_reference(max_count):
    port, ref = _spectra(21)
    np.testing.assert_array_equal(
        tcor.count_histogram(port, max_count).numpy(),
        np.asarray(jcor.count_histogram(ref, max_count)),
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


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("cut", [1, 2])
def test_rescue_round_matches_reference(k, cut):
    """One Jacobi rescue round (K8's plain version) == _rescue_chunk(rounds=1)."""
    (jcounts, jraw, jsib, jext), (tcounts, traw, tsib, text) = _round_inputs(k, cut)
    want, w_changed = jcor._rescue_chunk(jcounts, jraw, *jsib, *jext, rounds=1)
    before = tcounts.clone()
    got, changed = tcor.rescue_round(tcounts, traw, *tsib, *text)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert changed == bool(w_changed)
    assert torch.equal(tcounts, before)  # Jacobi: the round writes a new buffer


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
