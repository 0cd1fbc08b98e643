"""Port parity: error correction (histogram, probe tables, rescue and
error-capped prune rounds) against shannon_tpu.ops.correction on JAX-CPU.
Both packages start from the same counted spectrum (via convert).

Tolerance: exact — corrected keys and counts equal over the whole table;
probe tables equal on real lanes where hit (idx is a contract only
there)."""

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
@pytest.mark.parametrize("k", [16, 24])
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
    _assert_same(tcor.correct_spectrum(port, *args), jcor.correct_spectrum(ref, *args))


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
