"""Port parity: tip clipping (condensation, host clip rounds, drop of
doomed k-mers, renumbering of the node table) against
shannon_tpu.ops.tipclip.clip_tips_graph on JAX-CPU, from the same
corrected spectrum.

Tolerance: exact — clipped spectrum and post-clip ContigArrays equal over
their full capacity."""

import numpy as np
import pytest

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.correction import correct_spectrum
from shannon_tpu.ops.count import count_spectrum_packed
from shannon_tpu.ops.tipclip import clip_tips_graph as ref_clip
from shannon_tpu.sim import random_seq, sample_reads, simulate_gene_isoforms, simulate_transcripts
from shannon_tpu_torch import convert
from shannon_tpu_torch.ops.tipclip import clip_tips_graph

from test_torch_condense import assert_contig_arrays_equal


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


def test_clip_disabled_returns_input():
    cfg = AssemblyConfig(k=21, tip_klen=-1)
    port, _ = _corrected(cfg, seed=12, error_rate=0.01)
    spec, ca = clip_tips_graph(port, cfg)
    assert spec is port and ca is None
