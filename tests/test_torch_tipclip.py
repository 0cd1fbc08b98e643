"""Port parity: tip clipping (condensation, host clip rounds, drop of
doomed k-mers, renumbering of the node table) against
shannon_tpu.ops.tipclip.clip_tips_graph and its spectrum-only view
clip_tips_spectrum on JAX-CPU, from the same corrected spectrum; and the
drop and the renumbering alone (the plain versions of K18 and K19)
against _drop_contigs and _device_clip_remap on the same inputs.

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
from test_torch_kernels import remap_args_of_clip


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
