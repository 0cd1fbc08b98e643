"""Port parity: read threading (K1 forward keys + K3 node lookup, run scan,
row compaction), the across-read compaction and the single-end evidence
driver, against shannon_tpu.ops.thread and the single-end branch of
shannon_tpu.pipeline._thread_device on JAX-CPU.  Both packages thread
through the same ContigArrays (via convert).

Tolerance: exact — every output array equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops import thread as jth
from shannon_tpu.ops.condense import build_contig_arrays, to_contig_graph
from shannon_tpu.ops.correction import correct_spectrum
from shannon_tpu.ops.count import count_spectrum_packed
from shannon_tpu.pipeline import _thread_device as ref_thread_device
from shannon_tpu.sim import sample_reads, simulate_isoforms, simulate_transcripts
from shannon_tpu.utils.timing import StageTimer
from shannon_tpu_torch import convert
from shannon_tpu_torch.ops import thread as tth
from shannon_tpu_torch.ops.condense import to_contig_graph as port_contig_graph
from shannon_tpu_torch.pipeline import _thread_device


def _setup(k: int, seed: int, strand_specific: bool = False, with_n: bool = False):
    rng = np.random.default_rng(seed)
    ts = simulate_transcripts(rng, n=2, length=300) + simulate_isoforms(rng, exon_length=120)
    reads = sample_reads(rng, ts, coverage=15, read_length=70, error_rate=0.01)
    if with_n:
        reads = [r[:30] + "N" + r[31:] if i % 7 == 0 else r for i, r in enumerate(reads)]
    cfg = AssemblyConfig(k=k, strand_specific=strand_specific, batch_reads=256)
    b = pack_reads(reads, pad_length=96)
    canonical = not strand_specific
    spec = count_spectrum_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), k, 1 << 15, canonical, b.pad_length,
        None if b.mask is None else jnp.asarray(b.mask),
    )
    spec = correct_spectrum(spec, k, 1, 0.1, 8, canonical, error_rate=0.01)
    ref_ca = build_contig_arrays(spec, k, canonical)
    port_ca = convert.contig_arrays_from_numpy(*(np.asarray(x) for x in ref_ca.tree_flatten()[0]))
    return cfg, b, ref_ca, port_ca


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("with_n", [False, True])
def test_thread_reads_matches_reference(k, with_n):
    cfg, b, ref_ca, port_ca = _setup(k, seed=k, with_n=with_n)
    mask = b.mask
    ref = jth.thread_reads_device_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), ref_ca, k, b.pad_length,
        None if mask is None else jnp.asarray(mask),
    )
    port = tth.thread_reads_device_packed(
        torch.from_numpy(b.words.view(np.int32)), torch.from_numpy(b.lengths), port_ca, k,
        b.pad_length, None if mask is None else torch.from_numpy(mask.view(np.int32)),
    )
    names = "ev_cid ev_run n_events run_p0 run_p1 run_o0 run_o1".split()
    for name, p, r in zip(names, port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)

    # across-read compaction: the reference's flat arrays up to its totals
    r_comp = jth.compact_thread_outputs(*ref)
    tot_e, tot_r = (int(x) for x in np.asarray(r_comp[-1]))
    p_comp = tth.compact_thread_outputs(*port)
    for j, p in enumerate(p_comp[:6]):
        tot = tot_e if j < 2 else tot_r
        np.testing.assert_array_equal(p.numpy(), np.asarray(r_comp[j])[:tot])
    np.testing.assert_array_equal(p_comp[6].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(p_comp[7].numpy(), np.asarray(r_comp[6]))


@pytest.mark.parametrize("strand_specific", [False, True])
@pytest.mark.parametrize("rescue", [True, False])
def test_single_end_evidence_matches_reference(strand_specific, rescue):
    cfg, b, ref_ca, port_ca = _setup(21, seed=3, strand_specific=strand_specific)
    cfg = AssemblyConfig(
        k=21, strand_specific=strand_specific, batch_reads=256, rescue_reads=rescue
    )
    ref_g = to_contig_graph(ref_ca, 21, cfg)
    port_g = port_contig_graph(port_ca, 21, cfg)
    ref_ev = ref_thread_device(b, ref_ca, ref_g, cfg)
    port_ev = _thread_device(b, port_ca, port_g, cfg, torch.device("cpu"), StageTimer(echo=False))
    for p, r in zip(port_ev, ref_ev):
        np.testing.assert_array_equal(p, r)
    assert len(port_ev[2]) > 0


def test_rect_rebuilds_rows():
    flat = np.array([5, 6, 7, 8, 9])
    out = tth.rect(flat, np.array([2, 0, 3]), 4)
    assert out.tolist() == [[5, 6, -1, -1], [-1, -1, -1, -1], [7, 8, 9, -1]]
