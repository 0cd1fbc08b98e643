"""Port parity: connected components of the contig graph and the
component-scheduled back half (MB + SF + enumeration) against
shannon_tpu.ops.partition / shannon_tpu.parallel.components on JAX-CPU,
from the same ContigArrays (via convert).

Tolerance: exact — component labels and lists equal, transcript lists
equal (sequence and abundance)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.condense import build_contig_arrays, to_contig_graph
from shannon_tpu.ops.count import count_spectrum_packed
from shannon_tpu.ops.partition import bucket_components as ref_buckets
from shannon_tpu.ops.partition import connected_components as ref_cc
from shannon_tpu.oracle.nodegraph import NodeGraph
from shannon_tpu.parallel.components import assemble_components as ref_assemble
from shannon_tpu.parallel.components import device_components as ref_components
from shannon_tpu.sim import sample_reads, simulate_gene_isoforms, simulate_transcripts
from shannon_tpu.utils.timing import StageTimer
from shannon_tpu_torch import components as tcomp
from shannon_tpu_torch import convert
from shannon_tpu_torch.ops import partition as tpart
from shannon_tpu_torch.pipeline import _thread_device


def _graphs(seed: int):
    rng = np.random.default_rng(seed)
    ts, _ = simulate_gene_isoforms(rng, n_genes=4)
    ts += simulate_transcripts(rng, n=3, length=300)
    reads = sample_reads(rng, ts, coverage=20, read_length=70, error_rate=0.0)
    cfg = AssemblyConfig(k=21, batch_reads=512)
    b = pack_reads(reads, pad_length=96)
    spec = count_spectrum_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), 21, 1 << 15, True, b.pad_length
    )
    ref_ca = build_contig_arrays(spec, 21)
    port_ca = convert.contig_arrays_from_numpy(*(np.asarray(x) for x in ref_ca.tree_flatten()[0]))
    return cfg, b, ref_ca, port_ca


@pytest.mark.parametrize("seed", [1, 2])
def test_components_match_reference(seed):
    _cfg, _b, ref_ca, port_ca = _graphs(seed)
    np.testing.assert_array_equal(tpart.connected_components(port_ca), ref_cc(ref_ca))
    comps = tcomp.device_components(port_ca)
    assert comps == ref_components(ref_ca)
    assert len(comps) > 1


def test_bucket_components_matches_reference():
    sizes = [1, 3, 70, 2, 16, 17, 300, 64]
    for edges in [(1, 2, 4, 8, 16, 32, 64), (1, 2, 4, 16, 64, 256)]:
        assert tpart.bucket_components(sizes, edges) == ref_buckets(sizes, edges)


def test_assemble_components_matches_reference():
    cfg, b, ref_ca, port_ca = _graphs(3)
    cg = to_contig_graph(ref_ca, 21, cfg)
    evidence = _thread_device(b, port_ca, cg, cfg, torch.device("cpu"), StageTimer(echo=False))
    comps = tcomp.device_components(port_ca)

    def run(fn):
        g = NodeGraph.from_contig_graph(cg)
        g.set_paths_flat(*evidence)
        ts, n_mb, n_sf, trunc, _ = fn(g, comps, cfg)
        return [(t.seq, t.abundance) for t in ts], n_mb, n_sf, trunc

    got, want = run(tcomp.assemble_components), run(ref_assemble)
    assert got == want
    assert got[2] > 0  # sparse flow split X-nodes
