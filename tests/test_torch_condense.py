"""Port parity: condensation (node table, group-join links, pointer-doubling
labels with cycle cuts, per-contig reduction, base streams and the host
ContigGraph) against shannon_tpu.ops.condense on JAX-CPU.  Both packages
condense the same spectrum (via convert).

Tolerance: exact — every ContigArrays array equal over its full capacity
(abundances bitwise), contig sequences and graphs equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops import condense as jcd
from shannon_tpu.ops.count import count_spectrum_packed
from shannon_tpu.sim import random_seq, sample_reads, simulate_isoforms, simulate_transcripts
from shannon_tpu_torch import convert
from shannon_tpu_torch.ops import condense as tcd

CASES = {
    "multi": lambda rng: simulate_transcripts(rng, n=3, length=250),
    "isoforms": lambda rng: simulate_isoforms(rng, exon_length=120),
    "repeat": lambda rng: (
        lambda a, b, c, d, r: [a + r + b, c + r + d]
    )(*simulate_transcripts(rng, n=4, length=150), random_seq(rng, 60)),
    "cycle": lambda rng: [random_seq(rng, 50) * 4],  # tandem repeat -> cycle
    "homopolymer": lambda rng: ["A" * 120],  # self-loop k-mer
}


def _spectra(case: str, k: int, canonical: bool = True, error_rate: float = 0.0):
    rng = np.random.default_rng(len(case) * 31 + k)
    ts = CASES[case](rng)
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
