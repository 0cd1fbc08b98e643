"""Port parity: paired-end assembly.  The port's assemble(paired=True,
device="cpu") against shannon_tpu.pipeline.assemble(backend="device",
paired=True) on JAX-CPU and against the pure-Python oracle, on the datasets
of tests/test_paired.py; the paired evidence of the threading driver; the
paired ingest routes (memory vs files, port vs reference).

Tolerance: exact — the same transcript list (order and abundances
included) and stats as the reference device path, the same canonical set
as the oracle, equal evidence arrays, identical packed batches."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.dna import revcomp_str
from shannon_tpu.io.fastx import write_fasta
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops import thread as jth
from shannon_tpu.ops.condense import build_contig_arrays, to_contig_graph
from shannon_tpu.ops.correction import correct_spectrum
from shannon_tpu.ops.count import count_spectrum_packed
from shannon_tpu.pipeline import _thread_device as ref_thread_device
from shannon_tpu.pipeline import assemble as ref_assemble
from shannon_tpu.pipeline import ingest_paired_files as ref_ingest_paired_files
from shannon_tpu.pipeline import normalize_mate2 as ref_normalize_mate2
from shannon_tpu.sim import random_seq, sample_paired_reads, simulate_transcripts
from shannon_tpu.utils.timing import StageTimer
from shannon_tpu_torch import convert
from shannon_tpu_torch.ingest import ingest_paired_files, normalize_mate2
from shannon_tpu_torch.ops import thread as tth
from shannon_tpu_torch.ops.condense import to_contig_graph as port_contig_graph
from shannon_tpu_torch.pipeline import _thread_device, assemble


def _check(reads, cfg):
    port = assemble(reads, cfg, device="cpu", paired=True)
    ref = ref_assemble(reads, cfg, backend="device", paired=True)
    assert [t.seq for t in port.transcripts] == [t.seq for t in ref.transcripts]
    assert [t.abundance for t in port.transcripts] == [t.abundance for t in ref.transcripts]
    for key in ("n_reads", "n_kmers_final", "n_contigs", "n_components", "n_mb_splits",
                "n_sf_splits", "n_transcripts", "truncated"):
        assert port.stats[key] == ref.stats[key], key
    orc = ref_assemble(reads, cfg, backend="oracle", paired=True)
    assert port.canonical_set() == orc.canonical_set()
    return port


def _canon(seqs):
    return {min(s, revcomp_str(s)) for s in seqs}


def test_paired_backend_parity_dataset(rng):
    """tests/test_paired.py::test_paired_backend_parity's dataset."""
    t = simulate_transcripts(rng, n=2, length=350)
    reads = sample_paired_reads(rng, t, coverage=30, read_length=70, insert_size=220)
    port = _check(reads, AssemblyConfig(k=21, kmer_capacity=1 << 15))
    assert _canon(t) <= port.canonical_set()


def test_pair_bridging_resolves_long_repeat(rng):
    """A repeat longer than a read but shorter than the insert: only mate
    joining separates A-R-B from C-R-D, and no chimera comes out."""
    a, b, c, d = simulate_transcripts(rng, n=4, length=300)
    r = random_seq(rng, 120)
    t1, t2 = a + r + b, c + r + d
    reads = sample_paired_reads(rng, [t1, t2], coverage=50, read_length=80, insert_size=260)
    port = _check(reads, AssemblyConfig(k=21, kmer_capacity=1 << 15))
    got = port.canonical_set()
    assert _canon([t1, t2]) <= got
    assert not _canon([a + r + d, c + r + b]) & got


def test_unpaired_flag_ignores_joining(rng):
    """use_pairs=False: a paired batch takes the single-end evidence path."""
    t = simulate_transcripts(rng, n=1, length=300)
    reads = sample_paired_reads(rng, t, coverage=30, read_length=70, insert_size=200)
    port = _check(reads, AssemblyConfig(k=21, use_pairs=False, kmer_capacity=1 << 15))
    assert _canon(t) <= port.canonical_set()


def _paired_setup(seed: int, k: int = 21, use_pairs: bool = True, rescue: bool = True):
    rng = np.random.default_rng(seed)
    ts = simulate_transcripts(rng, n=3, length=400)
    reads = normalize_mate2(
        sample_paired_reads(rng, ts, coverage=20, read_length=70, insert_size=220, error_rate=0.01)
    )
    cfg = AssemblyConfig(k=k, batch_reads=256, use_pairs=use_pairs, rescue_reads=rescue)
    b = pack_reads(reads, pad_length=96, paired=True)
    spec = count_spectrum_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), k, 1 << 15, True, b.pad_length,
        None if b.mask is None else jnp.asarray(b.mask),
    )
    spec = correct_spectrum(spec, k, 1, 0.1, 8, True, error_rate=0.01)
    ref_ca = build_contig_arrays(spec, k, True)
    port_ca = convert.contig_arrays_from_numpy(*(np.asarray(x) for x in ref_ca.tree_flatten()[0]))
    return cfg, b, ref_ca, port_ca


@pytest.mark.parametrize("rescue", [True, False])
@pytest.mark.parametrize("use_pairs", [True, False])
def test_paired_evidence_matches_reference(use_pairs, rescue):
    """Flat evidence, offsets and weights of the threading driver over
    several batches (row dedup with pairs as units, pair joining)."""
    cfg, b, ref_ca, port_ca = _paired_setup(7, use_pairs=use_pairs, rescue=rescue)
    ref_g = to_contig_graph(ref_ca, cfg.k, cfg)
    port_g = port_contig_graph(port_ca, cfg.k, cfg)
    ref_ev = ref_thread_device(b, ref_ca, ref_g, cfg)
    timer = StageTimer(echo=False)
    port_ev = _thread_device(b, port_ca, port_g, cfg, torch.device("cpu"), timer)
    for p, r in zip(port_ev, ref_ev):
        np.testing.assert_array_equal(p, r)
    assert len(port_ev[2]) > 0
    if use_pairs:
        notes = timer.stages["threading"]
        for key in ("kernel_s", "dedup_s", "expand_s", "unique_rows"):
            assert key in notes, key
        assert notes["unique_rows"] <= b.n_reads


@pytest.mark.parametrize("rescue", [True, False])
def test_paths_to_lists_matches_reference(rescue):
    cfg, b, ref_ca, port_ca = _paired_setup(8)
    rows = tth.thread_reads_device_packed(
        torch.from_numpy(b.words.view(np.int32)), torch.from_numpy(b.lengths), port_ca,
        cfg.k, b.pad_length, None if b.mask is None else torch.from_numpy(b.mask.view(np.int32)),
    )
    rows = [x.numpy() for x in rows]
    got = tth.paths_to_lists(*rows, rescue=rescue)
    want = jth.paths_to_lists(*rows, rescue=rescue)
    assert got == want
    assert ((rows[3] >= 0).sum(1) > 1).any()  # some reads have several runs


def test_normalize_mate2_matches_reference():
    reads = ["ACGT", "AACC", "GGGG", "TTAN", "ACGTACGT", ""]
    assert normalize_mate2(reads) == ref_normalize_mate2(reads)
    assert normalize_mate2(reads)[:2] == ["ACGT", "GGTT"]


def _write_mates(tmp_path, reads):
    lf, rf = tmp_path / "l.fasta", tmp_path / "r.fasta"
    write_fasta(lf, [(f"l{i}", s) for i, s in enumerate(reads[0::2])])
    write_fasta(rf, [(f"r{i}", s) for i, s in enumerate(reads[1::2])])
    return str(lf), str(rf)


@pytest.mark.parametrize("read_length,pad", [(63, 0), (70, 70)])
def test_paired_ingest_file_vs_memory_batches(rng, tmp_path, read_length, pad):
    """The file route and the in-memory route (pack_reads of
    normalize_mate2) give identical batches, and the port's file route
    equals the reference's (tests/test_pipeline.py:103 and :186)."""
    t = simulate_transcripts(rng, n=2, length=300)
    reads = sample_paired_reads(rng, t, coverage=10, read_length=read_length, error_rate=0.01)
    lf, rf = _write_mates(tmp_path, reads)
    file_batch = ingest_paired_files(lf, rf, pad_length=pad)
    mem = pack_reads(normalize_mate2(reads), pad_length=file_batch.pad_length, paired=True)
    ref = ref_ingest_paired_files(lf, rf, pad_length=pad)
    assert file_batch.paired and mem.paired and ref.paired
    for other in (mem, ref):
        np.testing.assert_array_equal(file_batch.lengths, other.lengths)
        np.testing.assert_array_equal(file_batch.words, other.words)
        assert file_batch.pad_length == other.pad_length


def test_paired_ingest_rejects_unequal_mates(tmp_path):
    lf, rf = tmp_path / "l.fasta", tmp_path / "r.fasta"
    write_fasta(lf, [("a", "ACGTACGT"), ("b", "ACGTTTTT")])
    write_fasta(rf, [("a", "ACGTACGT")])
    with pytest.raises(ValueError, match="differ in length"):
        ingest_paired_files(str(lf), str(rf))
