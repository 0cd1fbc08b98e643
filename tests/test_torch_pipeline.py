"""Port parity: the whole single-end assembly.  The port's
assemble(device="cpu") against shannon_tpu.pipeline.assemble(
backend="device") on one JAX-CPU device and against the pure-Python oracle,
on the pinned simulations of tests/test_pipeline.py; the port's
assemble(backend="oracle") against the reference's, single-end and paired.
Also: the port never imports jax.

Tolerance: exact — the same transcript list (sequence order included) as
the reference device path, and the same canonical set as the oracle."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.dna import revcomp_str
from shannon_tpu.oracle import assemble_oracle
from shannon_tpu.pipeline import assemble as ref_assemble
from shannon_tpu.sim import (
    sample_paired_reads,
    sample_reads,
    simulate_gene_isoforms,
    simulate_isoforms,
    simulate_transcripts,
)
from shannon_tpu.utils.timing import StageTimer
from shannon_tpu_torch import pipeline as tpipe
from shannon_tpu_torch.pipeline import assemble

REPO = Path(__file__).resolve().parent.parent


def _check(reads, cfg, truth=None, oracle=True):
    port = assemble(reads, cfg, device="cpu")
    ref = ref_assemble(reads, cfg, backend="device")
    assert [t.seq for t in port.transcripts] == [t.seq for t in ref.transcripts]
    assert [t.abundance for t in port.transcripts] == [t.abundance for t in ref.transcripts]
    for key in ("n_kmers_final", "n_contigs", "n_components", "n_mb_splits", "n_sf_splits"):
        assert port.stats[key] == ref.stats[key], key
    if oracle:
        assert port.canonical_set() == assemble_oracle(reads, cfg).canonical_set()
    if truth is not None:
        assert {min(t, revcomp_str(t)) for t in truth} <= port.canonical_set()
    return port


def test_pinned_dataset_matches_reference_and_oracle(rng):
    """tests/test_pipeline.py's dataset (two transcripts + an isoform pair)."""
    ts = simulate_transcripts(rng, n=2, length=350) + simulate_isoforms(rng, exon_length=150)
    reads = sample_reads(
        rng, ts, abundances=[1, 3, 4, 1], coverage=30, read_length=70, error_rate=0.005
    )
    _check(reads, AssemblyConfig(k=21, kmer_capacity=1 << 15, n_devices=1), ts)


def test_verify_recipe_dataset_matches_reference_and_oracle():
    """The drive script of the verify recipe (k=23, 1% error)."""
    rng = np.random.default_rng(42)
    ts = simulate_transcripts(rng, n=2, length=500) + simulate_isoforms(rng, exon_length=250)
    reads = sample_reads(
        rng, ts, abundances=[1, 2, 4, 1], coverage=40, read_length=75, error_rate=0.01
    )
    _check(reads, AssemblyConfig(k=23, kmer_capacity=1 << 15, n_devices=1), ts)


def test_150bp_auto_pad_matches_reference(rng):
    ts = simulate_transcripts(rng, n=3, length=600)
    reads = sample_reads(rng, ts, coverage=25, read_length=150, error_rate=0.005)
    _check(reads, AssemblyConfig(k=21, kmer_capacity=1 << 15, n_devices=1), ts)


@pytest.mark.parametrize("k", [16, 24, 31])
def test_gene_isoforms_several_batches_match_reference(k):
    """Splicing graphs (X-nodes for SF), several read batches, auto
    abundance cut.  The slow pure-Python oracle runs for k=24 only."""
    rng = np.random.default_rng(k)
    ts, _ = simulate_gene_isoforms(rng, n_genes=2)
    reads = sample_reads(
        rng, ts, abundances=list(rng.uniform(1, 4, len(ts))), coverage=15,
        read_length=80, error_rate=0.01,
    )
    cfg = AssemblyConfig(k=k, kmer_capacity=1 << 15, batch_reads=1024, n_devices=1)
    res = _check(reads, cfg, oracle=k == 24)
    assert res.stats["n_sf_splits"] + res.stats["n_mb_splits"] > 0


def test_strand_specific_matches_reference(rng):
    ts = simulate_transcripts(rng, n=2, length=400)
    reads = sample_reads(rng, ts, coverage=25, read_length=70, error_rate=0.005, both_strands=False)
    _check(reads, AssemblyConfig(k=21, kmer_capacity=1 << 15, strand_specific=True, n_devices=1), ts)


def test_stage_timer_records_the_reference_stages(rng):
    ts = simulate_transcripts(rng, n=1, length=300)
    reads = sample_reads(rng, ts, coverage=20, read_length=70)
    timer = StageTimer(echo=False)
    assemble(reads, AssemblyConfig(k=21, kmer_capacity=1 << 15), device="cpu", timer=timer)
    for stage in ("spectrum+graph", "partition", "threading", "assembly", "dedupe"):
        assert "wall_s" in timer.stages[stage], stage
    notes = timer.stages["spectrum+graph"]
    for key in ("ingest_s", "count_s", "correct_s", "tipclip_s", "condense_s", "materialize_s"):
        assert key in notes, key


def test_unported_options_raise(rng, monkeypatch):
    """k = 32 raises; n_devices = 2 (once refused) counts in two shards and
    gives the single-shard transcripts."""
    ts = simulate_transcripts(rng, n=2, length=300)
    reads = sample_reads(rng, ts, coverage=20, read_length=70, error_rate=0.005)
    meshes = []
    sharded = tpipe.count_reads_spectrum_sharded
    monkeypatch.setattr(tpipe, "count_reads_spectrum_sharded",
                        lambda *a, **kw: meshes.append(kw["mesh"]) or sharded(*a, **kw))
    two = assemble(reads, AssemblyConfig(k=21, kmer_capacity=1 << 15, n_devices=2), device="cpu")
    assert meshes == [(torch.device("cpu"),) * 2]
    one = assemble(reads, AssemblyConfig(k=21, kmer_capacity=1 << 15, n_devices=1), device="cpu")
    assert len(meshes) == 1
    assert [t.seq for t in two.transcripts] == [t.seq for t in one.transcripts]
    assert two.canonical_set() >= {min(t, revcomp_str(t)) for t in ts}
    with pytest.raises(ValueError, match="1..31"):
        assemble(reads[:1], AssemblyConfig(k=32), device="cpu")


def _oracle_dataset(paired: bool):
    rng = np.random.default_rng(17)
    ts = simulate_transcripts(rng, n=2, length=400) + simulate_isoforms(rng, exon_length=150)
    if paired:
        return ts, sample_paired_reads(rng, ts, coverage=25, read_length=70, error_rate=0.005)
    return ts, sample_reads(rng, ts, abundances=[1, 3, 4, 1], coverage=25, read_length=70,
                            error_rate=0.005)


@pytest.mark.parametrize("paired", [False, True])
def test_oracle_backend_matches_reference_oracle(paired):
    """assemble(backend="oracle") == the reference's: transcripts (order and
    abundances), stats but the backend's label, and the stages."""
    ts, reads = _oracle_dataset(paired)
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15)
    timer = StageTimer(echo=False)
    port = assemble(reads, cfg, backend="oracle", timer=timer, paired=paired)
    ref = ref_assemble(reads, cfg, backend="oracle", paired=paired)
    assert [(t.seq, t.abundance) for t in port.transcripts] == [
        (t.seq, t.abundance) for t in ref.transcripts
    ]
    assert port.stats == ref.stats and port.stats["backend"] == "oracle"
    for stage in ("spectrum", "graph", "threading", "assembly", "multibridge", "sparseflow",
                  "enumerate", "dedupe"):
        assert "wall_s" in timer.stages[stage], stage
    assert {min(t, revcomp_str(t)) for t in ts} <= port.canonical_set()
    if not paired:
        orc = assemble_oracle(reads, cfg)
        assert [(t.seq, t.abundance) for t in port.transcripts] == [
            (t.seq, t.abundance) for t in orc.transcripts
        ]


def test_oracle_backend_needs_no_card_and_unknown_backends_raise(monkeypatch):
    """The oracle backend runs on the host whatever `device` says; an
    unknown backend raises, as in the reference."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, reads = _oracle_dataset(False)
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15)
    assert assemble(reads[:400], cfg, backend="oracle").stats["backend"] == "oracle"
    for backend in ("tpu", "cuda", ""):
        with pytest.raises(ValueError, match="unknown backend"):
            assemble(reads[:10], cfg, backend=backend, device="cpu")
        with pytest.raises(ValueError, match="unknown backend"):
            ref_assemble(reads[:10], cfg, backend=backend)


def test_port_never_imports_jax():
    """Import every module of the port (ingest and cli included) and
    assemble a tiny single-end and paired dataset in a process where
    `import jax` and `import shannon_tpu` both fail: the port runs on its
    own copies of the reference's framework-free modules."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["shannon_tpu"] = None
        import importlib, pkgutil
        import numpy as np
        import shannon_tpu_torch
        for m in pkgutil.walk_packages(shannon_tpu_torch.__path__, "shannon_tpu_torch."):
            importlib.import_module(m.name)
        from shannon_tpu_torch.config import AssemblyConfig
        from shannon_tpu_torch.sim import sample_paired_reads, sample_reads, simulate_transcripts
        from shannon_tpu_torch.pipeline import assemble
        rng = np.random.default_rng(0)
        ts = simulate_transcripts(rng, n=2, length=300)
        res = assemble(sample_reads(rng, ts, coverage=15, read_length=70),
                       AssemblyConfig(k=21, kmer_capacity=1 << 15), device="cpu")
        assert res.stats["n_transcripts"] >= 2, res.stats
        res = assemble(sample_paired_reads(rng, ts, coverage=15, read_length=70, insert_size=150),
                       AssemblyConfig(k=21, kmer_capacity=1 << 15), device="cpu", paired=True)
        assert res.stats["n_transcripts"] >= 2, res.stats
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
            m in ("jax", "shannon_tpu") or m.startswith(("jax.", "jaxlib", "shannon_tpu."))))
        assert not bad, bad
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """assemble, run_pipeline and spectrum_device run on the card unless
    the caller asks for the CPU: with no card and no device given they
    refuse instead of falling back."""
    from shannon_tpu.io.pack import pack_reads
    from shannon_tpu_torch.pipeline import run_pipeline, spectrum_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15, out_dir=str(tmp_path))
    reads = ["ACGT" * 20]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assemble(reads, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(cfg, single=str(tmp_path / "x.fa"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spectrum_device(pack_reads(reads, pad_length=96), cfg)
