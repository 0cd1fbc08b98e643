"""Port parity: the checkpointed file pipeline and the CLI.  The port's
run_pipeline(device="cpu") against shannon_tpu.pipeline.run_pipeline(
backend="device") on JAX-CPU, single-end and paired, on the datasets of
tests/test_pipeline.py: the same artifacts, the same resume and skip rules,
and each package resuming from the other's out-dir.  The port's CLI:
end to end, the pair knobs, and the argument errors (exit code 2).

Tolerance: exact — reads.npz, spectrum_corrected.npz and spectrum.npz
array-equal (dtypes included), transcripts.fasta byte-equal."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.dna import revcomp_str
from shannon_tpu.io.fastx import read_fastx, write_fasta
from shannon_tpu.pipeline import run_pipeline as ref_run_pipeline
from shannon_tpu.sim import sample_paired_reads, sample_reads, simulate_isoforms, simulate_transcripts
from shannon_tpu_torch import pipeline as tpipe
from shannon_tpu_torch.cli import main

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = ("reads.npz", "spectrum_corrected.npz", "spectrum.npz")


@pytest.fixture
def single(rng, tmp_path):
    """tests/test_pipeline.py's dataset, as one FASTA file."""
    ts = simulate_transcripts(rng, n=2, length=350) + simulate_isoforms(rng, exon_length=150)
    reads = sample_reads(
        rng, ts, abundances=[1, 3, 4, 1], coverage=30, read_length=70, error_rate=0.005
    )
    path = tmp_path / "reads.fasta"
    write_fasta(path, [(f"r{i}", s) for i, s in enumerate(reads)])
    return ts, {"single": str(path)}


@pytest.fixture
def paired(rng, tmp_path):
    """A paired library as two mate files."""
    ts = simulate_transcripts(rng, n=2, length=400)
    reads = sample_paired_reads(rng, ts, coverage=30, read_length=70, error_rate=0.005)
    lf, rf = tmp_path / "l.fasta", tmp_path / "r.fasta"
    write_fasta(lf, [(f"l{i}", s) for i, s in enumerate(reads[0::2])])
    write_fasta(rf, [(f"r{i}", s) for i, s in enumerate(reads[1::2])])
    return ts, {"left": str(lf), "right": str(rf)}


def _cfg(out: Path, **kw) -> AssemblyConfig:
    return AssemblyConfig(k=21, kmer_capacity=1 << 15, out_dir=str(out), **kw)


def _assert_same_artifacts(a: Path, b: Path, names=ARTIFACTS) -> None:
    for name in names:
        da, db = np.load(a / name), np.load(b / name)
        assert sorted(da.files) == sorted(db.files), name
        for key in da.files:
            assert da[key].dtype == db[key].dtype, (name, key)
            np.testing.assert_array_equal(da[key], db[key], err_msg=f"{name}:{key}")
    assert (a / "transcripts.fasta").read_bytes() == (b / "transcripts.fasta").read_bytes()


@pytest.mark.parametrize("mode", ["single", "paired"])
def test_artifacts_match_reference(mode, request, tmp_path):
    ts, files = request.getfixturevalue(mode)
    port = tpipe.run_pipeline(_cfg(tmp_path / "port"), **files, device="cpu")
    ref = ref_run_pipeline(_cfg(tmp_path / "ref"), **files, backend="device")
    _assert_same_artifacts(tmp_path / "port", tmp_path / "ref")
    assert [t.seq for t in port.transcripts] == [t.seq for t in ref.transcripts]
    for key in ("n_reads", "n_kmers_final", "n_contigs", "n_components", "n_mb_splits",
                "n_sf_splits", "n_transcripts", "truncated"):
        assert port.stats[key] == ref.stats[key], key
    assert {min(t, revcomp_str(t)) for t in ts} <= port.canonical_set()
    stats = json.loads((tmp_path / "port" / "stats.json").read_text())
    for stage in ("ingest", "spectrum", "graph", "partition", "threading", "assembly"):
        assert "wall_s" in stats["stages"][stage], stage
    assert stats["stages"]["spectrum+graph"]["auto_min_abundance"] >= 1  # config's cut is auto
    assert stats["result"]["backend"] == "torch:cpu"
    assert (tmp_path / "port" / "timing.log").exists()
    assert json.loads((tmp_path / "port" / "config.json").read_text())["k"] == 21


def test_resume_and_no_resume(single, tmp_path):
    _, files = single
    out = tmp_path / "out"
    res1 = tpipe.run_pipeline(_cfg(out), **files, device="cpu")
    first = (out / "transcripts.fasta").read_bytes()
    # resume: every stage skipped, the transcripts read back
    res2 = tpipe.run_pipeline(_cfg(out), **files, device="cpu")
    assert res2.stats == {"resumed": True}
    stages = json.loads((out / "stats.json").read_text())["stages"]
    for stage in ("ingest", "spectrum", "assembly"):
        assert stages[stage]["skipped"] is True, stage
    assert [(t.seq, t.abundance) for t in res2.transcripts] == [
        (t.seq, float(f"{t.abundance:.4f}")) for t in res1.transcripts
    ]
    # resume from the spectrum alone: graph onward recomputed, same output
    (out / "transcripts.fasta").unlink()
    res3 = tpipe.run_pipeline(_cfg(out), **files, device="cpu")
    assert [t.seq for t in res3.transcripts] == [t.seq for t in res1.transcripts]
    assert (out / "transcripts.fasta").read_bytes() == first
    # no-resume recomputes every stage from the input file
    (out / "reads.npz").unlink()
    res4 = tpipe.run_pipeline(_cfg(out, resume=False), **files, device="cpu")
    assert "skipped" not in json.loads((out / "stats.json").read_text())["stages"]["ingest"]
    assert [t.seq for t in res4.transcripts] == [t.seq for t in res1.transcripts]
    assert (out / "reads.npz").exists()


@pytest.mark.parametrize("mode", ["single", "paired"])
def test_cross_resume_from_reference_checkpoint(mode, request, tmp_path):
    """The port resumes from the reference's reads.npz and
    spectrum_corrected.npz (tip clip onward recomputed) and writes the
    reference's spectrum and transcripts."""
    _, files = request.getfixturevalue(mode)
    ref_out, port_out = tmp_path / "ref", tmp_path / "port"
    ref_run_pipeline(_cfg(ref_out), **files, backend="device")
    port_out.mkdir()
    for name in ("reads.npz", "spectrum_corrected.npz"):
        shutil.copy(ref_out / name, port_out / name)
    tpipe.run_pipeline(_cfg(port_out), device="cpu")  # no input: both resumed
    stages = json.loads((port_out / "stats.json").read_text())["stages"]
    assert stages["ingest"]["skipped"] is True
    _assert_same_artifacts(port_out, ref_out)


def test_reference_resumes_from_port_spectrum(single, tmp_path):
    _, files = single
    port_out, ref_out = tmp_path / "port", tmp_path / "ref"
    tpipe.run_pipeline(_cfg(port_out), **files, device="cpu")
    ref_out.mkdir()
    for name in ("reads.npz", "spectrum.npz"):
        shutil.copy(port_out / name, ref_out / name)
    ref_run_pipeline(_cfg(ref_out), backend="device")
    assert (ref_out / "transcripts.fasta").read_bytes() == (
        port_out / "transcripts.fasta"
    ).read_bytes()


def test_run_pipeline_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="--single or --left/--right"):
        tpipe.run_pipeline(_cfg(tmp_path / "a"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        tpipe.run_pipeline(_cfg(tmp_path / "b", n_devices=2), single="x.fa", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_pipeline(_cfg(tmp_path / "c"), single="x.fa", device="cuda")


def test_cli_end_to_end(single, tmp_path):
    ts, files = single
    out = tmp_path / "cli_out"
    rc = main([
        "-o", str(out), "--single", files["single"], "-K", "21",
        "--kmer-capacity", str(1 << 15), "--device", "cpu", "--profile",
    ])
    assert rc == 0
    got = {min(s, revcomp_str(s)) for _, s in read_fastx(out / "transcripts.fasta")}
    assert {min(t, revcomp_str(t)) for t in ts} <= got
    traces = list((out / "profile").iterdir())
    assert traces and all(p.suffix == ".json" for p in traces)
    ref_run_pipeline(_cfg(tmp_path / "ref"), **files, backend="device")
    assert (out / "transcripts.fasta").read_bytes() == (
        tmp_path / "ref" / "transcripts.fasta"
    ).read_bytes()


def test_cli_paired_runs_the_file_pipeline(paired, tmp_path):
    ts, files = paired
    out = tmp_path / "out"
    rc = main([
        "-o", str(out), "--left", files["left"], "--right", files["right"], "-K", "21",
        "--kmer-capacity", str(1 << 15), "--device", "cpu",
    ])
    assert rc == 0
    assert bool(np.load(out / "reads.npz")["paired"])
    got = {min(s, revcomp_str(s)) for _, s in read_fastx(out / "transcripts.fasta")}
    assert {min(t, revcomp_str(t)) for t in ts} <= got


def test_cli_pair_knobs_flow_to_config(tmp_path, monkeypatch):
    seen = {}

    def fake_run_pipeline(config, **kw):
        seen["cfg"], seen["kw"] = config, kw
        return tpipe.AssemblyResult(transcripts=[], stats={})

    monkeypatch.setattr(tpipe, "run_pipeline", fake_run_pipeline)
    rc = main([
        "-o", str(tmp_path), "--left", "l.fa", "--right", "r.fa",
        "--no-pairs", "--insert-size", "300", "--insert-size-std", "25",
        "--device", "cpu", "--ss", "--no-resume", "-K", "25",
    ])
    assert rc == 0
    cfg = seen["cfg"]
    assert cfg.use_pairs is False
    assert cfg.insert_size == 300
    assert cfg.insert_size_std == 25.0
    assert cfg.strand_specific and not cfg.resume and cfg.k == 25
    assert seen["kw"] == {"single": None, "left": "l.fa", "right": "r.fa", "device": "cpu"}


def test_cli_arg_errors(tmp_path, capsys):
    assert main(["-o", str(tmp_path)]) == 2  # no input
    assert main(["-o", str(tmp_path), "--left", "x.fa"]) == 2  # no right
    assert main(["-o", str(tmp_path), "--right", "x.fa"]) == 2  # no left
    assert (
        main(["-o", str(tmp_path), "--single", "a.fa", "--left", "b.fa",
              "--right", "c.fa"]) == 2
    )  # both modes
    assert "exactly one of --single" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="item 14"):
        main(["-o", str(tmp_path), "--single", "a.fa", "-p", "2", "--device", "cpu"])


def test_cli_runs_as_a_module(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "shannon_tpu_torch.cli", "-o", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert "exactly one of --single" in proc.stderr
