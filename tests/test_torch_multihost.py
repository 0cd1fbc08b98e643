"""Port parity: multi-process assembly (shannon_tpu_torch.parallel.multihost
and the pipeline's multi-process branches, on torch.distributed over gloo)
against the JAX package.

The host helpers run in this process against the reference's own functions,
with jax.process_index / jax.process_count patched on one side and the
port's world() on the other.  The rest holds the results of
scripts/multihost_smoke_torch.py, launched once for the module (groups of 2
and 4 ranks, torchrun, the CPU), to the reference's one-process functions on
the same files: each rank's byte range and reads
(host_byte_range, native.pack_file_range), the replicated spectrum
(count_reads_spectrum on all reads), both back-half modes' transcripts and
rank 0's transcripts.fasta (run_pipeline), each rank's pair-aligned paired
ingest (ingest_paired_files_range), and the ownership volumes (the numpy
transcription of the reference's pack, test_torch_ownership.ref_buckets).
The overflow flag of a bucket on the last rank alone is up on every rank.
Then the CLI as 2 ranks under torchrun against the reference's run_pipeline.

Tolerance: exact — arrays equal, transcripts.fasta byte-equal."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.native import pack_file, pack_file_range
from shannon_tpu.ops.count import count_reads_spectrum
from shannon_tpu.parallel import multihost as jmh
from shannon_tpu.pipeline import ingest_paired_files_range, run_pipeline
from shannon_tpu_torch.parallel import multihost as tmh

from test_torch_ownership import ref_buckets

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "multihost_smoke_torch.py"
GROUPS = (2, 4)
MODES = ("ownership", "replicate")
PAD, K, CAPACITY = 64, 24, 1 << 15


def _patch_rank(monkeypatch, p: int, n: int) -> None:
    """Rank p of n on both sides: the reference's jax.process_* and the
    port's world()."""
    monkeypatch.setattr(jax, "process_index", lambda: p)
    monkeypatch.setattr(jax, "process_count", lambda: n)
    monkeypatch.setattr(tmh, "world", lambda: (p, n))


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    return env


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_host_helpers_match_reference(monkeypatch, tmp_path, n):
    path = tmp_path / "reads.fasta"
    path.write_bytes(b">r\nACGT\n" * 37)
    for p in range(n):
        _patch_rank(monkeypatch, p, n)
        assert tmh.host_byte_range(path) == jmh.host_byte_range(path)
        for records in (0, 1, 5, 10, 11, 1600):
            assert tmh.host_read_slice(records) == jmh.host_read_slice(records)


@pytest.mark.parametrize("device, local_ranks, cards, want", [
    ("cpu", 1, 0, "gloo"), ("cpu", 4, 8, "gloo"), ("cuda", 2, 1, "gloo"),
    ("cuda", 4, 1, "gloo"), ("cuda", 9, 8, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 2, "nccl"), ("cuda:0", 4, 8, "nccl"),
])
def test_backend_rule(device, local_ranks, cards, want):
    assert tmh.backend_for(device, local_ranks, cards) == want


def test_init_distributed_is_a_noop_without_the_environment(monkeypatch):
    import torch.distributed as dist

    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert tmh.init_distributed("cpu") is False
    assert not dist.is_initialized() and tmh.world() == (0, 1) and tmh.backend() is None


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The smoke's parent mode, groups of 2 and 4 ranks on the CPU."""
    work = tmp_path_factory.mktemp("multihost")
    proc = subprocess.run(
        [sys.executable, str(SCRIPT), "--work", str(work), "--ranks", *map(str, GROUPS),
         "--device", "cpu"],
        env=_env(), cwd=work, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return work, json.loads((work / "MULTIHOST_SMOKE_TORCH.json").read_text())


@pytest.fixture(scope="module")
def reference(smoke, tmp_path_factory):
    """The reference's one-process run_pipeline on the smoke's FASTA."""
    work, _ = smoke
    cfg = AssemblyConfig(k=K, kmer_capacity=CAPACITY, read_pad_length=PAD,
                         min_transcript_length=200,
                         out_dir=str(tmp_path_factory.mktemp("reference")))
    res = run_pipeline(cfg, single=str(work / "reads.fasta"), backend="device")
    return res, Path(cfg.out_dir)


def _marker(work: Path, n: int, r: int) -> dict:
    return json.loads((work / f"group{n}" / f"marker.p{r}.json").read_text())


def test_smoke_groups_pass(smoke):
    _, result = smoke
    assert result["ok"] is True and result["fasta_parity"] is True
    for n in GROUPS:
        group = result["groups"][str(n)]
        assert group["backend"] == "gloo" and group["overflow_flags_ok"]
        assert [p["rank"] for p in group["processes"]] == list(range(n))
        assert {p["n_ranks"] for p in group["processes"]} == {n}


@pytest.mark.parametrize("n", GROUPS)
def test_byte_ranges_and_local_reads_match_reference(smoke, monkeypatch, n):
    work, _ = smoke
    fasta = work / "reads.fasta"
    total = 0
    for r in range(n):
        _patch_rank(monkeypatch, r, n)
        lo, hi = jmh.host_byte_range(fasta)
        m = _marker(work, n, r)
        want = pack_file_range(fasta, lo, hi, pad_length=PAD)
        for mode in MODES:
            assert m["runs"][mode]["byte_range"] == [lo, hi]
            assert m["runs"][mode]["local_reads"] == want.n_reads > 0
        got = np.load(work / f"group{n}" / "ownership" / f"reads.p{r}.npz")
        np.testing.assert_array_equal(got["words"], want.words)
        np.testing.assert_array_equal(got["lengths"], want.lengths)
        total += want.n_reads
    assert total == smoke[1]["n_reads"]


@pytest.mark.parametrize("n", GROUPS)
def test_replicated_spectrum_matches_reference_count(smoke, n):
    work, _ = smoke
    spec = count_reads_spectrum(pack_file(work / "reads.fasta", pad_length=PAD), k=K,
                                capacity=CAPACITY)
    m = int(spec.n)
    keys = (np.asarray(spec.hi)[:m].astype(np.uint64) << np.uint64(32)) | np.asarray(
        spec.lo)[:m].astype(np.uint64)
    for r in range(n):
        for mode in MODES:
            got = np.load(work / f"group{n}" / f"{mode}.spectrum.p{r}.npz")
            np.testing.assert_array_equal(got["kmers"], keys)
            np.testing.assert_array_equal(got["counts"], np.asarray(spec.count)[:m])
            assert _marker(work, n, r)["runs"][mode]["count_overflowed"] is False


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("mode", MODES)
def test_transcripts_match_reference_run_pipeline(smoke, reference, n, mode):
    from shannon_tpu.io.dna import revcomp_str

    work, _ = smoke
    res, ref_out = reference
    want = sorted({min(t.seq, revcomp_str(t.seq)) for t in res.transcripts})
    for r in range(n):
        assert _marker(work, n, r)["runs"][mode]["transcripts"] == want
    out = work / f"group{n}" / mode
    assert (out / "transcripts.fasta").read_bytes() == (ref_out / "transcripts.fasta").read_bytes()
    for name in ("spectrum_corrected.npz", "spectrum.npz"):
        a, b = np.load(out / name), np.load(ref_out / name)
        for key in ("kmers", "counts"):
            np.testing.assert_array_equal(a[key], b[key])
    stats = json.loads((out / "stats.json").read_text())["stages"]
    assert stats["distributed"] == {"backend": "gloo", "world_size": n}
    assert ("owned_components" in stats["assembly"]) == (mode == "ownership")


@pytest.mark.parametrize("n", GROUPS)
def test_paired_range_ingest_matches_reference(smoke, monkeypatch, n):
    work, _ = smoke
    left, right = work / "left.fasta", work / "right.fasta"
    pairs = 0
    for r in range(n):
        _patch_rank(monkeypatch, r, n)
        want = ingest_paired_files_range(str(left), str(right), PAD)
        got = np.load(work / f"group{n}" / f"paired.p{r}.npz")
        np.testing.assert_array_equal(got["words"], want.words)
        np.testing.assert_array_equal(got["lengths"], want.lengths)
        assert _marker(work, n, r)["paired_byte_range"] == list(jmh.host_byte_range(left))
        pairs += want.n_reads // 2
    assert pairs == sum(1 for line in left.read_text().splitlines() if line.startswith(">"))


@pytest.mark.parametrize("n", GROUPS)
def test_ownership_volumes_match_the_transcription(smoke, n):
    work, _ = smoke
    ev = [np.load(work / f"group{n}" / f"ownership.evidence.p{r}.npz") for r in range(n)]
    buckets = [ref_buckets(e["flat"], e["offs"], e["weights"], e["owner"], n) for e in ev]
    cap = max(len(b) for bs in buckets for b in bs)
    for r, (e, bs) in enumerate(zip(ev, buckets)):
        local = len(e["offs"]) - 1
        assert _marker(work, n, r)["runs"]["ownership"]["volumes"] == {
            "ownership_sent_bytes": 4 * sum(len(b) for p, b in enumerate(bs) if p != r),
            "ownership_padded_bytes": 4 * n * cap,
            "replicate_equiv_bytes": (n - 1) * 4 * (len(e["flat"]) + 2 * local),
            "owned_paths": sum(int(b[r][0]) for b in buckets),
            "local_paths": local,
        }


@pytest.mark.parametrize("n", GROUPS)
def test_overflow_on_the_last_rank_is_flagged_on_every_rank(smoke, n):
    """The reads all on rank n - 1: at a bucket_cap one below its widest
    owner bucket only its own buckets overflow, and the flag is up on every
    rank (the reference's flag would be rank 0's, down); at the widest it is
    down everywhere."""
    work, _ = smoke
    for r in range(n):
        check = _marker(work, n, r)["overflow_check"]
        w = check["widest"]
        assert w > 1 and check["flags"] == {str(w - 1): True, str(w): False}


def test_cli_under_torchrun_matches_reference(smoke, reference, tmp_path):
    work, _ = smoke
    _, ref_out = reference
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "shannon_tpu_torch.cli", "-o", str(out), "--single", str(work / "reads.fasta"),
         "-K", str(K), "--kmer-capacity", str(CAPACITY), "--read-pad-length", str(PAD),
         "--device", "cpu"],
        env=_env(), cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert (out / "transcripts.fasta").read_bytes() == (ref_out / "transcripts.fasta").read_bytes()
    assert sorted(p.name for p in out.glob("reads*.npz")) == ["reads.p0.npz", "reads.p1.npz"]
    stats = json.loads((out / "stats.json").read_text())["stages"]
    assert stats["distributed"] == {"backend": "gloo", "world_size": 2}


# ---- record-range ingest (native.pack_file_records) ---------------------------


def _records(tmp_path, fmt: str, n: int = 7) -> Path:
    rng = np.random.default_rng(n)
    path = tmp_path / f"reads.{fmt}"
    with open(path, "w") as fh:
        for i in range(n):
            seq = "".join(rng.choice(list("ACGTN"), int(rng.integers(5, 40))))
            if fmt == "fasta":
                fh.write(f">r{i}\n{seq[:20]}\n{seq[20:]}\n" if len(seq) > 20 else f">r{i}\n{seq}\n")
            else:
                fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return path


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_pack_file_records_matches_reference(tmp_path, fmt):
    """Every (skip, n) of a small file, n one past the end included."""
    from shannon_tpu.native import pack_file_records as ref_records
    from shannon_tpu_torch.native import pack_file_records

    path, n_rec = _records(tmp_path, fmt), 7
    for skip in range(n_rec + 1):
        for n in range(n_rec - skip + 2):
            got, want = pack_file_records(path, skip, n, 48), ref_records(path, skip, n, 48)
            np.testing.assert_array_equal(got.codes, want.codes)
            np.testing.assert_array_equal(got.lengths, want.lengths)


def test_pack_file_records_stops_at_the_count(tmp_path):
    """FASTA record-range ingest returns once it has closed its last record:
    fed through a pipe that stays open, it returns while the writer still
    holds the pipe (the reference's copy reads on to EOF, and so returns
    only when the writer gives up and closes)."""
    import threading

    from shannon_tpu_torch import native

    fifo = tmp_path / "reads.fasta"
    os.mkfifo(fifo)
    release = threading.Event()

    def writer():
        with open(fifo, "w") as fh:
            fh.write(">r0\nACGTACGT\n>r1\nCCCCGGGG\n>r2\nTTTTAAAA\n>r3\n")
            fh.flush()
            release.wait(timeout=20)

    t = threading.Thread(target=writer)
    t.start()
    try:
        batch = native.pack_file_records(fifo, 1, 2, 16)
        writer_still_open = t.is_alive()
    finally:
        release.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert writer_still_open, "pack_file_records read on to EOF"
    assert batch.n_reads == 2 and batch.lengths.tolist() == [8, 8]
    assert batch.codes[0, :8].tolist() == [1] * 4 + [2] * 4
