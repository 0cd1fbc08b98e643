"""Multi-process smoke run of the PyTorch/CUDA port on torch.distributed:
the port's counterpart of scripts/multihost_smoke.py (same dataset, same
child work, same result JSON).

    python scripts/multihost_smoke_torch.py [--work DIR] [--result FILE]
        [--ranks 2 4] [--device cpu|cuda]

Parent mode (the default) simulates the reference's dataset (seed 5, 20
transcripts x 600 bp, coverage 8, 60 bp reads, 1% error: 1,600 reads),
writes it as one FASTA (and as two mate files of 60 bp mates), counts it and
assembles it with the port's pure-Python oracle, then launches one group
of N ranks for each N of --ranks with

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        scripts/multihost_smoke_torch.py child ...

(--standalone picks a free port, so groups may run side by side).  A rank
that exits nonzero, a missing marker or a group past its timeout kills the
group and fails the run.  Writes the result JSON to --result (default
WORK/MULTIHOST_SMOKE_TORCH.json) and exits nonzero unless every group
passed.

Child mode (one rank; see `child_parser`): joins the group
(parallel.multihost.init_distributed), runs run_pipeline once for each
--job NAME MODE INPUT, in order (out-dir WORK/NAME), and writes
WORK/marker.p{rank}.json: by run, the byte range, local reads, spectrum
size, transcripts (canonical, sorted), communication volumes, (on CUDA)
the kernel launches and (rank 0) the stage times of stats.json; the backend; and the clock (seconds from the launch
to the process's start, its joining the group, the end of its runs, its
end, and the group's exit).  It saves each run's replicated spectrum
(NAME.spectrum.p{rank}.npz), and on request one run's local evidence with
the owner table as route_evidence_ownership received them
(NAME.evidence.p{rank}.npz), its pair-aligned share of two mate files
(paired.p{rank}.npz), and an overflow check: the count again with the
first run's reads on the last rank alone, at a bucket_cap one below and at
the widest owner bucket of that rank, where the flag must be up on every
rank and down on every rank.  With --expected-spectrum /
--expected-transcripts it asserts every run's spectrum and transcripts
against them.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

_T0 = time.time()  # the process's start, before numpy and torch load

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
K = 24
PAD = 64  # explicit pad: byte-range ingest needs one shape on every rank
CAPACITY = 1 << 15
MODES = ("ownership", "replicate")


def child_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="multihost_smoke_torch.py child")
    p.add_argument("--work", required=True, help="directory for out-dirs, markers and npz files")
    p.add_argument("--job", nargs=3, action="append", required=True,
                   metavar=("NAME", "MODE", "INPUT"),
                   help="one run_pipeline, in order: its name (out-dir WORK/NAME), back-half "
                   "mode, and input (a FASTA/FASTQ file, or LEFT,RIGHT mate files); no "
                   "option here may begin another of torchrun's, which would take it")
    p.add_argument("--device", default="cpu")
    p.add_argument("--pad", type=int, default=PAD)
    p.add_argument("--capacity", type=int, default=CAPACITY)
    p.add_argument("--batch-reads", type=int, default=1 << 16)
    p.add_argument("--save-evidence", metavar="NAME",
                   help="save the local evidence and owner table of run NAME's route")
    p.add_argument("--paired-ingest", nargs=2, metavar=("LEFT", "RIGHT"))
    p.add_argument("--overflow-check", action="store_true")
    p.add_argument("--expected-spectrum", help="npz of every run's expected kmers and counts")
    p.add_argument("--expected-transcripts", help="JSON list of every run's expected set")
    return p


def _canonical(seqs) -> list[str]:
    from shannon_tpu_torch.io.dna import revcomp_str

    return sorted({min(s, revcomp_str(s)) for s in seqs})


def _overflow_check(batch, args, device) -> dict:
    """The count with every read on the last rank: its widest owner bucket
    W sets bucket_cap W - 1 (the last rank's buckets overflow, no other
    rank's do) and W (nothing overflows).  Returns the flags."""
    import torch

    from shannon_tpu_torch.ops.count import count_window_keys, upload_words
    from shannon_tpu_torch.ops.kmers import PAD as PAD_KEY
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed
    from shannon_tpu_torch.parallel import multihost
    from shannon_tpu_torch.parallel.distributed import owner_of

    rank, n_ranks = multihost.world()
    mine = batch if rank == n_ranks - 1 else batch.rows(slice(0, 0))
    widest = 0
    if mine.n_reads:
        keys, _ = extract_kmers_packed(
            upload_words(mine.words, device), torch.from_numpy(mine.lengths).to(device),
            K, True, mine.pad_length,
        )
        table = count_window_keys(keys, args.capacity)
        real = table.key[table.key != PAD_KEY]
        widest = int(torch.bincount(owner_of(real, n_ranks)).max())
    widest = multihost.max_over_ranks(widest)
    flags = {}
    for cap in (widest - 1, widest):
        _, flag = multihost.count_reads_spectrum_multihost(
            mine, K, args.capacity, True, args.batch_reads, device, bucket_cap=cap)
        flags[str(cap)] = flag
    return {"widest": widest, "flags": flags}


def child(argv: list[str]) -> None:
    args = child_parser().parse_args(argv)
    import torch

    from shannon_tpu_torch import kernels
    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.ingest import ingest_paired_files_range
    from shannon_tpu_torch.parallel import multihost
    from shannon_tpu_torch.pipeline import _load_reads, run_pipeline

    if not multihost.init_distributed(args.device):
        raise RuntimeError("init_distributed did not join a group of more than one rank")
    clock = {"start": _T0, "joined": time.time()}
    rank, n_ranks = multihost.world()
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    work = Path(args.work)
    marker = {"rank": rank, "n_ranks": n_ranks, "backend": multihost.backend(),
              "device": str(device), "clock": clock}
    if on_card:
        marker["card"] = torch.cuda.get_device_name(torch.cuda.current_device())
        marker["card_index"] = torch.cuda.current_device()

    # Capture what the pipeline hands the collectives: each run's count
    # (its replicated spectrum) and route (local evidence and volumes).
    seen: dict = {}
    count_fn, route_fn = (multihost.count_reads_spectrum_multihost,
                          multihost.route_evidence_ownership)

    def count_spy(*a, **kw):
        out = count_fn(*a, **kw)
        seen.setdefault("count", out)
        return out

    def route_spy(flat, offs, weights, owner, device, volumes=None):
        vol = {} if volumes is None else volumes
        seen["route"] = ((flat, offs, weights, owner), vol)
        return route_fn(flat, offs, weights, owner, device, volumes=vol)

    multihost.count_reads_spectrum_multihost = count_spy
    multihost.route_evidence_ownership = route_spy

    lib = kernels.library() if on_card else None
    runs: dict = {}
    for name, mode, source in args.job:
        cfg = AssemblyConfig(
            k=K, kmer_capacity=args.capacity, batch_reads=args.batch_reads,
            out_dir=str(work / name), read_pad_length=args.pad,
            multihost_backhalf=mode,
        )
        files = source.split(",")
        inputs = {"single": files[0]} if len(files) == 1 else dict(zip(("left", "right"), files))
        seen.clear()
        if lib is not None:
            torch.cuda.synchronize()
            lib.reset_counts()
        t0 = time.perf_counter()
        res = run_pipeline(cfg, device=device, **inputs)
        if on_card:
            torch.cuda.synchronize()
        spec, overflowed = seen["count"]
        n = spec.n
        np.savez(work / f"{name}.spectrum.p{rank}.npz",
                 kmers=spec.key[:n].cpu().numpy().astype(np.uint64),
                 counts=spec.count[:n].cpu().numpy())
        rec = runs[name] = {
            "mode": mode, "input": source, "wall_s": time.perf_counter() - t0,
            "transcripts": _canonical(t.seq for t in res.transcripts),
            "n_transcripts": len(res.transcripts),
            "local_reads": _load_reads(work / name / f"reads.p{rank}.npz").n_reads,
            "n_kmers": n, "count_overflowed": overflowed,
            "volumes": seen["route"][1] if "route" in seen else None,
            "launches": None if lib is None else dict(lib.launches),
        }
        if "single" in inputs:
            rec["byte_range"] = list(multihost.host_byte_range(inputs["single"]))
        if rank == 0:  # the stage times rank 0 wrote
            rec["stages"] = json.loads((work / name / "stats.json").read_text())["stages"]
        if name == args.save_evidence:
            flat, offs, weights, owner = seen["route"][0]
            np.savez(work / f"{name}.evidence.p{rank}.npz", flat=flat, offs=offs,
                     weights=weights, owner=owner)
    marker["runs"] = runs
    clock["runs_done"] = time.time()

    if args.paired_ingest:
        left, right = args.paired_ingest
        b = ingest_paired_files_range(left, right, args.pad)
        np.savez(work / f"paired.p{rank}.npz", words=b.words, lengths=b.lengths)
        marker["paired_byte_range"] = list(multihost.host_byte_range(left))
        marker["paired_local_reads"] = b.n_reads
    if args.overflow_check:
        first = args.job[0][0]
        batch = _load_reads(work / first / f"reads.p{rank}.npz")
        marker["overflow_check"] = _overflow_check(batch, args, device)
    for name, rec in runs.items():
        if args.expected_spectrum:
            got, exp = np.load(work / f"{name}.spectrum.p{rank}.npz"), np.load(args.expected_spectrum)
            assert all(np.array_equal(got[key], exp[key]) for key in ("kmers", "counts")), (
                f"rank {rank} run {name}: the replicated spectrum != the expected "
                f"({rec['n_kmers']} vs {len(exp['kmers'])})")
        if args.expected_transcripts:
            exp_t = json.loads(Path(args.expected_transcripts).read_text())
            assert rec["transcripts"] == exp_t, (
                f"rank {rank} run {name}: {len(rec['transcripts'])} transcripts, expected "
                f"{len(exp_t)}")
    multihost.leave_distributed()
    clock["end"] = time.time()
    (work / f"marker.p{rank}.json").write_text(json.dumps(marker))
    print(f"rank {rank}/{n_ranks} ({marker['backend']}): OK, transcripts by run "
          f"{ {name: rec['n_transcripts'] for name, rec in runs.items()} }", flush=True)


def launch_group(n_ranks: int, child_args: list[str], work: Path, timeout: float = 600.0,
                 env_extra: dict | None = None) -> tuple[list[dict], str]:
    """Run n_ranks ranks of child mode under torchrun --standalone, with
    `child_args` (--work is added) and `env_extra` in their environment.
    Returns (each rank's marker, in rank order; the group's output).
    Raises, after killing the whole group, if it outlives `timeout`
    seconds; raises if a rank exits nonzero or leaves no marker."""
    work.mkdir(parents=True, exist_ok=True)
    for stale in work.glob("marker.p*.json"):
        stale.unlink()
    env = {**os.environ, **(env_extra or {})}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), *filter(None, [env.get("PYTHONPATH")])])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n_ranks), __file__, "child", "--work", str(work),
           *child_args]
    launched = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(
            f"the group of {n_ranks} ranks outlived its {timeout} s; killed\n{out[-6000:]}"
        ) from None
    exited = time.time()
    if proc.returncode != 0:
        raise RuntimeError(f"the group of {n_ranks} ranks exited with {proc.returncode}\n"
                           f"{out[-6000:]}")
    paths = [work / f"marker.p{r}.json" for r in range(n_ranks)]
    missing = [p.name for p in paths if not p.exists()]
    if missing:
        raise RuntimeError(f"the group of {n_ranks} ranks left no {missing}\n{out[-6000:]}")
    markers = [json.loads(p.read_text()) for p in paths]
    for m in markers:  # seconds from the launch, on the host's clock
        m["clock"] = {k: v - launched for k, v in m["clock"].items()}
        m["clock"]["exited"] = exited - launched
    return markers, out


def dataset():
    """The reference smoke's reads (seed 5: 20 transcripts x 600 bp,
    coverage 8, 60 bp reads, 1% error) and, from the same transcripts, 60 bp
    mates of 150 bp inserts, interleaved [L0, R0, ...]."""
    from shannon_tpu_torch.sim import sample_paired_reads, sample_reads, simulate_transcripts

    rng = np.random.default_rng(5)
    ts = simulate_transcripts(rng, n=20, length=600)
    reads = sample_reads(rng, ts, coverage=8.0, read_length=60, error_rate=0.01)
    pairs = sample_paired_reads(np.random.default_rng(6), ts, coverage=8.0, read_length=60,
                                insert_size=150, error_rate=0.01)
    return reads, pairs


def write_inputs(work: Path) -> tuple[list[str], Path, Path, Path]:
    """reads.fasta and the mate files left.fasta / right.fasta in `work`."""
    from shannon_tpu_torch.io.fastx import write_fasta

    reads, pairs = dataset()
    fasta, left, right = work / "reads.fasta", work / "left.fasta", work / "right.fasta"
    write_fasta(fasta, [(f"r{i}", s) for i, s in enumerate(reads)])
    write_fasta(left, [(f"p{i}/1", s) for i, s in enumerate(pairs[0::2])])
    write_fasta(right, [(f"p{i}/2", s) for i, s in enumerate(pairs[1::2])])
    return reads, fasta, left, right


def parent(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=None, help="work directory (default: a new temporary one)")
    ap.add_argument("--result", default=None, help="result JSON (default WORK/...)")
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    import tempfile

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.fastx import read_fastx
    from shannon_tpu_torch.oracle import assemble_oracle
    from shannon_tpu_torch.oracle.counting import count_kmers

    work = Path(args.work or tempfile.mkdtemp(prefix="multihost_smoke_torch_"))
    work.mkdir(parents=True, exist_ok=True)
    if args.device != "cpu":
        from shannon_tpu_torch import kernels

        kernels.build()  # once here, so the ranks load it and none builds
    reads, fasta, left, right = write_inputs(work)
    counts = count_kmers(reads, K, strand_specific=False)
    keys = np.fromiter(counts.keys(), np.uint64, len(counts))
    order = np.argsort(keys)
    vals = np.fromiter(counts.values(), np.int64, len(counts)).astype(np.int32)
    expected = work / "expected.npz"
    np.savez(expected, kmers=keys[order], counts=vals[order])
    expected_t = _canonical(t.seq for t in assemble_oracle(reads, AssemblyConfig(k=K)).transcripts)
    expected_t_path = work / "expected_transcripts.json"
    expected_t_path.write_text(json.dumps(expected_t))

    t0 = time.perf_counter()
    groups, all_ok = {}, True
    for n_ranks in args.ranks:
        gwork = work / f"group{n_ranks}"
        markers, _out = launch_group(n_ranks, [
            *(x for mode in MODES for x in ("--job", mode, mode, str(fasta))),
            "--device", args.device, "--save-evidence", "ownership",
            "--paired-ingest", str(left), str(right), "--overflow-check",
            "--expected-spectrum", str(expected), "--expected-transcripts", str(expected_t_path),
        ], gwork)
        fasta_parity = {}
        for mode in MODES:
            got = _canonical(s for _h, s in read_fastx(gwork / mode / "transcripts.fasta"))
            fasta_parity[mode] = got == expected_t
        stats = json.loads((gwork / "ownership" / "stats.json").read_text())
        asm = stats["stages"]["assembly"]
        volumes = {k: asm[k] for k in ("ownership_sent_bytes", "ownership_padded_bytes",
                                       "replicate_equiv_bytes", "owned_paths", "local_paths",
                                       "owned_components") if k in asm}
        flags_ok = all(m["overflow_check"]["flags"] == {
            str(m["overflow_check"]["widest"] - 1): True,
            str(m["overflow_check"]["widest"]): False} for m in markers)
        ok = all(fasta_parity.values()) and flags_ok
        all_ok = all_ok and ok
        groups[str(n_ranks)] = {
            "ok": ok, "fasta_parity": fasta_parity, "overflow_flags_ok": flags_ok,
            "backend": stats["stages"]["distributed"]["backend"],
            "comm_volumes_proc0": volumes,
            "processes": [{k: v for k, v in m.items() if k != "runs"} for m in markers],
        }
    result = {
        "ok": all_ok,
        "wall_s": round(time.perf_counter() - t0, 1),
        "n_reads": len(reads),
        "n_kmers": int(len(keys)),
        "n_transcripts_expected": len(expected_t),
        "fasta_parity": all(all(g["fasta_parity"].values()) for g in groups.values()),
        "backend": f"{args.device} (localhost processes, torch.distributed)",
        "groups": groups,
        "what": (
            "torchrun --standalone xN -> init_distributed -> per-rank byte-range FASTA "
            "ingest (native pack_file_range) -> count_reads_spectrum_multihost (owner "
            "buckets, all_to_all_single, owner merge, all_gather) -> replicated spectrum == "
            "the port's oracle count; then run_pipeline in both back-half modes, "
            "'ownership' (K26 pack, all_to_all_single, K27 unpack, per-rank assembly of "
            "owned components, transcript gather) and 'replicate' (evidence all_gather), "
            "each rank's transcript set and rank 0's transcripts.fasta == the port's "
            "oracle set; pair-aligned range ingest of two mate files; the overflow flag "
            "of a bucket on the last rank alone up on every rank"
        ),
    }
    out_path = Path(args.result) if args.result else work / "MULTIHOST_SMOKE_TORCH.json"
    out_path.write_text(json.dumps(result, indent=2))
    print(json.dumps({k: v for k, v in result.items() if k != "groups"}, indent=2))
    return 0 if all_ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["child"]:
        child(sys.argv[2:])
    else:
        sys.exit(parent(sys.argv[1:]))
