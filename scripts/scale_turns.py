"""End-to-end scale runs of several trees of the PyTorch/CUDA port, in turns,
on one NVIDIA GPU.

    python scripts/scale_turns.py --trees DIR [DIR ...] [--reads N] [--out report.json]

Each DIR is the root of a checkout of this repo, for example the parent
commit unpacked with `git archive` into a git-ignored directory beside this
tree; list them in the order they should run, such as `old new new old old
new new old`, so that a drift of the host weighs on both alike.  Each run is
a fresh process that imports shannon_tpu_torch from its DIR, builds its
kernels, warms up on chip_smoke.PARITY_READS reads (as the smoke's parity
phase does before its scale phases), then runs chip_smoke.py's two scale
phases on its datasets: assemble on N single-end reads in memory, then the
same again in the same process (its allocator now holds blocks of every
size the run asks for), and the CLI on N paired reads (N / 2 pairs) from
two FASTA files.  Each merge of the count (ops.count.merge_at) is bracketed
with two CUDA events, so a run reports how much of count_s the merges hold
on the device stream; each line also gives threading's kernel_s (K1, K3,
K4 and K5 a batch).

Prints one line a run, with the card's name and power limit, and writes
the runs so far as JSON to --out after each run.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    """This tree's chip_smoke.py (its datasets), whatever tree runs."""
    spec = importlib.util.spec_from_file_location("chip_smoke_data", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: Path, n_reads: int) -> dict:
    """One run of both scale phases on the tree's shannon_tpu_torch."""
    sys.path.insert(0, str(tree))
    import torch

    from shannon_tpu_torch import cli, kernels
    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.eval import evaluate
    from shannon_tpu_torch.io.fastx import read_fastx
    from shannon_tpu_torch.ops import count
    from shannon_tpu_torch.pipeline import assemble
    from shannon_tpu_torch.utils.timing import StageTimer

    if not Path(count.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"shannon_tpu_torch came from {count.__file__}, not {tree}")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0

    merges = []
    merge_at = count.merge_at

    def timed_merge(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = merge_at(*args)
        end.record()
        merges.append((start, end))
        return out

    def merge_row() -> dict:
        torch.cuda.synchronize(dev)
        row = {"calls": len(merges), "ms": sum(s.elapsed_time(e) for s, e in merges)}
        merges.clear()
        return row

    count.merge_at = timed_merge
    truth, reads = smoke._scale_dataset(n_reads)
    assemble(reads[: smoke.PARITY_READS], AssemblyConfig(), device=dev)
    merge_row()

    def single_run() -> dict:
        timer = StageTimer(echo=False)
        t0 = time.perf_counter()
        res = assemble(reads, AssemblyConfig(), device=dev, timer=timer)
        torch.cuda.synchronize(dev)
        e2e = time.perf_counter() - t0
        return {"e2e_s": e2e, "merges": merge_row(), "stages": timer.stages,
                "recall": evaluate(truth, [t.seq for t in res.transcripts], k=24)["recall_exact"]}

    single, single_again = single_run(), single_run()
    del reads

    p_truth, p_reads = smoke._scale_dataset(n_reads, paired=True)
    with tempfile.TemporaryDirectory() as tmp:
        left, right = smoke._write_mates(p_reads, Path(tmp))
        out = Path(tmp) / "out"
        argv = ["-o", str(out), "--left", left, "--right", right, "-K", "24", "--device", "cuda"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        e2e = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"the CLI exited with {rc}")
        seqs = [s for _, s in read_fastx(out / "transcripts.fasta")]
        paired = {"e2e_s": e2e, "merges": merge_row(),
                  "stages": json.loads((out / "stats.json").read_text())["stages"],
                  "recall": evaluate(p_truth, seqs, k=24)["recall_exact"]}
    return {"tree": str(tree), "build_s": build_s, "single": single,
            "single_again": single_again, "paired": paired}


def _single(se: dict) -> str:
    sg = se["stages"]["spectrum+graph"]
    return (f"{se['e2e_s']:.2f} s (count_s {sg['count_s']:.3f}, merges {se['merges']['calls']} x = "
            f"{se['merges']['ms']:.3f} ms, tipclip_s {sg['tipclip_s']:.3f}, threading kernel_s "
            f"{se['stages']['threading']['kernel_s']:.3f}, recall {se['recall']:.4f})")


def _line(run: dict, smi: str) -> str:
    pe = run["paired"]
    psg = pe["stages"]["spectrum+graph"]
    return (f"{run['tree']}: single-end {_single(run['single'])}, again "
            f"{_single(run['single_again'])}; paired CLI {pe['e2e_s']:.2f} s "
            f"(count_s {psg['count_s']:.3f}, merges {pe['merges']['calls']} x = "
            f"{pe['merges']['ms']:.3f} ms, threading kernel_s "
            f"{pe['stages']['threading']['kernel_s']:.3f}, "
            f"dedup_s {pe['stages']['threading']['dedup_s']:.3f}, "
            f"recall {pe['recall']:.4f}) [{smi}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", type=Path, help="tree roots, in the order to run")
    ap.add_argument("--reads", type=int, default=1_000_000,
                    help="reads of each scale phase (the paired one: 2 per pair)")
    ap.add_argument("--out", default=None, help="also write the runs as JSON here")
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run may take")
    args = ap.parse_args(argv)

    if args.child is not None:
        print("RESULT " + json.dumps(child(args.child.resolve(), args.reads)))
        return 0
    if not args.trees:
        ap.error("--trees is required")
    smi = _smoke()._smi()
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(tree.resolve()), "--reads", str(args.reads)],
            capture_output=True, text=True, timeout=args.timeout,
        )
        found = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not found:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            print(f"{tree}: the run failed (exit {proc.returncode})")
            return 1
        runs.append(json.loads(found[-1][len("RESULT "):]))
        print(_line(runs[-1], smi), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump({"card": smi, "runs": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
