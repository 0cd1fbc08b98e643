"""Where the time of the PyTorch/CUDA port goes, on one NVIDIA GPU.

    python scripts/profile_torch.py [--reads N [N ...]] [--paired] [--out report.json]

For each read count: simulate chip_smoke.py's scale dataset (single-end, or
with --paired its 100 bp mates of 250 bp inserts), run
shannon_tpu_torch.pipeline.assemble on CUDA twice in one process (the first
run pays the kernel build, CUDA context and allocator warm-up; the second is
the steady number) and trace the second run with torch.profiler.  Prints
each run's end-to-end seconds and StageTimer split, the device busy share of
the traced run (device time of all kernels and copies over its wall time),
and the top device operators.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from chip_smoke import _scale_dataset, _smi  # noqa: E402
from shannon_tpu_torch.config import AssemblyConfig  # noqa: E402
from shannon_tpu_torch.utils.timing import StageTimer  # noqa: E402
from shannon_tpu_torch.pipeline import assemble  # noqa: E402


def _run(reads, dev, paired: bool, profiler=None) -> dict:
    """One assembly; its wall time excludes the profiler's start and stop
    (the first start in a process takes seconds)."""
    timer = StageTimer(echo=False)
    with profiler or contextlib.nullcontext():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = assemble(reads, AssemblyConfig(), device=dev, timer=timer, paired=paired)
        torch.cuda.synchronize(dev)
        e2e = time.perf_counter() - t0
    return {"e2e_s": e2e, "n_transcripts": len(res.transcripts), "stages": timer.stages}


def profile(n_reads: int, dev, smi: str, paired: bool) -> dict:
    _truth, reads = _scale_dataset(n_reads, paired=paired)
    cold = _run(reads, dev, paired)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    )
    warm = _run(reads, dev, paired, prof)
    events = prof.key_averages()
    # kernels and copies are the events of device type CUDA; an operator's
    # own self device time repeats theirs (torch's table sums the same way)
    device_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    table = events.table(sort_by="self_cuda_time_total", row_limit=25)
    busy = device_us / 1e6 / warm["e2e_s"]
    print(f"{len(reads)} {'paired' if paired else 'single-end'} reads: cold {cold['e2e_s']:.3f} s, warm (traced) "
          f"{warm['e2e_s']:.3f} s; device time {device_us / 1e6:.3f} s, "
          f"busy share {busy:.4f} [{smi}]")
    for run, name in ((cold, "cold"), (warm, "warm")):
        print(f"  {name} stages " + json.dumps(run["stages"]))
    print(table)
    return {"n_reads": len(reads), "paired": paired, "runs": [cold, warm], "device_s": device_us / 1e6,
            "busy_share": busy, "top_ops": table}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, nargs="+", default=[1_000_000])
    ap.add_argument("--paired", action="store_true",
                    help="paired-end reads (interleaved mates) instead of single-end")
    ap.add_argument("--out", default=None, help="also write the report as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = _smi()
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    for n in args.reads:
        report[str(n)] = profile(n, dev, smi, args.paired)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
