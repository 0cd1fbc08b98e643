"""Time two kernels of several trees in turns on one card: K6 (sf_greedy,
the sparse-flow greedy with restarts) and K22 (sibling_maxes), on the same
inputs for every tree, so a change to a kernel's source can be held
against its parent within one call.

    python scripts/kernel_turns.py --trees OLD NEW NEW OLD [--out FILE]

Each tree runs in a fresh process that imports that tree's
shannon_tpu_torch and builds its kernels into that tree's build/ (a tree is
a checkout, e.g. a parent unpacked with git archive into a git-ignored
directory).  Inputs: K6 on chip_smoke.py's 4,096 random jobs (_sf_jobs(7,
4096)) at sf_restarts = 4, where the wrapper's launches weigh as much as
the kernel, and on 65,536 such jobs, where the kernel dominates; K22 on a
canonical k = 24 table of 2^21 lanes holding 2^20 random real keys.
Times: CUDA events around 200 launches, the median of 5 such windows,
after a warm-up.  Prints one JSON line per tree and, with --out, writes
them all.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _inputs(path: Path) -> None:
    import numpy as np

    sys.path.insert(0, str(REPO))
    from chip_smoke import _sf_jobs

    rng = np.random.default_rng(22)
    k, lanes = 24, 1 << 21
    keys = np.unique(rng.integers(0, 1 << (2 * k), 1 << 20, dtype=np.int64))
    table = np.full(lanes, (1 << 63) - 1, np.int64)
    table[: len(keys)] = keys
    counts = np.zeros(lanes, np.int32)
    counts[: len(keys)] = rng.integers(1, 50, len(keys))
    np.savez(path, buf=_sf_jobs(7, 4096), big=_sf_jobs(8, 65_536), key=table, count=counts,
             n=len(keys))


def _child(tree: str, inputs: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import shannon_tpu_torch
    from shannon_tpu_torch.ops.count import Spectrum
    from shannon_tpu_torch.ops.sparseflow import batched_greedy_packed
    from shannon_tpu_torch.ops.spectrum import sibling_maxes

    assert Path(shannon_tpu_torch.__file__).resolve().is_relative_to(Path(tree).resolve())
    dev = torch.device("cuda", 0)
    d = np.load(inputs)
    buf = torch.from_numpy(d["buf"]).to(dev)
    big = torch.from_numpy(d["big"]).to(dev)
    spec = Spectrum(key=torch.from_numpy(d["key"]).to(dev),
                    count=torch.from_numpy(d["count"]).to(dev), n=int(d["n"]))

    def median_ms(fn, reps: int = 200, windows: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(windows):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return sorted(times)[windows // 2]

    print(json.dumps({
        "tree": tree,
        "sf_greedy_ms": median_ms(lambda: batched_greedy_packed(buf, 4)),
        "sf_greedy_65536_ms": median_ms(lambda: batched_greedy_packed(big, 4)),
        "sibling_maxes_ms": median_ms(lambda: sibling_maxes(spec, 24, True)),
        "card": torch.cuda.get_device_name(0),
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", nargs=2, metavar=("TREE", "INPUTS"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(*args.child)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.npz"
        _inputs(inputs)
        for tree in args.trees:
            proc = subprocess.run(
                [sys.executable, __file__, "--trees", tree, "--child", tree, str(inputs)],
                capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                return proc.returncode
            rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps({**rows[-1], "smi": smi}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
