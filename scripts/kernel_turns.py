"""Time kernels of several trees in turns on one card: K6 (sf_greedy, the
sparse-flow greedy with restarts), K22 (sibling_maxes), K10 (compact_keep)
and K2 (reduce_sorted, three inputs), on the same inputs for every tree, so
a change to a kernel's source can be held against its parent within one
call.

    python scripts/kernel_turns.py --trees OLD NEW NEW OLD [--out FILE]

Each tree runs in a fresh process that imports that tree's
shannon_tpu_torch and builds its kernels into that tree's build/ (a tree is
a checkout, e.g. a parent unpacked with git archive into a git-ignored
directory).  Inputs, made once from seeds on the host with the plain
versions: K6 on chip_smoke.py's 4,096 random jobs (_sf_jobs(7, 4096)) at
sf_restarts = 4, where the wrapper's launches weigh as much as the kernel,
and on 65,536 such jobs, where the kernel dominates; K22 on a canonical
k = 24 table of 2^21 lanes holding 2^20 random real keys; K10 at
chip_smoke.py's shape (12,582,912 lanes, 10,689,722 of them real random
sorted keys, 3,653,479 of those kept at random); K2 on chip_smoke.py's
kernel-phase inputs (the sorted window keys of 65,536 random 100 bp reads,
k = 24, canonical, into 2^22 lanes: "unit"; the sorted union of two such
tables with their counts: "merge") and on the first read batch of its
1,000,000-read scale dataset ("batch", what the main path gives K2), all
built by chip_smoke.window_keys.  Times: CUDA events around 200 calls, the
median of 5 such windows, after a warm-up.  After the timings each tree
traces 20 calls of K10 and of each K2 input with torch.profiler and reports
the device time a call of every kernel and copy they launched
("device_us"), so the window's time splits into device work and the card's
idle gaps.  Prints one JSON line per tree and, with --out, writes them
all.
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
    import torch

    sys.path.insert(0, str(REPO))
    from chip_smoke import _scale_dataset, _sf_jobs, window_keys
    from shannon_tpu_torch.ops.count import reduce_sorted_plain

    rng = np.random.default_rng(22)
    k, lanes = 24, 1 << 21
    keys = np.unique(rng.integers(0, 1 << (2 * k), 1 << 20, dtype=np.int64))
    table = np.full(lanes, (1 << 63) - 1, np.int64)
    table[: len(keys)] = keys
    counts = np.zeros(lanes, np.int32)
    counts[: len(keys)] = rng.integers(1, 50, len(keys))

    # K10: chip_smoke.py's correction-phase shape, made at random
    C, real, kept = 12_582_912, 10_689_722, 3_653_479
    rng = np.random.default_rng(10)
    c_key = np.full(C, (1 << 63) - 1, np.int64)
    c_key[:real] = np.sort(rng.choice(1 << 48, size=real, replace=False))
    c_count = np.zeros(C, np.int32)
    c_count[:real] = rng.integers(1, 50, real)
    c_keep = np.zeros(C, bool)
    c_keep[rng.choice(real, size=kept, replace=False)] = True

    # K2: chip_smoke.py's kernel-phase keys and the scale dataset's first
    # read batch, built by its window_keys on the host
    cpu, cap = torch.device("cpu"), 1 << 22
    unit = window_keys(cpu, seed=1)
    ta = reduce_sorted_plain(unit, None, cap)
    tb = reduce_sorted_plain(window_keys(cpu, seed=2), None, cap)
    mkeys, order = torch.sort(torch.cat([ta[0], tb[0]]))
    mcounts = torch.cat([ta[1], tb[1]])[order]
    bkeys = window_keys(cpu, reads=_scale_dataset(1_000_000)[1])
    np.savez(path, buf=_sf_jobs(7, 4096), big=_sf_jobs(8, 65_536), key=table, count=counts,
             n=len(keys), c_key=c_key, c_count=c_count, c_keep=c_keep, unit=unit.numpy(),
             mkeys=mkeys.numpy(), mcounts=mcounts.numpy(),
             bkeys=bkeys.numpy())


def _device_us(fn, calls: int = 20) -> dict:
    """Device microseconds a call of each kernel and copy fn launches, from
    a torch.profiler trace of `calls` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key[:60]] = us / calls
    return out


def _child(tree: str, inputs: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import shannon_tpu_torch
    from shannon_tpu_torch.ops.correction import compact
    from shannon_tpu_torch.ops.count import Spectrum, reduce_sorted
    from shannon_tpu_torch.ops.sparseflow import batched_greedy_packed
    from shannon_tpu_torch.ops.spectrum import sibling_maxes

    assert Path(shannon_tpu_torch.__file__).resolve().is_relative_to(Path(tree).resolve())
    dev = torch.device("cuda", 0)
    d = np.load(inputs)

    def on_card(name: str) -> torch.Tensor:
        return torch.from_numpy(d[name]).to(dev)

    buf, big = on_card("buf"), on_card("big")
    spec = Spectrum(key=on_card("key"), count=on_card("count"), n=int(d["n"]))
    table = Spectrum(key=on_card("c_key"), count=on_card("c_count"), n=int(d["c_key"].shape[0]))
    keep = on_card("c_keep")
    unit, mkeys, mcounts, bkeys = (on_card(x) for x in ("unit", "mkeys", "mcounts", "bkeys"))
    cap = 1 << 22

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

    row = {
        "tree": tree,
        "sf_greedy_ms": median_ms(lambda: batched_greedy_packed(buf, 4)),
        "sf_greedy_65536_ms": median_ms(lambda: batched_greedy_packed(big, 4)),
        "sibling_maxes_ms": median_ms(lambda: sibling_maxes(spec, 24, True)),
        "compact_keep_ms": median_ms(lambda: compact(table, keep)),
        "compact_keep_n": compact(table, keep).n,
        "reduce_sorted_unit_ms": median_ms(lambda: reduce_sorted(unit, None, cap)),
        "reduce_sorted_merge_ms": median_ms(lambda: reduce_sorted(mkeys, mcounts, cap)),
        "reduce_sorted_batch_ms": median_ms(lambda: reduce_sorted(bkeys, None, cap)),
        "reduce_sorted_n": [reduce_sorted(x, c, cap)[3]
                            for x, c in ((unit, None), (mkeys, mcounts), (bkeys, None))],
        "card": torch.cuda.get_device_name(0),
        # after the timings, so the traces cannot disturb them
        "device_us": {
            "compact_keep": _device_us(lambda: compact(table, keep)),
            "reduce_sorted_unit": _device_us(lambda: reduce_sorted(unit, None, cap)),
            "reduce_sorted_merge": _device_us(lambda: reduce_sorted(mkeys, mcounts, cap)),
            "reduce_sorted_batch": _device_us(lambda: reduce_sorted(bkeys, None, cap)),
        },
    }
    print(json.dumps(row), flush=True)


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
