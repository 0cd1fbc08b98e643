"""Time kernels of several trees in turns on one card: K6 (sf_greedy, the
sparse-flow greedy with restarts), K22 (sibling_maxes), K10 (compact_keep),
K2 (reduce_sorted, three inputs), K7 (probe_lookup, both probe sets) and K3
(lookup_sorted, two inputs), on the same inputs for every tree, so a change
to a kernel's source can be held against its parent within one call.

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
built by chip_smoke.window_keys.  K7 and K3 on the main path's own
inputs, built once on the card by this checkout's kernels (each is exact
against its plain version, so every tree gets the same arrays): K7 on the
counted, shrunk spectrum of the 1,000,000-read scale dataset at the default
AssemblyConfig (12,582,912 lanes, k = 24, canonical), "sib" and "ext"; K3
("lookup_main") on that dataset's node table after tip clip
(pipeline.spectrum_device on all of its reads, 4,194,304 lanes) queried with
its first read batch's non-canonical windows, as threading queries it; and
K3 ("lookup_random") on chip_smoke.py's kernel-phase row (the canonical
windows of 65,536 random reads in the unit table of K2's input).  Beside
each, torch.searchsorted on the same table and queries (K7's probes
materialized by probe_keys), timed in the same process.  Times: CUDA events
around 200 calls (20 for K7 and its searchsorted), the median of 5 such
windows, after a warm-up.  After the timings each tree traces 20 calls of
K10, of each K2 input and of each K7 and K3 input and its searchsorted with
torch.profiler and reports the device time a call of every kernel and copy
they launched ("device_us"), so the window's time splits into device work
and the card's idle gaps.  Prints one JSON line per tree and, with --out,
writes them all.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _search_inputs() -> dict:
    """K7's and K3's inputs (numpy), built on the card."""
    import torch

    from chip_smoke import BATCH_READS, KERNEL_K, KERNEL_PAD, _random_batch, _scale_dataset
    from chip_smoke import window_keys
    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops.count import count_reads_spectrum, reduce_sorted, shrink_spectrum
    from shannon_tpu_torch.ops.count import upload_words
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed
    from shannon_tpu_torch.pipeline import spectrum_device

    dev, cfg = torch.device("cuda", 0), AssemblyConfig()
    reads = _scale_dataset(1_000_000)[1]
    spec = shrink_spectrum(count_reads_spectrum(
        pack_reads(reads, pad_length=cfg.read_pad_length), k=cfg.k, capacity=cfg.kmer_capacity,
        canonical=not cfg.strand_specific, batch_reads=cfg.batch_reads, device=dev,
    ))
    _spec, ca = spectrum_device(pack_reads(reads, pad_length=cfg.read_pad_length), cfg, dev)
    batch = pack_reads(reads[:BATCH_READS], pad_length=128)
    m = batch.mask_rows(0, batch.n_reads)
    windows, _ = extract_kmers_packed(
        upload_words(batch.words, dev), torch.from_numpy(batch.lengths).to(dev), cfg.k, False,
        batch.pad_length, None if m is None else upload_words(m, dev),
    )
    words, lengths, _ = _random_batch(1, False, dev)
    r_query = extract_kmers_packed(words, lengths, KERNEL_K, True, KERNEL_PAD)[0]
    r_table = reduce_sorted(window_keys(dev, seed=1), None, 1 << 22)[0]
    out = {"p_key": spec.key, "node_key": ca.node_key, "windows": windows,
           "r_table": r_table, "r_query": r_query}
    out = {name: x.cpu().numpy() for name, x in out.items()}
    torch.cuda.empty_cache()
    return out


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
             bkeys=bkeys.numpy(), **_search_inputs())


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
    from shannon_tpu_torch.ops.correction import compact, probe_resolve
    from shannon_tpu_torch.ops.count import Spectrum, reduce_sorted
    from shannon_tpu_torch.ops.sparseflow import batched_greedy_packed
    from shannon_tpu_torch.ops.spectrum import lookup_sorted, probe_keys, sibling_maxes

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
    p_key = on_card("p_key")
    probes = Spectrum(key=p_key, count=torch.ones_like(p_key, dtype=torch.int32),
                      n=int((d["p_key"] != (1 << 63) - 1).sum()))
    lookups = {"lookup_main": (on_card("node_key"), on_card("windows")),
               "lookup_random": (on_card("r_table"), on_card("r_query"))}

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

    search = {}
    for side in ("sib", "ext"):
        q = probe_keys(p_key, 24, side, True)
        search[f"probe_lookup_{side}"] = (lambda s=side: probe_resolve(probes, 24, True, s),
                                          lambda q=q: torch.searchsorted(p_key, q), 20)
    for name, (keys, queries) in lookups.items():
        search[name] = (lambda t=keys, q=queries: lookup_sorted(t, q),
                        lambda t=keys, q=queries: torch.searchsorted(t, q.reshape(-1)), 200)
    search_ms = {}
    for name, (fn, library, reps) in search.items():
        search_ms[f"{name}_ms"] = median_ms(fn, reps)
        search_ms[f"{name}_searchsorted_ms"] = median_ms(library, reps)

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
        **search_ms,
        "card": torch.cuda.get_device_name(0),
        # after the timings, so the traces cannot disturb them
        "device_us": {
            "compact_keep": _device_us(lambda: compact(table, keep)),
            "reduce_sorted_unit": _device_us(lambda: reduce_sorted(unit, None, cap)),
            "reduce_sorted_merge": _device_us(lambda: reduce_sorted(mkeys, mcounts, cap)),
            "reduce_sorted_batch": _device_us(lambda: reduce_sorted(bkeys, None, cap)),
            **{name: _device_us(fn) for name, (fn, _lib, _reps) in search.items()},
            **{f"{name}_searchsorted": _device_us(lib) for name, (_fn, lib, _r) in search.items()},
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
