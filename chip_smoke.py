#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (shannon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--reads N] [--out report.json]

Phases; any failure exits nonzero:
  0. versions, and the card's name and power limit (nvidia-smi);
  1. build the hand-written kernels from shannon_tpu_torch/csrc with nvcc;
  2. kernels: K1 (k-mer extraction), K2 (sorted-run reduction) and K3
     (sorted-table lookup) against their plain PyTorch versions on the
     card, at the main path's shapes (65,536 reads of 100 bp at pad 128,
     k = 24; a 2^22-lane table), exact integer equality, both timed;
  3. parity: on 3,000 reads of the scale dataset, assemble on CUDA gives
     the same corrected spectrum, contig arrays and transcripts as on the
     CPU (plain versions), and the same canonical set as the pure-Python
     oracle;
  4. scale: assemble on CUDA at the default AssemblyConfig (k = 24) on the
     dataset of scripts/measure_e2e.py (seed 11, 500 transcripts x 1,500 bp,
     log-normal abundance sigma 1, 100 bp reads, 1% error), with the launch
     count of every kernel over that run; fails below 0.99 exact recall.

The last two lines of standard output are one JSON object with the kernels'
launches, errors and times, and one JSON object {"ok": true, "device": ...}.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# Reads of the scale dataset in the parity phase (seed 3 picks them): small
# enough for the pure-Python oracle to finish in about a minute.
PARITY_READS = 3000


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches (CUDA events, warmed)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _alternate(kernel, plain, reps: int = 10) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = _time_ms(plain, reps)
    k1 = _time_ms(kernel, reps)
    k2 = _time_ms(kernel, reps)
    p2 = _time_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _max_abs_err(got, want) -> float:
    """0.0 when the integer outputs are equal; raises otherwise."""
    import torch

    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise AssertionError(f"kernel disagrees with its plain version ({bad} lanes)")
    return 0.0


def _scale_dataset(n_reads: int):
    import numpy as np

    from shannon_tpu.sim import sample_reads, simulate_transcripts

    rng = np.random.default_rng(11)
    n_tr, tlen = 500, 1500
    cov = n_reads * 100 / (n_tr * tlen)
    abund = np.exp(rng.normal(0, 1, n_tr))
    abund = (abund / abund.mean()).tolist()
    truth = simulate_transcripts(rng, n=n_tr, length=tlen)
    reads = sample_reads(
        rng, truth, abundances=abund, coverage=cov, read_length=100, error_rate=0.01
    )
    return truth, reads


def kernel_phase(dev, smi: str) -> dict:
    """K1-K3 against their plain versions at the main path's shapes."""
    import numpy as np
    import torch

    from shannon_tpu.io.pack import invalid_mask_words, pack_words
    from shannon_tpu_torch.ops.count import reduce_sorted, reduce_sorted_plain
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed, extract_kmers_packed_plain
    from shannon_tpu_torch.ops.spectrum import lookup_sorted, lookup_sorted_plain

    n, pad, k, cap = 65_536, 128, 24, 1 << 22

    def batch(seed: int, with_n: bool):
        rng = np.random.default_rng(seed)
        codes = np.full((n, pad), 4, np.uint8)
        codes[:, :100] = rng.integers(0, 4, (n, 100))
        if with_n:  # one N in the middle of every other read
            rows = np.arange(0, n, 2)
            codes[rows, rng.integers(20, 80, rows.shape[0])] = 4
        lengths = np.full(n, 100, np.int32)
        words = torch.from_numpy(pack_words(codes).view(np.int32)).to(dev)
        m = invalid_mask_words(codes, lengths)
        mask = None if m is None else torch.from_numpy(m.view(np.int32)).to(dev)
        return words, torch.from_numpy(lengths).to(dev), mask

    out = {}
    errs, times = [], []
    for canonical in (True, False):
        for with_n in (False, True):
            words, lengths, mask = batch(1, with_n)
            args = (words, lengths, k, canonical, pad, mask)
            err = _max_abs_err(extract_kmers_packed(*args), extract_kmers_packed_plain(*args))
            errs.append(err)
            times.append(_alternate(
                lambda: extract_kmers_packed(*args), lambda: extract_kmers_packed_plain(*args)
            ))
            print(f"K1 extract_kmers canonical={canonical} mask={with_n}: exact; "
                  f"kernel {times[-1][0]:.4f} ms, plain {times[-1][1]:.4f} ms [{smi}]")
    # the main path's case: canonical, no mask
    out["extract_kmers"] = {"max_abs_err": max(errs), "ms": times[0][0], "plain_ms": times[0][1]}

    words, lengths, _ = batch(1, False)
    keys_a = torch.sort(extract_kmers_packed(words, lengths, k, True, pad)[0].reshape(-1)).values
    words_b, lengths_b, _ = batch(2, False)
    keys_b = torch.sort(extract_kmers_packed(words_b, lengths_b, k, True, pad)[0].reshape(-1)).values
    unit = (keys_a, None, cap)
    got, want = reduce_sorted(*unit), reduce_sorted_plain(*unit)
    if got[3] != want[3]:
        raise AssertionError(f"K2 n {got[3]} != {want[3]}")
    c = min(got[3], cap)
    err = _max_abs_err((got[0], got[1], got[2][:c]), (want[0], want[1], want[2][:c]))
    t_unit = _alternate(lambda: reduce_sorted(*unit), lambda: reduce_sorted_plain(*unit))
    print(f"K2 reduce_sorted unit, {keys_a.numel()} keys -> {got[3]} runs: exact; "
          f"kernel {t_unit[0]:.4f} ms, plain {t_unit[1]:.4f} ms [{smi}]")
    table_a = got
    table_b = reduce_sorted(keys_b, None, cap)
    mkeys, order = torch.sort(torch.cat([table_a[0], table_b[0]]))
    mcounts = torch.cat([table_a[1], table_b[1]])[order]
    merge = (mkeys, mcounts, cap)
    got, want = reduce_sorted(*merge), reduce_sorted_plain(*merge)
    if got[3] != want[3]:
        raise AssertionError(f"K2 merge n {got[3]} != {want[3]}")
    c = min(got[3], cap)
    err = max(err, _max_abs_err((got[0], got[1], got[2][:c]), (want[0], want[1], want[2][:c])))
    t_merge = _alternate(lambda: reduce_sorted(*merge), lambda: reduce_sorted_plain(*merge))
    print(f"K2 reduce_sorted merge, {mkeys.numel()} keys -> {got[3]} runs: exact; "
          f"kernel {t_merge[0]:.4f} ms, plain {t_merge[1]:.4f} ms [{smi}]")
    out["reduce_sorted"] = {"max_abs_err": err, "ms": t_unit[0], "plain_ms": t_unit[1]}

    query = extract_kmers_packed(words, lengths, k, True, pad)[0]
    table = table_a[0]
    got, want = lookup_sorted(table, query), lookup_sorted_plain(table, query)
    err = _max_abs_err(got, want)
    t = _alternate(lambda: lookup_sorted(table, query), lambda: lookup_sorted_plain(table, query))
    print(f"K3 lookup_sorted {query.numel()} queries in {table.numel()} lanes: exact; "
          f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms [{smi}]")
    out["lookup_sorted"] = {"max_abs_err": err, "ms": t[0], "plain_ms": t[1]}
    return out


def parity_phase(reads, n_parity: int, dev) -> None:
    """CUDA == CPU (plain versions) == oracle on a subset of the reads."""
    import numpy as np
    import torch

    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.io.pack import pack_reads
    from shannon_tpu.oracle import assemble_oracle
    from shannon_tpu_torch.pipeline import assemble, spectrum_device

    rng = np.random.default_rng(3)
    sub = [reads[i] for i in np.sort(rng.choice(len(reads), n_parity, replace=False))]
    cfg = AssemblyConfig(kmer_capacity=1 << 18)
    batch = pack_reads(sub, pad_length=cfg.read_pad_length)
    g_spec, g_ca = spectrum_device(batch, cfg, dev)
    c_spec, c_ca = spectrum_device(batch, cfg, "cpu")
    if g_spec.n != c_spec.n or not (
        torch.equal(g_spec.key.cpu(), c_spec.key) and torch.equal(g_spec.count.cpu(), c_spec.count)
    ):
        raise AssertionError("corrected spectrum differs between CUDA and CPU")
    if (g_ca is None) != (c_ca is None):
        raise AssertionError("contig arrays differ between CUDA and CPU")
    if g_ca is not None:
        for f in ("node_key", "node_count", "node_cid", "node_off", "klen", "abundance",
                  "count_sum", "head_lane", "tail_lane", "out_edges", "rc_pair"):
            a, b = getattr(g_ca, f).cpu(), getattr(c_ca, f)
            if not torch.equal(a, b):
                raise AssertionError(f"contig arrays differ between CUDA and CPU: {f}")
    gpu = assemble(sub, cfg, device=dev)
    cpu = assemble(sub, cfg, device="cpu")
    if [(t.seq, t.abundance) for t in gpu.transcripts] != [
        (t.seq, t.abundance) for t in cpu.transcripts
    ]:
        raise AssertionError("transcripts differ between CUDA and CPU")
    t0 = time.perf_counter()
    orc = assemble_oracle(sub, cfg)
    if gpu.canonical_set() != orc.canonical_set():
        raise AssertionError("transcripts differ between CUDA and the oracle")
    print(f"parity: {n_parity} reads, {g_spec.n} corrected k-mers, "
          f"{len(gpu.transcripts)} transcripts: CUDA == CPU == oracle "
          f"(oracle {time.perf_counter() - t0:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--out", default=None, help="also write the report as JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = _smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from shannon_tpu.config import AssemblyConfig
    from shannon_tpu.eval import evaluate
    from shannon_tpu.utils.timing import StageTimer
    from shannon_tpu_torch import kernels
    from shannon_tpu_torch.pipeline import assemble

    t0 = time.perf_counter()
    _path, log = kernels.build(force=True)
    lib = kernels.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s, nvcc for sm_90a")
    for line in log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print("  " + line.strip())

    report = {"card": smi, "build_s": build_s}
    report["kernels"] = kernel_phase(dev, smi)

    t0 = time.perf_counter()
    truth, reads = _scale_dataset(args.reads)
    print(f"scale dataset: {len(reads)} reads simulated in {time.perf_counter() - t0:.1f} s")
    parity_phase(reads, PARITY_READS, dev)

    timer = StageTimer(echo=True)
    torch.cuda.reset_peak_memory_stats(dev)
    lib.reset_counts()
    t0 = time.perf_counter()
    res = assemble(reads, AssemblyConfig(), device=dev, timer=timer)
    torch.cuda.synchronize(dev)
    e2e = time.perf_counter() - t0
    launches = dict(lib.launches)
    quality = evaluate(truth, [t.seq for t in res.transcripts], k=24)
    scale = {
        "n_reads": len(reads),
        "e2e_s": e2e,
        "reads_per_s": len(reads) / e2e,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
        "stages": timer.stages,
        "stats": res.stats,
        "quality": quality,
        "launches": launches,
    }
    report["scale"] = scale
    print(f"scale: {len(reads)} reads in {e2e:.2f} s = {len(reads) / e2e:.1f} reads/s, "
          f"peak device memory {scale['max_memory_allocated_bytes'] / 2**30:.2f} GiB [{smi}]")
    print("stages " + json.dumps(timer.stages))
    print("quality " + json.dumps(quality))
    report["wall_s"] = time.perf_counter() - t_start
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    if quality["recall_exact"] < 0.99:
        raise AssertionError(f"exact recall {quality['recall_exact']} < 0.99")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")

    source = "shannon_tpu_torch/csrc/kernels.cu"
    replaces = {
        "extract_kmers": "shannon_tpu/ops/kmers.py:151",
        "reduce_sorted": "shannon_tpu/ops/count.py:158",
        "lookup_sorted": "shannon_tpu/ops/spectrum.py:137",
    }
    rows = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces[name],
         "launches": launches[name], **report["kernels"][name]}
        for name in replaces
    ]
    print(f"total {report['wall_s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
