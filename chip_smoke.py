#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (shannon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--reads N] [--out report.json]

Phases; any failure exits nonzero:
  0. versions, the card's name and power limit (nvidia-smi), and which
     route parses input files (shannon_tpu_torch.native: C++ or pure Python);
  1. build the hand-written kernels from shannon_tpu_torch/csrc with nvcc
     (one nvcc per source, all started together);
  2. kernels, each against its plain PyTorch version on the card at the
     main path's shapes, exact equality, both timed: K1 (k-mer
     extraction), K2 (sorted-run reduction) and K3 (sorted-table lookup) on
     65,536 reads of 100 bp at pad 128, k = 24, a 2^22-lane table; K4
     (threading run scan) and K5 (across-read compaction) on the first
     65,536 reads of the scale dataset against the contig arrays
     spectrum_device builds from them; K7 (probe lookup, both probe sets),
     K8 (one rescue round from the cut counts), K9 (one prune round) and K10
     (compaction of the final keep mask) on the counted, shrunk spectrum of
     the whole single-end scale dataset at the default AssemblyConfig, then
     the whole correct_spectrum there against its CPU run, and K9 on a
     synthetic grid (every count 1..255 against every sibling maximum
     1..4095, error_rate 0.01 and 0.02); K6 (sparse-flow greedy) on 4,096
     random jobs of 1-8 by 1-8 margins at sf_restarts = 4, and the batched
     solver (K6) against the host solve_node loop on rounds of 8, 32 and
     128 X-nodes.  Each kernel row also times the one PyTorch call that
     computes the same function, where there is one (library_ms), and gives
     the least time the card could take (bound_ms: bytes over 3.35 TB/s or
     operations over 67 TFLOP/s, whichever is larger);
  3. parity: on 3,000 reads of the scale dataset, assemble on CUDA gives
     the same corrected spectrum, contig arrays and transcripts as on the
     CPU (plain versions), and the same canonical set as the pure-Python
     oracle; on 1,500 pairs of the paired scale dataset, assemble(paired=
     True) on CUDA gives the CPU's transcripts, and run_pipeline on CUDA
     from two mate files gives the in-memory route's spectrum and
     transcripts;
  4. single-end scale: assemble on CUDA at the default AssemblyConfig
     (k = 24) on the dataset of scripts/measure_e2e.py (seed 11, 500
     transcripts x 1,500 bp, log-normal abundance sigma 1, 100 bp reads, 1%
     error); fails below 0.99 exact recall;
  5. paired scale, through the CLI: the same transcriptome sampled as
     100 bp mates with insert 250 (1% error), written as two FASTA files,
     run by shannon_tpu_torch.cli.main on CUDA, then run again on the same
     out-dir, where every stage must be skipped (resume); fails below the
     reference's exact recall on this dataset (PAIRED_RECALL_GATE).
Every kernel must launch at least once in each scale phase (counts set to
0 just before the phase and read just after); K8 (dead-end rescue) runs only
when the phase's auto abundance cut is above 1, and is exempt where it is 1.

The last two lines of standard output are one JSON object with the kernels'
launches, errors and times, and one JSON object {"ok": true, "device": ...}.
Imports nothing of JAX and nothing of the JAX package (shannon_tpu).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Reads of the scale dataset in the parity phase (seed 3 picks them): small
# enough for the pure-Python oracle to finish in about a minute.
PARITY_READS = 3000
# Mate pairs of the paired scale dataset in the paired parity phase.
PARITY_PAIRS = 1500
# Exact recall the paired scale phase must reach: the reference's own figure
# on this dataset.  The paired simulator gives each transcript's first and
# last k-mers few reads, the auto abundance cut drops them at the lowest
# abundances, and those transcripts come out 1-3 bases short (partial
# recall stays 1.0).  The JAX package gives the same transcripts and 0.94
# on a 100k-read cut of the dataset (PERF.md, PR 2).
PAIRED_RECALL_GATE = 0.94
# Read batch of the main path (AssemblyConfig.batch_reads), the rows K4-K6's
# phase threads.
BATCH_READS = 65_536

# The TPU program each kernel replaces (PERF.md section 6).
REPLACES = {
    "extract_kmers": ("shannon_tpu_torch/csrc/kernels.cu", "shannon_tpu/ops/kmers.py:151"),
    "reduce_sorted": ("shannon_tpu_torch/csrc/kernels.cu", "shannon_tpu/ops/count.py:158"),
    "lookup_sorted": ("shannon_tpu_torch/csrc/kernels.cu", "shannon_tpu/ops/spectrum.py:137"),
    "thread_rows": ("shannon_tpu_torch/csrc/thread.cu", "shannon_tpu/ops/thread.py:104"),
    "compact_rows": ("shannon_tpu_torch/csrc/thread.cu", "shannon_tpu/ops/thread.py:178"),
    "sf_greedy": ("shannon_tpu_torch/csrc/sparseflow.cu", "shannon_tpu/ops/sparseflow.py:88"),
    "probe_lookup": ("shannon_tpu_torch/csrc/correction.cu", "shannon_tpu/ops/correction.py:78"),
    "rescue_round": ("shannon_tpu_torch/csrc/correction.cu", "shannon_tpu/ops/correction.py:143"),
    "prune_round": ("shannon_tpu_torch/csrc/correction.cu", "shannon_tpu/ops/correction.py:184"),
    "compact_keep": ("shannon_tpu_torch/csrc/correction.cu", "shannon_tpu/ops/correction.py:19"),
}

# Peak rates of one H100 SXM for bound_ms (NVIDIA's data sheet): device
# memory bandwidth, and float32 / integer operations outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


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


def _nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def _row(err: float, t: tuple[float, float], bytes_: float, ops: float,
         library_ms: float | None) -> dict:
    """One kernel's entry of the kernels line: exactness, kernel and plain
    ms, the bound (bytes each input read once and each output written once
    over the memory rate, or operations over the peak rate, the larger) and
    the library call's ms (None where no one PyTorch call does the same)."""
    by_bytes, by_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return {"max_abs_err": err, "ms": t[0], "plain_ms": t[1],
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms}


def _print_row(label: str, row: dict, smi: str) -> None:
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
    print(f"{label}: exact; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library call {lib}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) [{smi}]")


def _scale_dataset(n_reads: int, paired: bool = False):
    """The scale transcriptome (seed 11) and n_reads reads of it: 100 bp
    single-end reads, or 100 bp mates of 250 bp inserts interleaved
    [L0, R0, ...]; 1% substitution error."""
    import numpy as np

    from shannon_tpu_torch.sim import sample_paired_reads, sample_reads, simulate_transcripts

    rng = np.random.default_rng(11)
    n_tr, tlen = 500, 1500
    cov = n_reads * 100 / (n_tr * tlen)
    abund = np.exp(rng.normal(0, 1, n_tr))
    abund = (abund / abund.mean()).tolist()
    truth = simulate_transcripts(rng, n=n_tr, length=tlen)
    if paired:
        reads = sample_paired_reads(
            rng, truth, abundances=abund, coverage=cov, read_length=100, insert_size=250,
            error_rate=0.01,
        )
    else:
        reads = sample_reads(
            rng, truth, abundances=abund, coverage=cov, read_length=100, error_rate=0.01
        )
    return truth, reads


def _write_mates(reads, directory: Path) -> tuple[str, str]:
    from shannon_tpu_torch.io.fastx import write_fasta

    left, right = directory / "left.fasta", directory / "right.fasta"
    write_fasta(left, ((f"p{i}/1", s) for i, s in enumerate(reads[0::2])))
    write_fasta(right, ((f"p{i}/2", s) for i, s in enumerate(reads[1::2])))
    return str(left), str(right)


def kernel_phase(dev, smi: str) -> dict:
    """K1-K3 against their plain versions at the main path's shapes, with
    the one PyTorch call that computes the same (torch.unique_consecutive
    for K2, torch.searchsorted for K3)."""
    import math

    import numpy as np
    import torch

    from shannon_tpu_torch.io.pack import invalid_mask_words, pack_words
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
    rows = []
    for canonical in (True, False):
        for with_n in (False, True):
            words, lengths, mask = batch(1, with_n)
            args = (words, lengths, k, canonical, pad, mask)
            got = extract_kmers_packed(*args)
            err = _max_abs_err(got, extract_kmers_packed_plain(*args))
            t = _alternate(lambda: extract_kmers_packed(*args),
                           lambda: extract_kmers_packed_plain(*args))
            inputs = (words, lengths) if mask is None else (words, lengths, mask)
            # per window: k shift-ors of the forward key and k of its
            # reverse complement
            W = got[0].shape[1]
            rows.append(_row(err, t, _nbytes(*inputs, *got), 2 * n * W * k, None))
            _print_row(f"K1 extract_kmers canonical={canonical} mask={with_n}", rows[-1], smi)
    # the main path's case: canonical, no mask; the error over all four
    out["extract_kmers"] = {**rows[0], "max_abs_err": max(r["max_abs_err"] for r in rows)}

    words, lengths, _ = batch(1, False)
    keys_a = torch.sort(extract_kmers_packed(words, lengths, k, True, pad)[0].reshape(-1)).values
    words_b, lengths_b, _ = batch(2, False)
    keys_b = torch.sort(extract_kmers_packed(words_b, lengths_b, k, True, pad)[0].reshape(-1)).values

    def reduce_row(label, args):
        got, want = reduce_sorted(*args), reduce_sorted_plain(*args)
        if got[3] != want[3]:
            raise AssertionError(f"K2 {label} n {got[3]} != {want[3]}")
        c = min(got[3], cap)
        err = _max_abs_err((got[0], got[1], got[2][:c]), (want[0], want[1], want[2][:c]))
        t = _alternate(lambda: reduce_sorted(*args), lambda: reduce_sorted_plain(*args))
        keys, counts = args[0], args[1]
        inputs = (keys,) if counts is None else (keys, counts)
        library = _time_ms(lambda: torch.unique_consecutive(keys, return_counts=True), 10)
        row = _row(err, t, _nbytes(*inputs, *got[:3]), keys.numel(), library)
        _print_row(f"K2 reduce_sorted {label}, {keys.numel()} keys -> {got[3]} runs", row, smi)
        return got, row

    table_a, row_unit = reduce_row("unit", (keys_a, None, cap))
    table_b = reduce_sorted(keys_b, None, cap)
    mkeys, order = torch.sort(torch.cat([table_a[0], table_b[0]]))
    mcounts = torch.cat([table_a[1], table_b[1]])[order]
    _, row_merge = reduce_row("merge", (mkeys, mcounts, cap))
    out["reduce_sorted"] = {**row_unit, "max_abs_err": max(row_unit["max_abs_err"],
                                                            row_merge["max_abs_err"])}

    query = extract_kmers_packed(words, lengths, k, True, pad)[0]
    table = table_a[0]
    got, want = lookup_sorted(table, query), lookup_sorted_plain(table, query)
    err = _max_abs_err(got, want)
    t = _alternate(lambda: lookup_sorted(table, query), lambda: lookup_sorted_plain(table, query))
    library = _time_ms(lambda: torch.searchsorted(table, query.reshape(-1)), 10)
    steps = math.ceil(math.log2(table.numel())) + 1
    out["lookup_sorted"] = _row(err, t, _nbytes(table, query, *got), query.numel() * steps,
                                library)
    _print_row(f"K3 lookup_sorted {query.numel()} queries in {table.numel()} lanes "
               "(a binary search: latency-bound, not bandwidth-bound)", out["lookup_sorted"], smi)
    return out


def parity_phase(reads, n_parity: int, dev, smi: str) -> None:
    """CUDA == CPU (plain versions) == oracle on a subset of the reads."""
    import numpy as np
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.oracle import assemble_oracle
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
          f"(oracle {time.perf_counter() - t0:.1f} s on the host) [{smi}]")


def thread_phase(reads, dev, smi: str) -> dict:
    """K4 and K5 on the main path's rows: the first BATCH_READS reads of the
    scale dataset threaded through the graph built from them."""
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops import thread as tth
    from shannon_tpu_torch.ops.count import upload_words
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed
    from shannon_tpu_torch.ops.spectrum import lookup_sorted
    from shannon_tpu_torch.pipeline import spectrum_device

    cfg = AssemblyConfig()
    batch = pack_reads(reads[:BATCH_READS], pad_length=128)
    _spec, ca = spectrum_device(batch, cfg, dev)
    if ca is None:
        raise AssertionError("tip clip closed a cycle; no contig arrays to thread")
    m = batch.mask_rows(0, batch.n_reads)
    keys, valid = extract_kmers_packed(
        upload_words(batch.words, dev), torch.from_numpy(batch.lengths).to(dev), cfg.k,
        False, batch.pad_length, None if m is None else upload_words(m, dev),
    )
    idx, hit = lookup_sorted(ca.node_key, keys)
    args = (idx, hit, valid, ca.node_cid, ca.node_off)
    rows = tth.thread_windows_plain(*args)
    err = _max_abs_err(tth.thread_windows(*args), rows)
    t = _alternate(lambda: tth.thread_windows(*args), lambda: tth.thread_windows_plain(*args))
    N, W = idx.shape
    # about ten operations per window: the run state and the row counters
    out = {"thread_rows": _row(err, t, _nbytes(*args, *rows), 10 * N * W, None)}
    _print_row(f"K4 thread_rows {N} reads x {W} windows, {int(rows[2].sum())} events",
               out["thread_rows"], smi)
    compacted = tth.compact_thread_outputs_plain(*rows)
    err = _max_abs_err(tth.compact_thread_outputs(*rows), compacted)
    t = _alternate(lambda: tth.compact_thread_outputs(*rows),
                   lambda: tth.compact_thread_outputs_plain(*rows))
    out["compact_rows"] = _row(err, t, _nbytes(*rows, *compacted), sum(r.numel() for r in rows),
                               None)
    _print_row(f"K5 compact_rows {N} rows", out["compact_rows"], smi)
    return out


def _prune_grid(dev, max_c: int = 255, max_m: int = 4095):
    """K9's float grid: every count 1..max_c against every sibling maximum
    1..max_m, on the right side and on the left.  Lanes [0, max_m) hold the
    sibling counts 1..max_m and probe nothing; each later lane has count c,
    one hit row of its side pointing at the lane of count m and one at a
    lane of count m // 2 (the max must pick m)."""
    import numpy as np
    import torch

    c, m = np.meshgrid(np.arange(1, max_c + 1), np.arange(1, max_m + 1), indexing="ij")
    c, m = np.tile(c.ravel(), 2), np.tile(m.ravel(), 2)
    side = np.repeat([0, 1], c.size // 2)
    lanes = max_m + np.arange(c.size)
    counts = np.concatenate([np.arange(1, max_m + 1), c]).astype(np.int32)
    idx = np.zeros((8, max_m + c.size), np.int64)
    hit = np.zeros(idx.shape, bool)
    idx[side, lanes], hit[side, lanes] = m - 1, True
    idx[side + 4, lanes], hit[side + 4, lanes] = np.maximum(m // 2, 1) - 1, True
    return tuple(torch.from_numpy(x).to(dev) for x in (counts, idx, hit))


def correction_phase(reads, dev, smi: str) -> tuple[dict, dict]:
    """K7-K10 against their plain versions on the main path's input: the
    counted, shrunk spectrum of the whole single-end scale dataset at the
    default AssemblyConfig (k = 24, the auto cut, sibling ratio 0.1, the
    default error_rate); then the whole correct_spectrum there against its
    CPU run (the plain versions), and K9 on the float grid."""
    import math

    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops import correction as tcor
    from shannon_tpu_torch.ops.count import Spectrum, count_reads_spectrum, shrink_spectrum

    cfg = AssemblyConfig()
    k, canonical = cfg.k, not cfg.strand_specific
    spec = shrink_spectrum(count_reads_spectrum(
        pack_reads(reads, pad_length=cfg.read_pad_length), k=k, capacity=cfg.kmer_capacity,
        canonical=canonical, batch_reads=cfg.batch_reads, device=dev,
    ))
    cut = tcor.auto_min_abundance(spec)
    C = spec.capacity
    print(f"correction input: {spec.n} k-mers in {C} lanes, auto cut {cut}, k = {k}, "
          f"error_rate {cfg.error_rate} [{smi}]")
    out, probes = {}, {}
    steps = math.ceil(math.log2(C)) + 1
    for side in ("sib", "ext"):
        def kernel():
            return tcor.probe_resolve(spec, k, canonical, side)

        def plain():
            return tcor.probe_resolve_plain(spec, k, canonical, side)

        probes[side] = kernel()
        err = _max_abs_err(probes[side], plain())
        t = _alternate(kernel, plain)
        q = tcor.probe_keys(spec.key, k, side, canonical)  # materialized for the library call
        library = _time_ms(lambda: torch.searchsorted(spec.key, q), 10)
        del q
        row = _row(err, t, _nbytes(spec.key, *probes[side]), 8 * C * steps, library)
        _print_row(f"K7 probe_lookup side={side}, 8 x {C} probes (a binary search: "
                   "latency-bound, not bandwidth-bound)", row, smi)
        out.setdefault("probe_lookup", row)  # the sibling set is the row kept

    sib, ext = probes["sib"], probes["ext"]
    raw, counts = tcor.cut_counts(spec, cut)
    got = tcor.rescue_round(counts, raw, *sib, *ext)
    want = tcor.rescue_round_plain(counts, raw, *sib, *ext)
    err = _max_abs_err(got[:1], want[:1])
    if got[1] != want[1]:
        raise AssertionError("K8 disagrees with its plain version on the changed flag")
    t = _alternate(lambda: tcor.rescue_round(counts, raw, *sib, *ext),
                   lambda: tcor.rescue_round_plain(counts, raw, *sib, *ext))
    # only a lane the cut dropped reads its 16 probe rows and the idx of its hits
    cand = (raw > 0) & (counts == 0)
    n_cand = int(cand.sum())
    n_hits = int(sib[1][:, cand].sum()) + int(ext[1][:, cand].sum())
    out["rescue_round"] = _row(err, t, 12 * C + 16 * n_cand + 8 * n_hits,
                               C + 48 * n_cand, None)
    _print_row(f"K8 rescue_round {C} lanes, {n_cand} dropped by the cut, "
               f"{int((got[0] != counts).sum())} rescued", out["rescue_round"], smi)
    for _ in range(k + 2):  # the main path's rescue loop, to the K9 input
        nxt, changed = tcor.rescue_round(counts, raw, *sib, *ext)
        if not changed:
            break
        counts = nxt
    del ext, probes["ext"]

    ratio, eps3 = tcor.prune_constants(cfg.sibling_ratio, cfg.error_rate)
    use_cap = cfg.error_rate > 0
    got = tcor.prune_round(counts, *sib, ratio, eps3, use_cap)
    want = tcor.prune_round_plain(counts, *sib, ratio, eps3, use_cap)
    err = _max_abs_err(got[:1], want[:1])
    if got[1] != want[1]:
        raise AssertionError("K9 disagrees with its plain version on the changed flag")
    t = _alternate(lambda: tcor.prune_round(counts, *sib, ratio, eps3, use_cap),
                   lambda: tcor.prune_round_plain(counts, *sib, ratio, eps3, use_cap))
    alive = counts > 0
    n_alive, n_hits = int(alive.sum()), int(sib[1][:, alive].sum())
    out["prune_round"] = _row(err, t, 8 * C + 8 * n_alive + 8 * n_hits, C + 20 * n_alive, None)
    _print_row(f"K9 prune_round {C} lanes, {n_alive} alive, "
               f"{int((got[0] != counts).sum())} pruned", out["prune_round"], smi)
    for er in (0.01, 0.02):
        g_counts, g_idx, g_hit = _prune_grid(dev)
        g_ratio, g_eps3 = tcor.prune_constants(cfg.sibling_ratio, er)
        got = tcor.prune_round(g_counts, g_idx, g_hit, g_ratio, g_eps3, True)
        want = tcor.prune_round_plain(g_counts, g_idx, g_hit, g_ratio, g_eps3, True)
        out["prune_round"]["max_abs_err"] = max(out["prune_round"]["max_abs_err"],
                                                _max_abs_err(got[:1], want[:1]))
        if got[1] != want[1] or not want[1]:
            raise AssertionError("K9 float grid: changed flags differ or nothing pruned")
        print(f"K9 prune_round float grid, error_rate {er}: counts 1..255 x sibling maxima "
              f"1..4095 x 2 sides, {int((got[0] != g_counts).sum())} pruned: exact [{smi}]")
        del g_counts, g_idx, g_hit
    for _ in range(cfg.correction_rounds):  # the main path's prune loop, to K10's mask
        nxt, changed = tcor.prune_round(counts, *sib, ratio, eps3, use_cap)
        if not changed:
            break
        counts = nxt
    del sib, probes

    keep = counts > 0
    got, want = tcor.compact(spec, keep), tcor.compact_plain(spec, keep)
    if got.n != want.n:
        raise AssertionError(f"K10 n {got.n} != {want.n}")
    err = _max_abs_err((got.key, got.count), (want.key, want.count))
    t = _alternate(lambda: tcor.compact(spec, keep), lambda: tcor.compact_plain(spec, keep))
    library = _time_ms(lambda: torch.masked_select(spec.key, keep), 10)
    out["compact_keep"] = _row(err, t, C + 12 * got.n + 12 * C, C, library)
    _print_row(f"K10 compact_keep {C} lanes -> {got.n} kept", out["compact_keep"], smi)

    args = (k, cut, cfg.sibling_ratio, cfg.correction_rounds, canonical, cfg.error_rate)
    cpu = Spectrum(key=spec.key.cpu(), count=spec.count.cpu(), n=spec.n)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    first = tcor.correct_spectrum(spec, *args)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    res = tcor.correct_spectrum(cpu, *args)
    t2 = time.perf_counter()
    if res.n != first.n or not (torch.equal(res.key, first.key.cpu())
                                and torch.equal(res.count, first.count.cpu())):
        raise AssertionError("correct_spectrum on K7-K10 differs from its CPU run")
    print(f"correct_spectrum: {spec.n} -> {first.n} k-mers, on K7-K10 {(t1 - t0) * 1e3:.1f} ms, "
          f"on the host CPU {(t2 - t1) * 1e3:.1f} ms (host clock, one run each): equal [{smi}]")
    stage = {"n_kmers": spec.n, "lanes": C, "auto_cut": cut, "n_corrected": first.n,
             "ms": (t1 - t0) * 1e3, "cpu_ms": (t2 - t1) * 1e3}
    del spec, cpu, first, res, keep, counts, raw
    torch.cuda.empty_cache()
    return out, stage


def _sf_jobs(seed: int, n_jobs: int):
    """n_jobs random jobs of 1-8 by 1-8 margins (one side rescaled to the
    other's total, as node_blocks balances them) and random node seeds."""
    import numpy as np

    from shannon_tpu_torch.ops.sparseflow import MAXD

    rng = np.random.default_rng(seed)
    buf = np.zeros((n_jobs, 2 * MAXD + 1), np.int32)
    f = buf[:, : 2 * MAXD].view(np.float32)
    for r in range(n_jobs):
        M, N = int(rng.integers(1, MAXD + 1)), int(rng.integers(1, MAXD + 1))
        a = rng.uniform(0.5, 40, M).astype(np.float32)
        b = rng.uniform(0.5, 40, N).astype(np.float32)
        f[r, :M] = a
        f[r, MAXD : MAXD + N] = b * (a.sum() / b.sum())
    buf[:, 2 * MAXD] = rng.integers(0, 1 << 32, n_jobs, dtype=np.int64).astype(np.uint32).view(np.int32)
    return buf


def _x_node_graph(seed: int, n_x: int):
    """n_x X-nodes of 2 in- and 2 out-edges with small, often tied
    abundances: one sparse-flow job or more each (node_blocks)."""
    import numpy as np

    from shannon_tpu_torch.oracle.nodegraph import Node, NodeGraph
    from shannon_tpu_torch.sim import random_seq

    rng = np.random.default_rng(seed)
    nodes, xs = [], []
    for _ in range(n_x):
        ab = [float(rng.integers(1, 8)) for _ in range(4)]
        for j in range(2):
            nodes.append(Node(seq=random_seq(rng, 30), abundance=ab[j], klen=10))
        nodes.append(Node(seq=random_seq(rng, 30), abundance=ab[0] + ab[1], klen=10))
        for j in range(2):
            nodes.append(Node(seq=random_seq(rng, 30), abundance=ab[2 + j], klen=10))
        xs.append(len(nodes) - 3)
    g = NodeGraph(k=21, nodes=nodes)
    for v in xs:
        for u in (v - 2, v - 1):
            g.add_edge(u, v)
        for w in (v + 1, v + 2):
            g.add_edge(v, w)
    return g, xs


def sf_phase(dev, smi: str) -> dict:
    """K6 against its plain version on 4,096 jobs; then the batched solver
    (K6) against the host solve_node loop at small rounds (the reference
    keeps rounds of at most 32 jobs on the host; the port does not)."""
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.oracle.sparseflow import _node_flows, node_blocks, solve_node
    from shannon_tpu_torch.ops import sparseflow as tsf

    cfg = AssemblyConfig()
    buf = torch.from_numpy(_sf_jobs(7, 4096)).to(dev)
    R = cfg.sf_restarts
    got = tsf.batched_greedy_packed(buf, R)
    want = tsf.batched_greedy_packed_plain(buf, R)
    err = _max_abs_err((got[0].view(torch.int32), got[1]), (want[0].view(torch.int32), want[1]))
    t = _alternate(lambda: tsf.batched_greedy_packed(buf, R),
                   lambda: tsf.batched_greedy_packed_plain(buf, R))
    # per (job, restart): at most 16 greedy steps, each a scan of the 64
    # cells with about 4 operations per cell
    ops = buf.shape[0] * (R + 1) * 16 * 64 * 4
    out = {"sf_greedy": _row(err, t, _nbytes(buf, *got), ops, None), "sf_rounds": []}
    _print_row(f"K6 sf_greedy {buf.shape[0]} jobs x {R + 1} restarts (flows bitwise)",
               out["sf_greedy"], smi)
    for n_nodes in (8, 32, 128):
        g, xs = _x_node_graph(n_nodes, n_nodes)
        n_jobs = 0
        for v in xs:
            _ins, _outs, a, b, total = _node_flows(g, v, None)
            n_jobs += len(list(node_blocks(a, b, cfg, total)))
        want = {v: solve_node(g, v, cfg) for v in xs}
        if tsf.solve_nodes_device(g, xs, cfg, device=dev) != want:
            raise AssertionError(f"batched solver disagrees with solve_node at {n_nodes} nodes")
        times = {}
        for name, fn in (
            ("host", lambda: [solve_node(g, v, cfg) for v in xs]),
            ("kernel", lambda: tsf.solve_nodes_device(g, xs, cfg, device=dev)),
        ):
            reps = 20
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times[name] = (time.perf_counter() - t0) / reps * 1e3
        print(f"SF round of {n_nodes} X-nodes, {n_jobs} jobs: batched solver (K6) {times['kernel']:.3f} ms, "
              f"host solve_node loop {times['host']:.3f} ms; same pairings [{smi}]")
        out["sf_rounds"].append({"nodes": n_nodes, "jobs": n_jobs, "kernel_ms": times["kernel"],
                                 "host_ms": times["host"]})
    return out


def paired_parity_phase(reads, dev, smi: str) -> None:
    """CUDA == CPU on PARITY_PAIRS pairs; run_pipeline from files == the
    in-memory route."""
    import numpy as np

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.fastx import write_fasta
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ingest import normalize_mate2
    from shannon_tpu_torch.pipeline import assemble, run_pipeline, spectrum_device

    rng = np.random.default_rng(3)
    pairs = np.sort(rng.choice(len(reads) // 2, PARITY_PAIRS, replace=False))
    sub = [reads[2 * p + m] for p in pairs for m in (0, 1)]
    cfg = AssemblyConfig(kmer_capacity=1 << 18)
    gpu = assemble(sub, cfg, device=dev, paired=True)
    cpu = assemble(sub, cfg, device="cpu", paired=True)
    if [(t.seq, t.abundance) for t in gpu.transcripts] != [
        (t.seq, t.abundance) for t in cpu.transcripts
    ]:
        raise AssertionError("paired transcripts differ between CUDA and CPU")
    with tempfile.TemporaryDirectory() as tmp:
        left, right = _write_mates(sub, Path(tmp))
        out = Path(tmp) / "out"
        _with_card(lambda: run_pipeline(AssemblyConfig(kmer_capacity=1 << 18, out_dir=str(out)),
                                        left=left, right=right, device=dev), smi)
        spec, _ = spectrum_device(
            pack_reads(normalize_mate2(sub), pad_length=cfg.read_pad_length, paired=True), cfg, dev
        )
        saved = np.load(out / "spectrum.npz")
        n = spec.n
        if not (np.array_equal(saved["kmers"], spec.key[:n].cpu().numpy().astype(np.uint64))
                and np.array_equal(saved["counts"], spec.count[:n].cpu().numpy())):
            raise AssertionError("run_pipeline's spectrum.npz differs from the in-memory route")
        expected = Path(tmp) / "expected.fasta"
        write_fasta(expected, [(f"shannon_tpu_{i} abundance={t.abundance:.4f}", t.seq)
                               for i, t in enumerate(gpu.transcripts)])
        if (out / "transcripts.fasta").read_bytes() != expected.read_bytes():
            raise AssertionError("run_pipeline's transcripts differ from the in-memory route")
    print(f"paired parity: {PARITY_PAIRS} pairs, {spec.n} k-mers, {len(gpu.transcripts)} "
          "transcripts: CUDA == CPU; run_pipeline from files == in-memory")


def _with_card(fn, smi: str):
    """fn() in this process; its output lines (stage times among them) are
    printed with the card's name beside them."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    for line in buf.getvalue().splitlines():
        print(f"  {line} [{smi}]")
    return out


def _run_cli(argv: list[str], smi: str) -> None:
    from shannon_tpu_torch import cli

    rc = _with_card(lambda: cli.main(argv), smi)
    if rc != 0:
        raise AssertionError(f"the CLI exited with {rc}")


def _launches_check(launches: dict, phase: str, cut: int) -> None:
    """Every kernel launched in the phase; K8 only where the phase's auto
    abundance cut is above 1."""
    missing = [name for name, count in launches.items() if count == 0]
    if missing == ["rescue_round"] and cut == 1:
        print(f"the {phase} scale phase launched no rescue_round (K8): its auto abundance "
              "cut is 1, and dead-end rescue runs only when the cut drops k-mers")
        return
    if missing:
        raise AssertionError(f"the {phase} scale phase launched no {missing} kernel")


def single_scale_phase(truth, reads, dev, lib, smi: str) -> dict:
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.eval import evaluate
    from shannon_tpu_torch.utils.timing import StageTimer
    from shannon_tpu_torch.pipeline import assemble

    timer = StageTimer(echo=False)
    torch.cuda.reset_peak_memory_stats(dev)
    lib.reset_counts()
    t0 = time.perf_counter()
    res = assemble(reads, AssemblyConfig(), device=dev, timer=timer)
    torch.cuda.synchronize(dev)
    e2e = time.perf_counter() - t0
    launches = dict(lib.launches)
    quality = evaluate(truth, [t.seq for t in res.transcripts], k=24)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"single-end scale: {len(reads)} reads in {e2e:.2f} s = {len(reads) / e2e:.1f} reads/s, "
          f"peak device memory {peak / 2**30:.2f} GiB [{smi}]")
    print("stages " + json.dumps(timer.stages) + f" [{smi}]")
    print("quality " + json.dumps(quality))
    print("launches " + json.dumps(launches))
    if quality["recall_exact"] < 0.99:
        raise AssertionError(f"single-end exact recall {quality['recall_exact']} < 0.99")
    _launches_check(launches, "single-end", timer.stages["spectrum+graph"]["auto_min_abundance"])
    return {"n_reads": len(reads), "e2e_s": e2e, "reads_per_s": len(reads) / e2e,
            "max_memory_allocated_bytes": peak, "stages": timer.stages, "stats": res.stats,
            "quality": quality, "launches": launches}


def paired_scale_phase(truth, reads, dev, lib, smi: str) -> dict:
    """The CLI on two mate files, then again on the same out-dir (resume)."""
    import torch

    from shannon_tpu_torch.eval import evaluate
    from shannon_tpu_torch.io.fastx import read_fastx

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        left, right = _write_mates(reads, Path(tmp))
        print(f"paired scale: {len(reads) // 2} pairs written in {time.perf_counter() - t0:.1f} s "
              f"[{smi}]")
        out = Path(tmp) / "out"
        argv = ["-o", str(out), "--left", left, "--right", right, "-K", "24", "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats(dev)
        lib.reset_counts()
        t0 = time.perf_counter()
        _run_cli(argv, smi)
        torch.cuda.synchronize(dev)
        e2e = time.perf_counter() - t0
        launches = dict(lib.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        stages = json.loads((out / "stats.json").read_text())["stages"]
        _launches_check(launches, "paired", stages["spectrum+graph"]["auto_min_abundance"])
        seqs = [s for _, s in read_fastx(out / "transcripts.fasta")]
        t0 = time.perf_counter()
        _run_cli(argv, smi)
        resume_s = time.perf_counter() - t0
        again = json.loads((out / "stats.json").read_text())["stages"]
        not_skipped = [n for n in ("ingest", "spectrum", "assembly") if not again[n].get("skipped")]
        if not_skipped or [s for _, s in read_fastx(out / "transcripts.fasta")] != seqs:
            raise AssertionError(f"resume redid {not_skipped} or changed the transcripts")
    quality = evaluate(truth, seqs, k=24)
    print(f"paired scale (CLI): {len(reads)} reads in {e2e:.2f} s = {len(reads) / e2e:.1f} "
          f"reads/s, peak device memory {peak / 2**30:.2f} GiB; resume pass {resume_s:.2f} s, "
          f"every stage skipped [{smi}]")
    print("paired stages " + json.dumps(stages) + f" [{smi}]")
    print("paired quality " + json.dumps(quality))
    print("paired launches " + json.dumps(launches))
    if quality["recall_exact"] < PAIRED_RECALL_GATE:
        raise AssertionError(
            f"paired exact recall {quality['recall_exact']} < {PAIRED_RECALL_GATE}"
        )
    return {"n_reads": len(reads), "e2e_s": e2e, "reads_per_s": len(reads) / e2e,
            "resume_s": resume_s, "max_memory_allocated_bytes": peak, "stages": stages,
            "n_transcripts": len(seqs), "quality": quality, "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=1_000_000,
                    help="reads of each scale phase (the paired one: 2 per pair)")
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

    from shannon_tpu_torch import kernels
    from shannon_tpu_torch.ingest import native_route

    print(f"input files parsed by the {native_route()} route of shannon_tpu_torch.native")
    t0 = time.perf_counter()
    _path, log = kernels.build(force=True)
    lib = kernels.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s, nvcc for sm_90a [{smi}]")
    for line in log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print("  " + line.strip())

    report = {"card": smi, "build_s": build_s}
    report["kernels"] = kernel_phase(dev, smi)

    t0 = time.perf_counter()
    truth, reads = _scale_dataset(args.reads)
    print(f"scale dataset: {len(reads)} reads simulated in {time.perf_counter() - t0:.1f} s "
          f"[{smi}]")
    report["kernels"].update(thread_phase(reads, dev, smi))
    rows, report["correction"] = correction_phase(reads, dev, smi)
    report["kernels"].update(rows)
    sf = sf_phase(dev, smi)
    report["sf_rounds"] = sf.pop("sf_rounds")
    report["kernels"].update(sf)
    parity_phase(reads, PARITY_READS, dev, smi)
    t0 = time.perf_counter()
    p_truth, p_reads = _scale_dataset(args.reads, paired=True)
    print(f"paired scale dataset: {len(p_reads)} reads simulated in "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    paired_parity_phase(p_reads, dev, smi)

    report["scale"] = single_scale_phase(truth, reads, dev, lib, smi)
    del reads
    report["paired_scale"] = paired_scale_phase(p_truth, p_reads, dev, lib, smi)
    report["wall_s"] = time.perf_counter() - t_start
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)

    rows = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": report["scale"]["launches"][name] + report["paired_scale"]["launches"][name],
         "launches_single_end": report["scale"]["launches"][name],
         "launches_paired": report["paired_scale"]["launches"][name],
         **report["kernels"][name]}
        for name, (source, replaces) in REPLACES.items()
    ]
    print(f"total {report['wall_s']:.1f} s [{smi}]")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
