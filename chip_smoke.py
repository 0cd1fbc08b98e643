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
     65,536 reads of 100 bp at pad 128, k = 24, a 2^22-lane table, and K24
     (k-mer extraction from uint8 codes, with and without N codes) on the
     same reads as codes, also held equal to K1 on them packed; K2 again on
     the sorted window keys of the scale dataset's first read batch (what
     the main path gives it); K4
     (threading run scan) and K5 (across-read compaction) on the first
     65,536 reads of the scale dataset against the contig arrays
     spectrum_device builds from them; K7 (probe lookup, both probe sets),
     K8 (the dead-end rescue from the cut counts: one round, and the whole
     loop at the oracle's cap of k + 2 rounds, with its rounds run and each
     round's frontier), K9 (one prune round) and K10
     (compaction of the final keep mask) on the counted, shrunk spectrum of
     the whole single-end scale dataset at the default AssemblyConfig, with
     K16 (count histogram of the auto cut; its global variant at max_count
     65,536 printed beside it), K20 (the abundance cut, its cut mode) and
     K28 (neighbor counts: 8 extension and 8 sibling probes a lane, k = 24,
     canonical) on that spectrum and K17 (count merge) on the first and
     the largest (the last) merge its count made;
     then the whole correct_spectrum there against its CPU run, and K9 on a
     synthetic grid (every count 1..255 against every sibling maximum
     1..4095, error_rate 0.01 and 0.02); K11-K15 (condensation: node table, group-join links,
     pointer-doubling labels, per-contig reduction, base streams) stage by
     stage on that corrected, shrunk spectrum, each kernel's output feeding
     the next stage, and the whole build_contig_arrays timed; K13's cycle
     cut (cycle_round) and every other condensation stage again on a
     synthetic spectrum of isolated cycles (tandem repeats and
     homopolymers); K18 (tip clip's drop) and K19 (its remap of the node
     table) on the arguments one clip of that spectrum gives them; K6
     (sparse-flow greedy) on 4,096 random jobs of 1-8 by 1-8 margins at
     sf_restarts = 4, K29 (the unpacked greedy, one decomposition a row) on
     those jobs expanded to their 5 seeded restart rows (20,480 rows), each
     job's winning row also held equal to K6's flows, and the batched solver
     (K6) against the host solve_node loop on rounds of 8, 32 and 128
     X-nodes.  Each kernel row
     also times the one PyTorch call that computes the same function, where
     there is one (library_ms), and gives the least time the card could
     take (bound_ms: bytes over 3.35 TB/s or operations over 67 TFLOP/s,
     whichever is larger).  Every device program of the JAX package is a
     hand-written kernel: those of the main path, and K28 and K29, which
     the reference runs in its tests only;
  2b. the flagship count-and-correct step (shannon_tpu_torch.entry: 65,536
     reads x 100 bp, k = 24, a 2^22-lane count table sliced to 2^21 lanes,
     abundance_filter(1), one sibling_prune_round(0.1)), run once to warm,
     timed (CUDA events, median of 10), held equal to the JAX package's
     figures for __graft_entry__.entry() (ENTRY_FIGURES) and to its own CPU
     run, with K1, K2, K20, K10, K22 and K23 launched in it; then K20 (keep
     and cut modes), K21 (count lookup: the flagship table and its 8 x C
     sibling probes), K22 (sibling maxima) and K23 (prune keep flags) on the
     step's own intermediate tables, each against its plain version;
  3. parity: on 3,000 reads of the scale dataset, assemble on CUDA gives
     the same corrected spectrum, contig arrays and transcripts as on the
     CPU (plain versions), and the same canonical set as the pure-Python
     oracle (assemble(backend="oracle")); on 1,500 pairs of the paired
     scale dataset, assemble(paired=True) on CUDA gives the CPU's
     transcripts, and run_pipeline on CUDA
     from two mate files gives the in-memory route's spectrum and
     transcripts;
  4. single-end scale: assemble on CUDA at the default AssemblyConfig
     (k = 24) on the dataset of scripts/measure_e2e.py (seed 11, 500
     transcripts x 1,500 bp, log-normal abundance sigma 1, 100 bp reads, 1%
     error); fails below 0.99 exact recall;
  4b. sharded, 8 shards on the one card: dryrun_multichip(8) (its figures
     == the JAX package's, DRYRUN_FIGURES; K24 and K25 launched); K25
     (owner bucketing) against its plain version on shard 0's local
     spectrum of the scale dataset's first batch (2^22 lanes, 8 owners x
     2^20), and at a bucket_cap one below the widest owner, where the flag
     must go up; count_reads_spectrum_sharded on the scale dataset at the
     default config == count_reads_spectrum (both timed, in turns; K1, K2,
     K17 and K25 launched); assemble at n_devices = 8 == the single-end
     phase's transcripts, recall >= 0.99, count_s printed;
  4c. multi-process, groups of ranks under torchrun
     (scripts/multihost_smoke_torch.py's child mode; on the one card they
     share it over gloo, and "nccl: not run (one card)" is printed): the
     scale dataset's single-end reads as one FASTA (explicit pad 128), 2
     ranks, 'ownership' back half: every rank's transcripts and rank 0's
     transcripts.fasta == the single-end phase's, every rank's replicated
     spectrum == count_reads_spectrum of the reads here; on its first
     250,000 reads, 'replicate' at 2 ranks and 'ownership' at 4 ranks, and
     on the paired dataset's first 250,000 reads as two mate files
     (ingest_paired_files_range) 'ownership' at 2 ranks, each == run_pipeline
     of the same files in this process; K1, K2, K25 and K17 launched in
     every rank, K26 and K27 in every rank of every 'ownership' group; K26
     (evidence-ownership pack) and K27 (its unpack) against their plain
     versions on rank 0's local evidence and owner table of the 2-rank
     full-width run.  The three 2-rank runs share one launch, so each group
     pays its processes' start once.  A rank that exits nonzero, a missing
     marker or a group past GROUP_TIMEOUT kills the group and fails the
     phase.  With two cards or more, one more 2-rank group at 250,000 reads
     runs over nccl;
  5. paired scale, through the CLI: the same transcriptome sampled as
     100 bp mates with insert 250 (1% error), written as two FASTA files,
     run by shannon_tpu_torch.cli.main on CUDA, then run again on the same
     out-dir, where every stage must be skipped (resume); fails below the
     reference's exact recall on this dataset (PAIRED_RECALL_GATE);
  6. quality: shannon_tpu_torch.quality's four sections on CUDA at the
     reference's sizes (pinned 30,255 reads; paired bridging 3,920 reads,
     pairs off and on; splicing 20,877 reads and its paired variant; the
     sweep at coverages 5, 10 and 20), each section's transcript sets and
     metrics held to the reference's figures (QUALITY_FIGURES, from a fresh
     run of scripts/quality.py's sections on JAX-CPU, not the committed
     QUALITY.md), each section's wall seconds printed.
In both scale phases each merge of the count is bracketed with CUDA events,
and their sum is printed beside count_s.  scripts/scale_turns.py runs these
two phases alone for several trees in turns (a parent against a change).
Every kernel must launch at least once in each scale phase and in the
quality phase (counts set to 0 just before the phase and read just after),
but K28 and K29 (TESTS_ONLY), which no path runs (the reference runs them in
its tests only), K17 in the quality phase, whose counts each fit one batch,
K21-K23, which assembly never runs (the flagship step runs K22 and K23; K21's work on it is inside
K22), K24, which assembly never runs (it counts packed words; the dry run
runs K24), K25 where the count is not sharded, K26 and K27, which run only in
a multi-process 'ownership' run (phase 4c); K8 (dead-end rescue) runs
only when the phase's auto abundance cut is above 1, and is exempt where it
is 1; K13's cycle_round runs only when the labels find a cycle, and is
exempt where they find none; K18 and K19 run only when the clip dooms a
contig, and are exempt where it dooms none, and K19 also where a merge of
the clip closed a cycle (the caller then condenses the clipped spectrum
anew).

The last two lines of standard output are one JSON object with the kernels'
launches (single-end, paired, entry, sharded, multi-process, the last
summed over every rank of every group, and quality), errors and times, and
one JSON object {"ok": true, "device": ...}.
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
# Random reads (100 bp, padded) and k of the kernel phase's K1-K3 and K24 rows.
KERNEL_READS, KERNEL_PAD, KERNEL_K = 65_536, 128, 24

# The TPU program each kernel replaces (PERF.md section 6).
REPLACES = {
    "extract_kmers": ("shannon_tpu_torch/csrc/kernels.cu", "shannon_tpu/ops/kmers.py:151"),
    "reduce_sorted": ("shannon_tpu_torch/csrc/kernels.cu", "shannon_tpu/ops/count.py:158"),
    "lookup_sorted": ("shannon_tpu_torch/csrc/kernels.cu", "shannon_tpu/ops/spectrum.py:137"),
    "thread_rows": ("shannon_tpu_torch/csrc/thread.cu", "shannon_tpu/ops/thread.py:104"),
    "compact_rows": ("shannon_tpu_torch/csrc/thread.cu", "shannon_tpu/ops/thread.py:178"),
    "sf_greedy": ("shannon_tpu_torch/csrc/sparseflow.cu", "shannon_tpu/ops/sparseflow.py:88"),
    "probe_lookup": ("shannon_tpu_torch/csrc/correction.cu", "shannon_tpu/ops/correction.py:78"),
    "rescue_rounds": ("shannon_tpu_torch/csrc/rescue.cu", "shannon_tpu/ops/correction.py:143"),
    "prune_round": ("shannon_tpu_torch/csrc/correction.cu", "shannon_tpu/ops/correction.py:184"),
    "compact_keep": ("shannon_tpu_torch/csrc/correction.cu", "shannon_tpu/ops/correction.py:19"),
    "node_strands": ("shannon_tpu_torch/csrc/condense.cu", "shannon_tpu/ops/condense.py:82"),
    "group_links": ("shannon_tpu_torch/csrc/condense.cu", "shannon_tpu/ops/condense.py:109"),
    "label_round": ("shannon_tpu_torch/csrc/condense.cu", "shannon_tpu/ops/condense.py:232"),
    "cycle_round": ("shannon_tpu_torch/csrc/condense.cu", "shannon_tpu/ops/condense.py:264"),
    "contig_reduce": ("shannon_tpu_torch/csrc/condense.cu", "shannon_tpu/ops/condense.py:287"),
    "base_streams": ("shannon_tpu_torch/csrc/condense.cu", "shannon_tpu/ops/condense.py:417"),
    "count_histogram": ("shannon_tpu_torch/csrc/correction.cu",
                        "shannon_tpu/ops/correction.py:32"),
    "merge_spectra": ("shannon_tpu_torch/csrc/kernels.cu", "shannon_tpu/ops/count.py:257"),
    "drop_contigs": ("shannon_tpu_torch/csrc/tipclip.cu", "shannon_tpu/ops/tipclip.py:407"),
    "clip_remap": ("shannon_tpu_torch/csrc/tipclip.cu", "shannon_tpu/ops/tipclip.py:423"),
    "abundance_cut": ("shannon_tpu_torch/csrc/correction.cu",
                      "shannon_tpu/ops/correction.py:134"),
    "lookup_counts": ("shannon_tpu_torch/csrc/spectrum.cu", "shannon_tpu/ops/spectrum.py:60"),
    "sibling_maxes": ("shannon_tpu_torch/csrc/spectrum.cu", "shannon_tpu/ops/spectrum.py:166"),
    "prune_keep": ("shannon_tpu_torch/csrc/correction.cu", "shannon_tpu/ops/correction.py:61"),
    "extract_codes": ("shannon_tpu_torch/csrc/kernels.cu", "shannon_tpu/ops/kmers.py:116"),
    "owner_buckets": ("shannon_tpu_torch/csrc/distributed.cu",
                      "shannon_tpu/parallel/distributed.py:126"),
    "ownership_pack": ("shannon_tpu_torch/csrc/multihost.cu",
                       "shannon_tpu/parallel/multihost.py:115"),
    "ownership_unpack": ("shannon_tpu_torch/csrc/multihost.cu",
                         "shannon_tpu/parallel/multihost.py:115"),
    "neighbor_counts": ("shannon_tpu_torch/csrc/spectrum.cu", "shannon_tpu/ops/spectrum.py:212"),
    "sf_jobs": ("shannon_tpu_torch/csrc/sparseflow.cu", "shannon_tpu/ops/sparseflow.py:38"),
}
# Kernels that assembly never launches: K22 and K23 run in the flagship step
# alone, and K21 on no path (its work on the flagship step is inside K22);
# K28 and K29 (TESTS_ONLY) run on no path either.
ENTRY_ONLY = {"lookup_counts": "K21", "sibling_maxes": "K22", "prune_keep": "K23"}
# Kernels no path runs: the reference runs neighbor_counts and the unpacked
# batched_greedy in its tests only.  The kernel phase holds them against
# their plain versions; every path's launch check exempts them.
TESTS_ONLY = {"neighbor_counts": "K28", "sf_jobs": "K29"}

# The flagship step's output at entry()'s shape: the JAX package's figures
# for __graft_entry__.entry() on JAX-CPU.  The hashes are the first 16 hex
# digits of the SHA-256 of the real keys as int64 ((hi << 32) | lo, table
# order) and of their int32 counts.
ENTRY_FIGURES = {"n": 163_705, "count_sum": 4_980_529, "capacity": 2_097_152,
                 "keys_sha256": "3d3e0a60778df30b", "counts_sha256": "d9258556cc896c36"}
# Kernels the flagship step must launch.
ENTRY_KERNELS = ("extract_kmers", "reduce_sorted", "abundance_cut", "compact_keep",
                 "sibling_maxes", "prune_keep")

# dryrun_multichip(8)'s figures: those __graft_entry__.dryrun_multichip(8)
# prints on JAX-CPU (8 virtual devices).
DRYRUN_FIGURES = {"corrected_kmers": 22_820, "contigs": 2_506, "threading_events": 4_155,
                  "transcripts": 233}
# Shards of the sharded phase (the reference's dry-run width), all on the one
# card, and the kernels its count must launch.
SHARDS = 8
SHARDED_KERNELS = ("extract_kmers", "reduce_sorted", "merge_spectra", "owner_buckets")
# Kernels that run only in a multi-process run in 'ownership' mode (K26, K27).
OWNERSHIP_KERNELS = {"ownership_pack": "K26", "ownership_unpack": "K27"}
# Reads of the multi-process phase's smaller groups, and the read pad of its
# files (explicit, as byte-range ingest needs; 100 bp reads pack at 128, as
# the auto pad of the in-memory runs gives).
MULTIHOST_SMALL = 250_000
MULTIHOST_PAD = 128
# Seconds a group of ranks may run before it is killed and the phase fails.
GROUP_TIMEOUT = 420

# The reference's quality gates: scripts/quality.py's four sections at its own
# sizes on JAX-CPU, with each of its backends.  Per section and backend:
# (transcript_sha256 of the section's assemblies, section_sha256 of every
# metric, dataset field and assembly statistic), from
#   JAX_PLATFORMS=cpu python scripts/reference_quality.py
QUALITY_FIGURES = {
    "pinned": {"device": ("ef72396a56a6708c", "15c11b41d6091577"),
               "oracle": ("66ff8b74121bd637", "15c11b41d6091577")},
    "paired_bridging": {"device": ("5009e9d6e2c0efdb", "5ac178bf8cd50063"),
                        "oracle": ("5009e9d6e2c0efdb", "5ac178bf8cd50063")},
    "splicing": {"device": ("81a0501f54e31dea", "72fe5241d0564dbf"),
                 "oracle": ("81a0501f54e31dea", "72fe5241d0564dbf")},
    "sweep": {"device": ("325d56a158501c20", "42d4f99e58b6e0df"),
              "oracle": ("a5e1905d71f8b623", "7d291ecf76d05eca")},
}
# The reference backend the port's device backend must equal in every
# section.  The two differ on pinned and the sweep, where the reference's
# batched sparse-flow solver returns each node's pairings in row-major cell
# order and sparse_flow numbers the split copies in that order; the port's
# solver keeps the oracle's pick order (ops/sparseflow.py; with the oracle's
# host solver in its device backend, scripts/reference_quality.py
# --host-solver, the reference gives the oracle's figures).
QUALITY_BACKEND = "oracle"

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


# The module functions Watch wraps: (module, function).
WATCHED = {
    "merge_at": ("shannon_tpu_torch.ops.count", "merge_at"),
    "host_clip_rounds": ("shannon_tpu_torch.ops.tipclip", "_host_clip_rounds"),
    "drop_contigs": ("shannon_tpu_torch.ops.tipclip", "_drop_contigs"),
    "clip_remap": ("shannon_tpu_torch.ops.tipclip", "_device_clip_remap"),
    "auto_cut": ("shannon_tpu_torch.pipeline", "auto_min_abundance"),
    "thread_lookup": ("shannon_tpu_torch.ops.thread", "lookup_sorted"),
}


class Watch:
    """Wraps the count merge and tip clip's steps (WATCHED) in their
    modules.  It records, for each clip, whether its host rounds doomed a
    contig and whether a merge closed a cycle (where K18 and K19 are
    exempt), and each assembly's auto abundance cut (K8 is exempt where
    every cut is 1), and brackets each merge with two CUDA events (merge_ms reads
    them); it keeps the first and the last call's arguments of each function
    named in keep_args (the merge, the drop, the remap, threading's lookup),
    so that each kernel can be held against its plain version on the main
    path's own arguments.  The kernels are called through `originals`, never
    through a wrapper."""

    def __init__(self):
        import importlib

        self.originals = {}
        self.clips: list[tuple[bool, bool]] = []  # (any doomed, cycle merged)
        self.cuts: list[int] = []  # each assembly's auto abundance cut
        self.merges: list = []  # (start, end) CUDA events of each merge
        self.first_args: dict = {}
        self.last_args: dict = {}
        self.keep_args: tuple = ()
        for name, (module, fn) in WATCHED.items():
            mod = importlib.import_module(module)
            self.originals[name] = getattr(mod, fn)
            setattr(mod, fn, self._wrap(name, self.originals[name]))

    def _wrap(self, name: str, fn):
        import torch

        def wrapped(*args):
            if name in self.keep_args:
                self.first_args.setdefault(name, args)
                self.last_args[name] = args
            if name == "merge_at":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*args)
                end.record()
                self.merges.append((start, end))
                return out
            out = fn(*args)
            if name == "host_clip_rounds":
                self.clips.append((bool(out.doomed.any()), bool(out.cycle_merged)))
            elif name == "auto_cut":
                self.cuts.append(out)
            return out

        return wrapped

    def merge_ms(self) -> float:
        """Milliseconds of the stream between the events around each merge
        since the last reset, summed (the merge's launches and any gap
        between them)."""
        import torch

        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in self.merges)

    def reset(self) -> None:
        self.clips.clear()
        self.cuts.clear()
        self.merges.clear()
        self.first_args.clear()
        self.last_args.clear()


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


def _random_batch(seed: int, with_n: bool, dev, codes_too: bool = False):
    """KERNEL_READS random reads of 100 bp at pad KERNEL_PAD, packed (words,
    lengths, N mask or None), and their uint8 codes with codes_too; with_n
    puts one N in the middle of every other read."""
    import numpy as np
    import torch

    from shannon_tpu_torch.io.pack import invalid_mask_words, pack_words

    n, pad = KERNEL_READS, KERNEL_PAD
    rng = np.random.default_rng(seed)
    codes = np.full((n, pad), 4, np.uint8)
    codes[:, :100] = rng.integers(0, 4, (n, 100))
    if with_n:
        rows = np.arange(0, n, 2)
        codes[rows, rng.integers(20, 80, rows.shape[0])] = 4
    lengths = np.full(n, 100, np.int32)
    words = torch.from_numpy(pack_words(codes).view(np.int32)).to(dev)
    m = invalid_mask_words(codes, lengths)
    mask = None if m is None else torch.from_numpy(m.view(np.int32)).to(dev)
    packed = (words, torch.from_numpy(lengths).to(dev), mask)
    return (*packed, torch.from_numpy(codes).to(dev)) if codes_too else packed


def window_keys(dev, seed: int | None = None, reads=None):
    """The sorted window keys K2's rows are held on: those of
    _random_batch(seed, False) (k = KERNEL_K, canonical) or, given the scale
    dataset's `reads`, those of its first read batch (BATCH_READS reads at the
    default AssemblyConfig, packed as count_reads_spectrum packs them)."""
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops.count import upload_words
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed

    if reads is None:
        words, lengths, _ = _random_batch(seed, False, dev)
        keys, _ = extract_kmers_packed(words, lengths, KERNEL_K, True, KERNEL_PAD)
    else:
        cfg = AssemblyConfig()
        batch = pack_reads(reads[:BATCH_READS], pad_length=cfg.read_pad_length)
        m = batch.mask_rows(0, batch.n_reads)
        keys, _ = extract_kmers_packed(
            upload_words(batch.words, dev), torch.from_numpy(batch.lengths).to(dev), cfg.k,
            not cfg.strand_specific, length=batch.pad_length,
            mask=None if m is None else upload_words(m, dev),
        )
    return torch.sort(keys.reshape(-1)).values


def _reduce_row(label: str, args: tuple, smi: str):
    """K2 on (keys, counts or None, capacity) against its plain version, with
    torch.unique_consecutive (keys and run lengths) as the library call.
    Bytes: the keys (and counts) in, the key and count tables out, and the
    starts of the runs that fit."""
    import torch

    from shannon_tpu_torch.ops.count import reduce_sorted, reduce_sorted_plain

    keys, counts, cap = args
    got, want = reduce_sorted(*args), reduce_sorted_plain(*args)
    if got[3] != want[3]:
        raise AssertionError(f"K2 {label} n {got[3]} != {want[3]}")
    c = min(got[3], cap)
    err = _max_abs_err((got[0], got[1], got[2][:c]), (want[0], want[1], want[2][:c]))
    t = _alternate(lambda: reduce_sorted(*args), lambda: reduce_sorted_plain(*args))
    inputs = (keys,) if counts is None else (keys, counts)
    library = _time_ms(lambda: torch.unique_consecutive(keys, return_counts=True), 10)
    row = _row(err, t, _nbytes(*inputs, *got[:2]) + 8 * c, keys.numel(), library)
    _print_row(f"K2 reduce_sorted {label}, {keys.numel()} keys -> {got[3]} runs in {cap} lanes",
               row, smi)
    return got, row


def batch_reduce_row(reads, dev, smi: str) -> dict:
    """K2 on what the main path gives it: the sorted window keys of the first
    read batch of the scale dataset (BATCH_READS reads at the default
    AssemblyConfig, packed as count_reads_spectrum packs them) into the
    default kmer_capacity."""
    from shannon_tpu_torch.config import AssemblyConfig

    _, row = _reduce_row("unit, the scale dataset's first read batch",
                         (window_keys(dev, reads=reads), None, AssemblyConfig().kmer_capacity), smi)
    return row


def kernel_phase(dev, smi: str) -> dict:
    """K1-K3 and K24 against their plain versions at the main path's shapes,
    with the one PyTorch call that computes the same (torch.unique_consecutive
    for K2, torch.searchsorted for K3)."""
    import math

    import torch

    from shannon_tpu_torch.ops.count import reduce_sorted
    from shannon_tpu_torch.ops.kmers import (
        extract_kmers, extract_kmers_packed, extract_kmers_packed_plain, extract_kmers_plain,
    )
    from shannon_tpu_torch.ops.spectrum import lookup_sorted, lookup_sorted_plain

    n, pad, k, cap = KERNEL_READS, KERNEL_PAD, KERNEL_K, 1 << 22
    out = {}
    rows = []
    for canonical in (True, False):
        for with_n in (False, True):
            words, lengths, mask = _random_batch(1, with_n, dev)
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

    rows = []
    for with_n in (False, True):
        words, lengths, mask, codes = _random_batch(1, with_n, dev, codes_too=True)
        args = (codes, lengths, k, True)
        got = extract_kmers(*args)
        err = _max_abs_err(got, extract_kmers_plain(*args))
        if _max_abs_err(got, extract_kmers_packed(words, lengths, k, True, pad, mask)):
            raise AssertionError("K24 disagrees with K1 on the same reads packed")
        t = _alternate(lambda: extract_kmers(*args), lambda: extract_kmers_plain(*args))
        W = got[0].shape[1]
        rows.append(_row(err, t, _nbytes(codes, lengths, *got), 2 * n * W * k, None))
        _print_row(f"K24 extract_codes canonical N={with_n}, {n} x {pad} uint8 codes (== K1 on "
                   "them packed)", rows[-1], smi)
    out["extract_codes"] = {**rows[0], "max_abs_err": max(r["max_abs_err"] for r in rows)}

    words, lengths, _ = _random_batch(1, False, dev)
    keys_a, keys_b = window_keys(dev, seed=1), window_keys(dev, seed=2)

    table_a, row_unit = _reduce_row("unit", (keys_a, None, cap), smi)
    table_b = reduce_sorted(keys_b, None, cap)
    mkeys, order = torch.sort(torch.cat([table_a[0], table_b[0]]))
    mcounts = torch.cat([table_a[1], table_b[1]])[order]
    _, row_merge = _reduce_row("merge", (mkeys, mcounts, cap), smi)
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
    _print_row(f"K3 lookup_sorted {query.numel()} queries in {table.numel()} lanes (a walk of "
               "the 16-ary index: latency-bound, not bandwidth-bound)", out["lookup_sorted"], smi)
    return out


def _entry_figures(key, count, n: int) -> dict:
    """The step's output in ENTRY_FIGURES' terms."""
    import hashlib

    import numpy as np

    k = key[:n].cpu().numpy().astype(np.int64)
    c = count[:n].cpu().numpy().astype(np.int32)
    return {"n": n, "count_sum": int(c.sum(dtype=np.int64)), "capacity": int(key.shape[0]),
            "keys_sha256": hashlib.sha256(k.tobytes()).hexdigest()[:16],
            "counts_sha256": hashlib.sha256(c.tobytes()).hexdigest()[:16]}


def entry_phase(dev, lib, smi: str) -> tuple[dict, dict]:
    """The flagship step through shannon_tpu_torch.entry: warmed, its
    launches counted, timed, held to ENTRY_FIGURES and to its CPU run; then
    K20-K23 against their plain versions on the step's own tables.  Returns
    (kernel rows, the phase's numbers)."""
    import math
    import statistics

    import torch

    from shannon_tpu_torch import entry as tentry
    from shannon_tpu_torch.ops import correction as tcor
    from shannon_tpu_torch.ops import spectrum as tsp
    from shannon_tpu_torch.ops.count import _slice_spectrum, count_spectrum_packed

    step, (words, lengths) = tentry.entry(device=dev)
    step(words, lengths)
    torch.cuda.synchronize(dev)
    lib.reset_counts()
    key, count, n = step(words, lengths)
    torch.cuda.synchronize(dev)
    launches = dict(lib.launches)
    missing = [name for name in ENTRY_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the flagship step launched no {missing} kernel")
    times = []
    for _ in range(10):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step(words, lengths)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    figures = _entry_figures(key, count, n)
    if figures != ENTRY_FIGURES:
        raise AssertionError(f"the flagship step gave {figures}, the reference {ENTRY_FIGURES}")
    t0 = time.perf_counter()
    c_key, c_count, c_n = step(words.cpu(), lengths.cpu())
    cpu_s = time.perf_counter() - t0
    if c_n != n or not (torch.equal(c_key, key.cpu()) and torch.equal(c_count, count.cpu())):
        raise AssertionError("the flagship step on CUDA differs from its CPU run")
    print(f"entry step: {tentry.N_READS} reads x {tentry.READ_LEN} bp, k = {tentry.K}, "
          f"{tentry.CAPACITY} -> {tentry.CORRECT_CAP} lanes: {ms:.3f} ms (CUDA events, median of "
          f"10, min {min(times):.3f}, max {max(times):.3f}) = {tentry.N_READS / ms * 1e3:.0f} reads/s; "
          f"{n} k-mers, count sum {figures['count_sum']}: == the reference's figures, == its CPU "
          f"run ({cpu_s:.2f} s on the host) [{smi}]")
    print("entry launches " + json.dumps({k: v for k, v in launches.items() if v}))
    stage = {"ms": ms, "times_ms": times, "reads_per_s": tentry.N_READS / ms * 1e3,
             "cpu_s": cpu_s, "figures": figures, "launches": launches}

    # the step's intermediate tables
    spec = _slice_spectrum(count_spectrum_packed(words, lengths, k=tentry.K,
                                                 capacity=tentry.CAPACITY,
                                                 length=tentry.READ_LEN), tentry.CORRECT_CAP)
    C, n_real = spec.capacity, min(spec.n, spec.capacity)
    rows = {}
    for mode, outputs, out_bytes in (("keep", (False, False, True), 1), ("cut", (True, True, False), 8)):
        def kernel():
            return tcor.abundance_cut(spec, tentry.MIN_ABUNDANCE, *outputs)

        def plain():
            return tcor.abundance_cut_plain(spec, tentry.MIN_ABUNDANCE, *outputs)

        got = [x for x in kernel() if x is not None]
        err = _max_abs_err(got, [x for x in plain() if x is not None])
        # bytes: the counts of the real lanes in (n says where the pads
        # begin), the outputs of every lane out; operations: one a lane
        rows[f"abundance_cut_{mode}"] = _row(err, _alternate(kernel, plain),
                                             4 * n_real + out_bytes * C, n_real, None)
        _print_row(f"K20 abundance_cut ({mode} mode) on the flagship table, {C} lanes, "
                   f"{n_real} real, cut {tentry.MIN_ABUNDANCE}", rows[f"abundance_cut_{mode}"], smi)

    table = tcor.abundance_filter(spec, tentry.MIN_ABUNDANCE)
    n_tab = min(table.n, table.capacity)
    steps = math.ceil(math.log2(C)) + 1
    query = tsp.probe_keys(table.key, tentry.K, "sib", True)
    got = tsp.lookup_counts(table, query)
    err = _max_abs_err((got,), (tsp.lookup_counts_plain(table, query),))
    library = _time_ms(lambda: torch.searchsorted(table.key, query), 10)
    # bytes: the real lanes' keys and counts, the queries in, the counts
    # out; operations: a binary search per query
    rows["lookup_counts"] = _row(
        err, _alternate(lambda: tsp.lookup_counts(table, query),
                        lambda: tsp.lookup_counts_plain(table, query)),
        12 * n_tab + _nbytes(query, got), query.numel() * steps, library,
    )
    _print_row(f"K21 lookup_counts, the flagship table's 8 x {C} sibling probes in {C} lanes "
               f"({n_tab} real; a binary search: latency-bound, not bandwidth-bound)",
               rows["lookup_counts"], smi)
    del query, got

    sib = tsp.sibling_maxes(table, tentry.K)
    err = _max_abs_err(sib, tsp.sibling_maxes_plain(table, tentry.K))
    # bytes: the real lanes' keys and counts in, both maxima of every lane
    # out; operations: 8 binary searches per real lane
    rows["sibling_maxes"] = _row(
        err, _alternate(lambda: tsp.sibling_maxes(table, tentry.K),
                        lambda: tsp.sibling_maxes_plain(table, tentry.K)),
        12 * n_tab + _nbytes(*sib), 8 * n_tab * steps, None,
    )
    _print_row(f"K22 sibling_maxes, the flagship table: {C} lanes, {n_tab} real, 8 probes each "
               "(binary searches: latency-bound, not bandwidth-bound)", rows["sibling_maxes"], smi)

    ratio, _ = tcor.prune_constants(tentry.SIBLING_RATIO, 0.0)
    keep = tcor.prune_keep(table, *sib, ratio)
    err = _max_abs_err((keep,), (tcor.prune_keep_plain(table, *sib, ratio),))
    # bytes: the real lanes' counts and maxima in, the keep flags out;
    # operations: a few a real lane
    rows["prune_keep"] = _row(
        err, _alternate(lambda: tcor.prune_keep(table, *sib, ratio),
                        lambda: tcor.prune_keep_plain(table, *sib, ratio)),
        12 * n_tab + C, 4 * n_tab, None,
    )
    _print_row(f"K23 prune_keep, the flagship table: {C} lanes, {n_tab} real, "
               f"{n_tab - int(keep.sum())} dropped", rows["prune_keep"], smi)
    del spec, table, sib, keep, words, lengths
    torch.cuda.empty_cache()
    return rows, stage


def parity_phase(reads, n_parity: int, dev, smi: str) -> None:
    """CUDA == CPU (plain versions) == the oracle backend on a subset of the
    reads."""
    import numpy as np
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.pack import pack_reads
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
    orc = assemble(sub, cfg, backend="oracle")
    if gpu.canonical_set() != orc.canonical_set():
        raise AssertionError("transcripts differ between CUDA and the oracle backend")
    print(f"parity: {n_parity} reads, {g_spec.n} corrected k-mers, "
          f"{len(gpu.transcripts)} transcripts: CUDA == CPU == oracle backend "
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


def _merge_row(watch: Watch, smi: str) -> dict:
    """K17 on the first and on the largest (the last) merge the count made
    (kept by `watch`), each against merge_at_plain (torch.sort of both
    tables, then K2's plain version): keys, counts and n exact.  Returns
    the first merge's row, its error over both, and the largest merge's
    row."""
    from shannon_tpu_torch.ops.count import merge_at_plain

    merge = watch.originals["merge_at"]
    rows = {}
    for label, (a, b, cap) in (("first", watch.first_args.pop("merge_at")),
                               ("largest", watch.last_args.pop("merge_at"))):
        got, want = merge(a, b, cap), merge_at_plain(a, b, cap)
        if got.n != want.n:
            raise AssertionError(f"K17 {label} merge: n {got.n} != {want.n}")
        err = _max_abs_err((got.key, got.count), (want.key, want.count))
        t = _alternate(lambda: merge(a, b, cap), lambda: merge_at_plain(a, b, cap))
        # bytes: the real lanes of both tables in (12 bytes each; each
        # table's n says where its pads begin), the merged table of cap
        # lanes out; operations: a merge is linear in the real lanes
        real = min(a.n, a.capacity) + min(b.n, b.capacity)
        rows[label] = _row(err, t, 12 * real + 12 * cap, real, None)
        _print_row(f"K17 merge_spectra, the {label} merge: {a.capacity} + {b.capacity} lanes "
                   f"({a.n} + {b.n} keys) -> {got.n} keys in {cap} lanes (one pass)",
                   rows[label], smi)
    err = max(row["max_abs_err"] for row in rows.values())
    return {"merge_spectra": {**rows["first"], "max_abs_err": err},
            "merge_spectra_largest": rows["largest"]}


def correction_phase(reads, dev, smi: str, watch: Watch):
    """K7-K10, K16 (and its global variant at max_count 65,536), K20 (cut
    mode) and K28 (neighbor counts, which no path runs) against their plain
    versions on the main path's input: the
    counted, shrunk spectrum of the whole single-end scale dataset at the
    default AssemblyConfig (k = 24, the auto cut, sibling ratio 0.1, the
    default error_rate), and K17 on the first and the largest merge of that
    count; then the
    whole correct_spectrum there against its CPU run (the plain versions),
    and K9 on the float grid.  Returns (kernel rows, the stage's numbers,
    the corrected spectrum shrunk as the main path shrinks it)."""
    import math

    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops import correction as tcor
    from shannon_tpu_torch.ops import spectrum as tsp
    from shannon_tpu_torch.ops.count import Spectrum, count_reads_spectrum, shrink_spectrum
    from shannon_tpu_torch.ops.kmers import PAD

    cfg = AssemblyConfig()
    k, canonical = cfg.k, not cfg.strand_specific
    watch.reset()
    watch.keep_args = ("merge_at",)
    spec = shrink_spectrum(count_reads_spectrum(
        pack_reads(reads, pad_length=cfg.read_pad_length), k=k, capacity=cfg.kmer_capacity,
        canonical=canonical, batch_reads=cfg.batch_reads, device=dev,
    ))
    watch.keep_args = ()
    out = _merge_row(watch, smi)
    watch.reset()
    cut = tcor.auto_min_abundance(spec)
    C = spec.capacity
    hist = tcor.count_histogram(spec, 1024)
    err = _max_abs_err((hist,), (tcor.count_histogram_plain(spec, 1024),))
    t = _alternate(lambda: tcor.count_histogram(spec, 1024),
                   lambda: tcor.count_histogram_plain(spec, 1024))
    clamped = torch.where(spec.key == PAD, 0, spec.count.clamp(0, 1024)).long()
    library = _time_ms(lambda: torch.bincount(clamped, minlength=1025), 10)
    del clamped
    # bytes: the counts of the real lanes in (n says where the pads begin,
    # so no key need be read), the histogram out; operations: one a lane
    n_real = min(spec.n, C)
    out["count_histogram"] = _row(err, t, 4 * n_real + _nbytes(hist), n_real, library)
    _print_row(f"K16 count_histogram {C} lanes, 1,025 bins, {int(hist[1])} entries of count 1",
               out["count_histogram"], smi)
    wide = tcor.count_histogram(spec, 65_536)
    err = _max_abs_err((wide,), (tcor.count_histogram_plain(spec, 65_536),))
    t = _alternate(lambda: tcor.count_histogram(spec, 65_536),
                   lambda: tcor.count_histogram_plain(spec, 65_536))
    clamped = torch.where(spec.key == PAD, 0, spec.count.clamp(0, 65_536)).long()
    library = _time_ms(lambda: torch.bincount(clamped, minlength=65_537), 10)
    del clamped
    out["count_histogram_global"] = _row(err, t, 4 * n_real + _nbytes(wide), n_real, library)
    _print_row(f"K16 count_histogram, global variant: {C} lanes, 65,537 bins, "
               f"{int((wide > 0).sum())} nonzero", out["count_histogram_global"], smi)
    del wide
    print(f"correction input: {spec.n} k-mers in {C} lanes, auto cut {cut}, k = {k}, "
          f"error_rate {cfg.error_rate} [{smi}]")
    probes = {}
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
        _print_row(f"K7 probe_lookup side={side}, 8 x {C} probes (walks of the 16-ary index "
                   "and the PAD and probe-group shortcuts: latency-bound, not bandwidth-bound)",
                   row, smi)
        out.setdefault("probe_lookup", row)  # the sibling set is the row kept

    def neighbors():
        return tsp.neighbor_counts(spec, k, canonical)

    def neighbors_plain():
        return tsp.neighbor_counts_plain(spec, k, canonical)

    err = _max_abs_err(neighbors(), neighbors_plain())
    t = _alternate(neighbors, neighbors_plain)
    q = torch.cat([tcor.probe_keys(spec.key, k, side, canonical) for side in ("ext", "sib")])
    library = _time_ms(lambda: torch.searchsorted(spec.key, q), 10)
    del q
    # bytes: each lane's key and count in (12), its 8 extension counts and 2
    # sibling maxima out (40); operations: 16 binary searches a real lane
    # (pads search nothing)
    out["neighbor_counts"] = _row(err, t, 52 * C, 16 * n_real * steps, library)
    _print_row(f"K28 neighbor_counts {C} lanes, {n_real} real x 16 probes (16 binary "
               "searches a lane: latency-bound, not bandwidth-bound)", out["neighbor_counts"], smi)

    sib, ext = probes["sib"], probes["ext"]
    raw, counts = tcor.cut_counts(spec, cut)
    err = _max_abs_err((raw, counts), tcor.cut_counts_plain(spec, cut))
    t = _alternate(lambda: tcor.cut_counts(spec, cut), lambda: tcor.cut_counts_plain(spec, cut))
    # bytes: the counts of the real lanes in, raw and cut of every lane out;
    # operations: one a lane
    out["abundance_cut"] = _row(err, t, 4 * n_real + 8 * C, n_real, None)
    _print_row(f"K20 abundance_cut (cut mode, the main path's) {C} lanes, cut {cut}, "
               f"{int((counts > 0).sum())} left", out["abundance_cut"], smi)
    # K8 at rounds = 1 (one round, comparable with a one-round kernel), then
    # the main path's call: the whole loop at the oracle's cap k + 2
    cand = (raw > 0) & (counts == 0)
    alive = counts > 0
    ext_alive = ext[1] & alive[ext[0]]
    rext, lext = ext_alive[0::2].any(0) & cand, ext_alive[1::2].any(0) & cand
    n_cand, n_r, n_l = int(cand.sum()), int(rext.sum()), int(lext.sum())
    # bytes: counts and raw in, counts out (12 a lane); each cut lane's 8
    # extension hit bytes and the idx of its hits; then, for a lane with an
    # alive left (right) extension, its right (left) sibling rows' hit bytes
    # and the idx of their hits
    round1 = (12 * C + 8 * n_cand + 8 * int(ext[1][:, cand].sum())
              + 4 * (n_l + n_r) + 8 * int(sib[1][0::2][:, lext].sum())
              + 8 * int(sib[1][1::2][:, rext].sum()))
    sib_hits = int(sib[1][:, cand].sum())
    del ext_alive, alive
    for rounds in (1, k + 2):
        info, want_info = {}, {}
        got = tcor.rescue_rounds(counts, raw, *sib, *ext, rounds, info)
        want = tcor.rescue_rounds_plain(counts, raw, *sib, *ext, rounds, want_info)
        err = _max_abs_err(got[:1], want[:1])
        if got[1] != want[1] or info["rescued"] != want_info["rescued"]:
            raise AssertionError("K8 disagrees with its plain version on the changed flag "
                                 "or a round's rescues")
        t = _alternate(lambda r=rounds: tcor.rescue_rounds(counts, raw, *sib, *ext, r),
                       lambda r=rounds: tcor.rescue_rounds_plain(counts, raw, *sib, *ext, r))
        # a later round's lane reads its sibling rows' hit bytes and the idx of
        # its sibling hits (as many as a cut lane's on average)
        later = sum(info["frontier"][1:]) * (8 + 8 * sib_hits / max(n_cand, 1))
        row = _row(err, t, round1 + later, C + 48 * n_cand, None)
        row.update(rounds=rounds, rounds_run=info["rounds_run"], frontier=info["frontier"],
                   rescued=info["rescued"])
        name = "rescue_rounds" if rounds > 1 else "rescue_rounds_1"
        out[name] = row
        _print_row(f"K8 rescue_rounds rounds={rounds} {C} lanes, {n_cand} dropped by the cut: "
                   f"{info['rounds_run']} rounds run, last changed {got[1]}, frontier a round "
                   f"{info['frontier']}, rescued a round {info['rescued']}", row, smi)
    counts = got[0]  # the main path's rescue, to the K9 input
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
    corrected = shrink_spectrum(first)
    del spec, cpu, first, res, keep, counts, raw
    torch.cuda.empty_cache()
    return out, stage, corrected


def _cycle_spectrum(dev, k: int, seed: int = 5):
    """A canonical spectrum of isolated cycles: 3,000 tandem-repeat units of
    30-300 random bases (the k-mers of a unit read around its circle form
    one cycle on each strand), the homopolymers (one k-mer linked to itself)
    and, beside them, 500 random 300-base chains; counts 1-60 at random."""
    import numpy as np

    from shannon_tpu_torch.ops.count import spectrum_from_arrays

    rng = np.random.default_rng(seed)
    weights = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    parts = []

    def add(codes):  # the canonical keys of every k-window of codes
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        parts.append(np.minimum(win @ weights, (3 - win[:, ::-1]) @ weights))

    for _ in range(3000):
        unit = rng.integers(0, 4, int(rng.integers(30, 301)))
        add(np.concatenate([unit, unit[: k - 1]]))
    for base in range(4):
        add(np.full(k, base, dtype=np.int64))
    for _ in range(500):
        add(rng.integers(0, 4, 300))
    keys = np.unique(np.concatenate(parts))
    counts = rng.integers(1, 61, keys.shape[0]).astype(np.int32)
    return spectrum_from_arrays(keys.astype(np.uint64), counts, device=dev)


def _condense_chain(spec, k: int, canonical: bool, label: str, smi: str):
    """K11-K15 stage by stage on one spectrum, each kernel's output feeding
    the next stage, each against its plain version on the same CUDA inputs
    (torch.equal over the full capacity) and both timed.  Returns (kernel
    rows, the stage's numbers)."""
    import math

    from shannon_tpu_torch import kernels
    from shannon_tpu_torch.ops import condense as tcd

    lib = kernels.library()
    rows = {}
    C = spec.capacity

    def nodes():
        return tcd.nodes_stage(spec, k, canonical)

    def nodes_plain():
        return tcd.nodes_stage_plain(spec, k, canonical)

    node_key, node_count, n_nodes = nodes()
    want = nodes_plain()
    if n_nodes != want[2]:
        raise AssertionError(f"K11 [{label}] n_nodes {n_nodes} != {want[2]}")
    C2 = node_key.shape[0]
    steps = math.ceil(math.log2(max(C, 2))) + 1
    # bytes: the spectrum in, the node table out; operations: a reverse
    # complement and a binary search per node lane
    rows["node_strands"] = _row(
        _max_abs_err((node_key, node_count), want[:2]), _alternate(nodes, nodes_plain),
        _nbytes(spec.key, spec.count, node_key, node_count), C2 * (10 + steps), None,
    )
    _print_row(f"K11 node_strands [{label}] {spec.n} k-mers in {C} lanes -> {n_nodes} nodes "
               f"in {C2} lanes (torch.sort and K2 inside kernel and plain)",
               rows["node_strands"], smi)

    links = tcd.links_stage(node_key, k)
    rows["group_links"] = _row(
        _max_abs_err(links, tcd.links_stage_plain(node_key, k)),
        _alternate(lambda: tcd.links_stage(node_key, k), lambda: tcd.links_stage_plain(node_key, k)),
        _nbytes(node_key, *links), 16 * C2, None,
    )
    _print_row(f"K12 group_links [{label}] {2 * C2} link records (torch.sort inside kernel "
               "and plain)", rows["group_links"], smi)
    prev, rec_lane, first_p, p_cnt = links

    before = lib.launches["label_round"]
    ptr, dist, has_cycle = tcd.label_stage(prev)
    rounds = lib.launches["label_round"] - before
    want = tcd.label_stage_plain(prev)
    if has_cycle != want[2]:
        raise AssertionError(f"K13 [{label}] has_cycle {has_cycle} != {want[2]}")
    # bytes: the links in, (pointer, offset) out; operations: a few a lane
    # a round
    rows["label_round"] = _row(
        _max_abs_err((ptr, dist), want[:2]),
        _alternate(lambda: tcd.label_stage(prev), lambda: tcd.label_stage_plain(prev)),
        _nbytes(prev, ptr, dist), 4 * rounds * C2, None,
    )
    _print_row(f"K13 label_round [{label}] {C2} lanes, {rounds} rounds (one launch and one "
               f"flag read each), has_cycle {has_cycle}", rows["label_round"], smi)
    if has_cycle:
        before = lib.launches["cycle_round"]
        cut = tcd.cycle_fix(prev)
        c_rounds = lib.launches["cycle_round"] - before
        rows["cycle_round"] = _row(
            _max_abs_err((cut,), (tcd.cycle_fix_plain(prev),)),
            _alternate(lambda: tcd.cycle_fix(prev), lambda: tcd.cycle_fix_plain(prev)),
            _nbytes(prev, cut), 4 * c_rounds * C2, None,
        )
        n_cut = int(((cut < 0) & (prev >= 0)).sum())
        _print_row(f"K13 cycle_round [{label}] {C2} lanes, {c_rounds} rounds, {n_cut} cycles cut",
                   rows["cycle_round"], smi)
        prev = cut
        ptr, dist, again = tcd.label_stage(prev)
        want = tcd.label_stage_plain(prev)
        _max_abs_err((ptr, dist), want[:2])
        if again or want[2]:
            raise AssertionError(f"K13 [{label}] a cycle survived the cut")

    args = (node_key, node_count, n_nodes, prev, ptr, dist, rec_lane, first_p, p_cnt, k, canonical)
    ca, want = tcd.reduce_stage(*args), tcd.reduce_stage_plain(*args)
    if (ca.n_nodes, ca.n_contigs) != (want.n_nodes, want.n_contigs):
        raise AssertionError(f"K14 [{label}] n_contigs {ca.n_contigs} != {want.n_contigs}")
    fields = ("node_cid", "node_off", "klen", "abundance", "count_sum", "head_lane",
              "tail_lane", "out_edges", "rc_pair")
    n = ca.n_contigs
    n_edges = int((ca.out_edges[:, :n] >= 0).sum())
    # bytes: the labeled node table and the link directory in (the link
    # records only at the tails' successor runs), the contig arrays out;
    # operations: a few a lane and a binary search per contig twin
    rows["contig_reduce"] = _row(
        _max_abs_err([getattr(ca, f) for f in fields], [getattr(want, f) for f in fields]),
        _alternate(lambda: tcd.reduce_stage(*args), lambda: tcd.reduce_stage_plain(*args)),
        _nbytes(node_key, node_count, prev, ptr, dist, first_p, p_cnt) + 8 * n_edges
        + _nbytes(*(getattr(ca, f) for f in fields)),
        10 * C2 + n * (math.ceil(math.log2(max(C2, 2))) + 1), None,
    )
    _print_row(f"K14 contig_reduce [{label}] {C2} lanes -> {n} contigs, {n_edges} edges "
               "(torch.cumsum inside)", rows["contig_reduce"], smi)

    streams = tcd.contig_base_streams(ca, k)
    rows["base_streams"] = _row(
        _max_abs_err(streams, tcd.contig_base_streams_plain(ca, k)),
        _alternate(lambda: tcd.contig_base_streams(ca, k),
                   lambda: tcd.contig_base_streams_plain(ca, k)),
        _nbytes(ca.node_key, ca.node_cid, ca.node_off, *streams) + 16 * n,
        C2 + n * (k - 1), None,
    )
    _print_row(f"K15 base_streams [{label}] {streams[0].numel()} tail bases, {n} x {k - 1} head "
               "bases (torch.cumsum inside)", rows["base_streams"], smi)

    whole_ms = _time_ms(lambda: tcd.build_contig_arrays(spec, k, canonical), 3)
    print(f"build_contig_arrays [{label}] on K11-K14: {whole_ms:.3f} ms (CUDA events, mean of 3) "
          f"[{smi}]")
    stage = {"n_kmers": spec.n, "lanes": C, "node_lanes": C2, "n_nodes": n_nodes,
             "n_contigs": n, "label_rounds": rounds, "has_cycle": has_cycle,
             "build_contig_arrays_ms": whole_ms}
    return rows, stage


def _clip_rows(spec, watch: Watch, smi: str) -> dict:
    """K18 and K19 against their plain versions on the arguments one clip
    of `spec` at the default AssemblyConfig gives them (kept by `watch`)."""
    import math

    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.ops import tipclip

    cfg = AssemblyConfig()
    watch.reset()
    watch.keep_args = ("drop_contigs", "clip_remap")
    tipclip.clip_tips_graph(spec, cfg, not cfg.strand_specific)
    watch.keep_args = ()
    (doomed_any, cycle_merged), = watch.clips
    if not doomed_any or cycle_merged:
        raise AssertionError("the main path's clip doomed nothing or closed a cycle, so it gave "
                             "the drop and the remap no arguments to check K18 and K19 on")
    rows = {}

    args = watch.first_args.pop("drop_contigs")
    sp, ca, doomed = args
    drop = watch.originals["drop_contigs"]
    got, want = drop(*args), tipclip._drop_contigs_plain(*args)
    if got.n != want.n:
        raise AssertionError(f"K18 n {got.n} != {want.n}")
    C, C2 = sp.capacity, ca.node_key.numel()
    steps = math.ceil(math.log2(C2)) + 1
    # bytes, what this clip's data needs: the real spectrum lanes in (12
    # bytes), the keys of the real nodes (one pass, as a merge join reads
    # them), the contig id at each real k-mer's node (every k-mer is a node:
    # the table was condensed from this spectrum), one doom flag a contig,
    # and the clipped table of C lanes out; operations: a binary search per
    # real spectrum lane (pads do none)
    n_sp = min(sp.n, C)
    rows["drop_contigs"] = _row(
        _max_abs_err((got.key, got.count), (want.key, want.count)),
        _alternate(lambda: drop(*args), lambda: tipclip._drop_contigs_plain(*args)),
        12 * n_sp + 8 * ca.n_nodes + 8 * n_sp + ca.n_contigs + 12 * C,
        n_sp * steps, None,
    )
    _print_row(f"K18 drop_contigs {C} spectrum lanes in {C2} node lanes, "
               f"{int(doomed.sum())} contigs doomed, {sp.n} -> {got.n} k-mers (then torch.cumsum "
               "and K10, as in the plain version)", rows["drop_contigs"], smi)

    args = watch.first_args.pop("clip_remap")
    ca, new_cid, off_shift, hlane, tlane, klen, csum, _rc, _oe, n_new, out_cap = args
    remap = watch.originals["clip_remap"]
    got, want = remap(*args), tipclip._device_clip_remap_plain(*args)
    if (got.n_nodes, got.n_contigs) != (want.n_nodes, want.n_contigs):
        raise AssertionError(f"K19 n_nodes {got.n_nodes} != {want.n_nodes}")
    fields = ("node_key", "node_count", "node_cid", "node_off", "head_lane", "tail_lane")
    err = _max_abs_err([getattr(got, f) for f in fields] + [got.abundance.view(torch.int32)],
                       [getattr(want, f) for f in fields] + [want.abundance.view(torch.int32)])
    M = klen.numel()
    # bytes, what this clip's data needs: the contig id of each real node
    # lane, the two maps of each old contig, the key, count and offset (20
    # bytes) of each kept lane that fits out_cap, and head lane, tail lane,
    # k-mer count and count sum of each new contig in; the compacted node
    # table (28 bytes a lane) and head, tail and abundance (20 bytes a
    # contig lane) out; operations: a few a lane
    n_moved = min(got.n_nodes, out_cap)
    rows["clip_remap"] = _row(
        err, _alternate(lambda: remap(*args), lambda: tipclip._device_clip_remap_plain(*args)),
        8 * ca.n_nodes + 16 * ca.n_contigs + 20 * n_moved + 32 * n_new + 28 * out_cap + 20 * M,
        ca.n_nodes + M, None,
    )
    _print_row(f"K19 clip_remap {ca.node_key.numel()} -> {out_cap} node lanes, {got.n_nodes} "
               f"kept, {n_new} merged contigs (torch.cumsum inside)", rows["clip_remap"], smi)
    watch.reset()
    return rows


def condense_phase(spec, dev, smi: str, watch: Watch):
    """K11-K15 on the main path's input (the corrected, shrunk spectrum of
    the single-end scale dataset at the default AssemblyConfig), then on the
    synthetic cycle spectrum, where cycle_round must run; every other
    kernel's max_abs_err covers both inputs.  Then K18 and K19 on the
    arguments one clip of the main input gives them."""
    import torch

    from shannon_tpu_torch.config import AssemblyConfig

    cfg = AssemblyConfig()
    k, canonical = cfg.k, not cfg.strand_specific
    rows, stage = _condense_chain(spec, k, canonical, "main path", smi)
    cyc_spec = _cycle_spectrum(dev, k)
    cyc_rows, cyc_stage = _condense_chain(cyc_spec, k, canonical, "cycle input", smi)
    if not cyc_stage["has_cycle"]:
        raise AssertionError("the cycle input's labels found no cycle")
    for name, row in cyc_rows.items():
        if name in rows:
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], row["max_abs_err"])
        else:
            rows[name] = row
    del cyc_spec
    rows.update(_clip_rows(spec, watch, smi))
    torch.cuda.empty_cache()
    return rows, {"main": stage, "cycle_input": cyc_stage}


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
    """K6 against its plain version on 4,096 jobs; K29 (the unpacked greedy,
    which no path runs) on the same jobs expanded to their seeded restart
    rows, against its plain version and, row chosen by row, against K6;
    then the batched solver
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
    rows = tsf.restart_rows(buf, R)  # each job's R + 1 seeded rows, as K6 expands them
    flows = tsf.batched_greedy(*rows)
    err = _max_abs_err((flows.view(torch.int32),),
                       (tsf.batched_greedy_plain(*rows).view(torch.int32),))
    per_job = flows.reshape(buf.shape[0], R + 1, tsf.MAXD, tsf.MAXD)
    won = per_job[torch.arange(buf.shape[0], device=dev), tsf.best_restart(per_job)]
    if not torch.equal(won.view(torch.int32), got[0].view(torch.int32)):
        raise AssertionError("K29's winning restart rows differ from K6's flow tensors")
    t = _alternate(lambda: tsf.batched_greedy(*rows), lambda: tsf.batched_greedy_plain(*rows))
    # per row: at most 16 greedy steps of about 4 operations on each of the
    # 64 cells, as K6's rows
    out["sf_jobs"] = _row(err, t, _nbytes(*rows, flows), rows[0].shape[0] * 16 * 64 * 4, None)
    _print_row(f"K29 sf_jobs {rows[0].shape[0]} rows ({buf.shape[0]} jobs x {R + 1} seeded "
               "restarts; flows bitwise; each job's winning row == K6's flows)",
               out["sf_jobs"], smi)
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


def _launches_check(launches: dict, phase: str, cut: int, clips: list,
                    sharded: bool = False, merged: bool = True) -> None:
    """Every kernel launched in the phase but K21-K23 (ENTRY_ONLY), K24
    (assembly counts packed words) and K28-K29 (TESTS_ONLY); K25 only where
    the count is sharded; K17 only where the count merged (merged: its
    reads filled more than one batch); K8 only where the phase's auto
    abundance cut is above 1, K13's cycle_round only where its labels found
    a cycle, K18 and K19 only where the phase's clip doomed a contig, and
    K19 only where no merge of the clip closed a cycle."""
    missing = [name for name, count in launches.items() if count == 0]
    for name, label in TESTS_ONLY.items():
        if name in missing:
            missing.remove(name)
            print(f"the {phase} phase launched no {name} ({label}): no path runs it; the "
                  "reference runs it in its tests only (the kernel phase checks it)")
    if "merge_spectra" in missing and not merged:
        missing.remove("merge_spectra")
        print(f"the {phase} phase launched no merge_spectra (K17): each of its counts fit one "
              f"batch of {BATCH_READS} reads, so none merged")
    for name, label in ENTRY_ONLY.items():
        if name in missing:
            missing.remove(name)
            print(f"the {phase} phase launched no {name} ({label}): assembly never runs it "
                  "(the entry phase checks K22 and K23 in the flagship step; K21's work there is "
                  "inside K22)")
    if "extract_codes" in missing:
        missing.remove("extract_codes")
        print(f"the {phase} phase launched no extract_codes (K24): assembly counts and "
              "threads packed words; dryrun_multichip runs K24 (the sharded phase checks it)")
    if "owner_buckets" in missing and not sharded:
        missing.remove("owner_buckets")
        print(f"the {phase} phase launched no owner_buckets (K25): its count is not "
              "sharded (one shard on one card; the sharded phase checks K25)")
    for name, label in OWNERSHIP_KERNELS.items():
        if name in missing:
            missing.remove(name)
            print(f"the {phase} phase launched no {name} ({label}): it runs in one process, "
                  "and K26 and K27 run only in a multi-process run in 'ownership' mode (the "
                  "multi-process phase checks them)")
    if "rescue_rounds" in missing and cut == 1:
        missing.remove("rescue_rounds")
        print(f"the {phase} phase launched no rescue_rounds (K8): its auto abundance "
              "cut is 1, and dead-end rescue runs only when the cut drops k-mers")
    if "cycle_round" in missing:
        missing.remove("cycle_round")
        print(f"the {phase} phase launched no cycle_round (K13): its labels found no "
              "cycle, and the cycle cut runs only when they find one")
    doomed = any(d for d, _ in clips)
    for name, label in (("drop_contigs", "K18"), ("clip_remap", "K19")):
        if name in missing and not doomed:
            missing.remove(name)
            print(f"the {phase} phase launched no {name} ({label}): its tip clip doomed "
                  "no contig, and the drop and the remap run only when it dooms one")
    if "clip_remap" in missing and any(c for _, c in clips):
        missing.remove("clip_remap")
        print(f"the {phase} phase launched no clip_remap (K19): a merge of its tip clip "
              "closed a cycle, and the caller then condenses the clipped spectrum anew")
    if missing:
        raise AssertionError(f"the {phase} phase launched no {missing} kernel")
    print(f"the {phase} phase launched merge_spectra (K17) {launches['merge_spectra']} "
          f"times; its clips (any doomed, cycle merged): {clips}")


def single_scale_phase(truth, reads, dev, lib, watch: Watch, smi: str) -> dict:
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.eval import evaluate
    from shannon_tpu_torch.utils.timing import StageTimer
    from shannon_tpu_torch.pipeline import assemble

    timer = StageTimer(echo=False)
    torch.cuda.reset_peak_memory_stats(dev)
    lib.reset_counts()
    watch.reset()
    watch.keep_args = ("thread_lookup",)  # for main_lookup_row
    t0 = time.perf_counter()
    res = assemble(reads, AssemblyConfig(), device=dev, timer=timer)
    torch.cuda.synchronize(dev)
    e2e = time.perf_counter() - t0
    watch.keep_args = ()
    launches, clips = dict(lib.launches), list(watch.clips)
    merges = {"calls": len(watch.merges), "ms": watch.merge_ms()}
    quality = evaluate(truth, [t.seq for t in res.transcripts], k=24)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"single-end scale: {len(reads)} reads in {e2e:.2f} s = {len(reads) / e2e:.1f} reads/s, "
          f"peak device memory {peak / 2**30:.2f} GiB [{smi}]")
    print("stages " + json.dumps(timer.stages) + f" [{smi}]")
    print(f"merges (K17): {merges['calls']} calls, {merges['ms']:.3f} ms of the stream "
          f"between CUDA events around them, inside count_s "
          f"{timer.stages['spectrum+graph']['count_s']:.3f} s [{smi}]")
    print("quality " + json.dumps(quality))
    print("launches " + json.dumps(launches))
    if quality["recall_exact"] < 0.99:
        raise AssertionError(f"single-end exact recall {quality['recall_exact']} < 0.99")
    _launches_check(launches, "single-end scale",
                    timer.stages["spectrum+graph"]["auto_min_abundance"], clips)
    return {"n_reads": len(reads), "e2e_s": e2e, "reads_per_s": len(reads) / e2e,
            "max_memory_allocated_bytes": peak, "stages": timer.stages, "stats": res.stats,
            "quality": quality, "launches": launches, "clips": clips, "merges": merges}, res


def main_lookup_row(watch: Watch, smi: str) -> dict:
    """K3 on what the main path gives it (kept by `watch` in the single-end
    scale phase): threading's first lookup, the first read batch's
    non-canonical windows in the node table after tip clip, against its
    plain version, with torch.searchsorted as the library call."""
    import math

    import torch

    from shannon_tpu_torch.ops.spectrum import lookup_sorted_plain

    table, query = watch.first_args.pop("thread_lookup")
    lookup = watch.originals["thread_lookup"]
    got, want = lookup(table, query), lookup_sorted_plain(table, query)
    err = _max_abs_err(got, want)
    t = _alternate(lambda: lookup(table, query), lambda: lookup_sorted_plain(table, query))
    library = _time_ms(lambda: torch.searchsorted(table, query.reshape(-1)), 10)
    steps = math.ceil(math.log2(table.numel())) + 1
    row = _row(err, t, _nbytes(table, query, *got), query.numel() * steps, library)
    _print_row(f"K3 lookup_sorted, the main path's: the first read batch's {query.numel()} "
               f"windows in the {table.numel()}-lane node table ({int(got[1].sum())} hits)",
               row, smi)
    return row


def owner_row(batch, dev, smi: str) -> dict:
    """K25 against its plain version at the sharded count's shape: shard 0's
    local spectrum of the scale dataset's first batch (its first 1/SHARDS
    rows, the default config: k = 24, capacity 2^22), bucketed for SHARDS
    owners at the default bucket_cap (2^20); then at the widest owner's key
    count less one, where the flag must go up."""
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.ops.count import count_window_keys, upload_words
    from shannon_tpu_torch.ops.kmers import extract_kmers_packed
    from shannon_tpu_torch.parallel import distributed as td

    cfg = AssemblyConfig()
    rows = cfg.batch_reads // SHARDS
    m = batch.mask_rows(0, rows)
    keys, _ = extract_kmers_packed(
        upload_words(batch.words[:rows], dev), torch.from_numpy(batch.lengths[:rows]).to(dev),
        cfg.k, True, batch.pad_length, None if m is None else upload_words(m, dev),
    )
    local = count_window_keys(keys, cfg.kmer_capacity)
    n_real = min(local.n, local.capacity)
    bucket_cap = td.default_bucket_cap(cfg.kmer_capacity, SHARDS)
    widest = int(torch.bincount(td.owner_of(local.key[:n_real], SHARDS)).max())
    errs = []
    for cap, overflows in ((bucket_cap, False), (widest - 1, True)):
        args = (local.key, local.count, SHARDS, cap)
        got = td.owner_buckets(*args)
        errs.append(_max_abs_err(got, td.owner_buckets_plain(*args)))
        if bool(got[2]) != overflows:
            raise AssertionError(f"K25 at bucket_cap {cap}: overflow flag {bool(got[2])}")
    args = (local.key, local.count, SHARDS, bucket_cap)
    t = _alternate(lambda: td.owner_buckets(*args), lambda: td.owner_buckets_plain(*args))
    # bytes: the real lanes' keys and counts in, the [D, bucket_cap] keys and
    # counts out; operations: a hash and a rank a real lane
    row = _row(max(errs), t, 12 * n_real + 12 * SHARDS * bucket_cap, 8 * n_real, None)
    _print_row(f"K25 owner_buckets, shard 0 of the first batch: {local.capacity} lanes, {n_real} "
               f"real, {SHARDS} owners x {bucket_cap} (widest owner {widest} keys; at "
               f"bucket_cap {widest - 1} the flag is up)", row, smi)
    return row


def sharded_phase(truth, reads, single, dev, lib, watch: Watch, smi: str) -> tuple[dict, dict]:
    """The multi-device counting path on SHARDS shards of the one card:
    dryrun_multichip(SHARDS) (its figures == DRYRUN_FIGURES, K24 and K25
    launched); count_reads_spectrum_sharded on the scale dataset at the
    default config == count_reads_spectrum, both timed in turns (single,
    sharded, sharded, single); assemble at n_devices = SHARDS == the
    single-end scale phase's transcripts (`single`), recall >= 0.99.  Each
    step's launches are counted from 0 just before it and read just after.
    Returns (the phase's numbers, K25's row)."""
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.entry import dryrun_multichip
    from shannon_tpu_torch.eval import evaluate
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops.count import count_reads_spectrum
    from shannon_tpu_torch.parallel.distributed import count_reads_spectrum_sharded
    from shannon_tpu_torch.parallel.mesh import make_mesh
    from shannon_tpu_torch.pipeline import assemble
    from shannon_tpu_torch.utils.timing import StageTimer

    launches = {}

    def counted(step: str, fn):
        lib.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        launches[step] = dict(lib.launches)
        return out, time.perf_counter() - t0

    figures, dry_s = counted("dryrun", lambda: _with_card(
        lambda: dryrun_multichip(SHARDS, device=dev), smi))
    if figures != DRYRUN_FIGURES:
        raise AssertionError(f"dryrun_multichip gave {figures}, the reference {DRYRUN_FIGURES}")
    for name in ("extract_codes", "owner_buckets"):
        if launches["dryrun"][name] == 0:
            raise AssertionError(f"dryrun_multichip launched no {name}")
    print(f"dryrun_multichip({SHARDS}): {dry_s:.2f} s, figures == the reference's [{smi}]")

    cfg = AssemblyConfig()
    batch = pack_reads(reads, pad_length=cfg.read_pad_length)
    row = owner_row(batch, dev, smi)
    mesh = make_mesh(SHARDS, dev)
    steps = {
        "single": lambda: count_reads_spectrum(batch, cfg.k, cfg.kmer_capacity, True,
                                               cfg.batch_reads, device=dev),
        "sharded_count": lambda: count_reads_spectrum_sharded(batch, cfg.k, cfg.kmer_capacity,
                                                              mesh, True, cfg.batch_reads),
    }
    times = {name: [] for name in steps}
    out = {}
    for name in ("single", "sharded_count", "sharded_count", "single"):
        out[name], secs = counted(name, steps[name])
        times[name].append(secs)
    spec, overflowed = out["sharded_count"]
    one = out["single"]
    if overflowed or spec.n != one.n or not (
        torch.equal(spec.key, one.key) and torch.equal(spec.count, one.count)
    ):
        raise AssertionError(f"the sharded count (overflowed {overflowed}) != the single count")
    missing = [name for name in SHARDED_KERNELS if launches["sharded_count"][name] == 0]
    if missing:
        raise AssertionError(f"the sharded count launched no {missing}")
    print(f"sharded count: {len(reads)} reads, {SHARDS} shards on one card, k = {cfg.k}, "
          f"{cfg.kmer_capacity} lanes a shard: {spec.n} k-mers == the single count; "
          f"sharded {', '.join(f'{x:.3f}' for x in times['sharded_count'])} s, single "
          f"{', '.join(f'{x:.3f}' for x in times['single'])} s (host clock, synchronized) [{smi}]")
    print("sharded count launches " + json.dumps({k: v for k, v in
                                                  launches["sharded_count"].items() if v}))
    del spec, one, out, batch

    timer = StageTimer(echo=False)
    watch.reset()
    res, e2e = counted("sharded_scale", lambda: assemble(
        reads, AssemblyConfig(n_devices=SHARDS), device=dev, timer=timer))
    notes = timer.stages["spectrum+graph"]
    _launches_check(launches["sharded_scale"], "sharded scale", notes["auto_min_abundance"],
                    list(watch.clips), sharded=True)
    if res.canonical_set() != single.canonical_set():
        raise AssertionError("the n_devices = 8 assembly differs from the single-end phase's")
    quality = evaluate(truth, [t.seq for t in res.transcripts], k=24)
    if quality["recall_exact"] < 0.99:
        raise AssertionError(f"sharded exact recall {quality['recall_exact']} < 0.99")
    print(f"sharded scale: {len(reads)} reads at n_devices = {SHARDS} in {e2e:.2f} s, count_s "
          f"{notes['count_s']:.3f} s, the single-end phase's {len(res.transcripts)} transcripts, "
          f"recall {quality['recall_exact']} [{smi}]")
    print("sharded launches " + json.dumps({k: v for k, v in
                                            launches["sharded_scale"].items() if v}))
    path = {name: sum(launches[step][name] for step in ("dryrun", "sharded_count",
                                                         "sharded_scale"))
            for name in launches["dryrun"]}
    return {"dryrun_s": dry_s, "dryrun_figures": figures, "count_s": times,
            "e2e_s": e2e, "stages": timer.stages, "quality": quality, "launches": path,
            "launches_by_step": launches}, row


def _group_script():
    """scripts/multihost_smoke_torch.py of this tree (its child mode and
    launch_group)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / "multihost_smoke_torch.py"
    spec = importlib.util.spec_from_file_location("multihost_smoke_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ownership_rows(evidence: Path, n_ranks: int, dev, smi: str) -> dict:
    """K26 and K27 against their plain versions on rank 0's local evidence
    and owner table of the full-width run, as route_evidence_ownership got
    them (K26 packs them for n_ranks ranks at rank 0's own widest bucket;
    K27 unpacks that buffer, an [H, cap] buffer as an exchange delivers)."""
    import numpy as np
    import torch

    from shannon_tpu_torch.parallel import multihost as tmh

    ev = np.load(evidence)
    args = [torch.from_numpy(ev[name].astype(np.int32)).to(dev)
            for name in ("flat", "offs", "weights", "owner")]
    n_paths, n_flat = args[1].shape[0] - 1, args[0].shape[0]
    plain_args = [a.cpu() for a in args]
    got = tmh.ownership_pack(*args, n_ranks)
    err = _max_abs_err([x.cpu() for x in got], tmh.ownership_pack_plain(*plain_args, n_ranks))
    send = got[0]
    t = _alternate(lambda: tmh.ownership_pack(*args, n_ranks),
                   lambda: tmh.ownership_pack_plain(*args, n_ranks))
    # bytes: flat, offs and weights in, one owner a path, the [H, cap] buffer out
    rows = {"ownership_pack": _row(err, t, 4 * (n_flat + 3 * n_paths + 1) + 4 * send.numel(),
                                   0, None)}
    _print_row(f"K26 ownership_pack, rank 0's evidence of the full-width run: {n_paths} paths, "
               f"{n_flat} node ids, {n_ranks} ranks x {send.shape[1]} words", rows["ownership_pack"],
               smi)
    got = tmh.ownership_unpack(send)
    err = _max_abs_err([x.cpu() for x in got], tmh.ownership_unpack_plain(send.cpu()))
    t = _alternate(lambda: tmh.ownership_unpack(send), lambda: tmh.ownership_unpack_plain(send))
    # bytes: the [H, cap] buffer in; int64 flat, offs and weights out
    rows["ownership_unpack"] = _row(err, t, 4 * send.numel() + 8 * (n_flat + 2 * n_paths + 1),
                                    0, None)
    _print_row(f"K27 ownership_unpack of that buffer: {n_paths} paths, {n_flat} node ids",
               rows["ownership_unpack"], smi)
    return rows


def multihost_phase(reads, p_reads, single, dev, smi: str) -> tuple[dict, dict]:
    """The multi-process path: groups of ranks under torchrun
    (scripts/multihost_smoke_torch.py's child mode), each rank on one card
    (LOCAL_RANK mod the visible cards; CUDA_VISIBLE_DEVICES=0 here, so they
    share card 0 over gloo, as init_distributed's rule picks).  One group of
    2 ranks runs, in order: full width, the scale dataset's single-end reads
    as a FASTA in 'ownership' mode, whose transcripts (every rank's, and
    rank 0's transcripts.fasta) must be the single-end phase's and whose
    replicated spectrum count_reads_spectrum's of the reads here; at
    MULTIHOST_SMALL reads (the first), 'replicate'; the paired dataset's
    first MULTIHOST_SMALL reads as two mate files (ingest_paired_files_range)
    in 'ownership' mode.  One group of 4 ranks runs the MULTIHOST_SMALL reads
    in 'ownership' mode (batches of 32,768 reads a rank, so that K17
    merges).  Each smaller run must equal run_pipeline of its files in this
    process.  K1, K2, K25 and K17 must launch in every rank in every run,
    K26 and K27 in every rank in every 'ownership' run.  Then K26 and K27
    against their plain versions on rank 0's evidence of the full-width
    run.  With two cards or more, one more group of 2 ranks on two cards at
    MULTIHOST_SMALL reads, over nccl.  Returns (the phase's numbers with its
    launches summed over every rank and run, K26's and K27's rows)."""
    import numpy as np
    import torch

    from shannon_tpu_torch.config import AssemblyConfig
    from shannon_tpu_torch.io.dna import revcomp_str
    from shannon_tpu_torch.io.fastx import read_fastx, write_fasta
    from shannon_tpu_torch.io.pack import pack_reads
    from shannon_tpu_torch.ops.count import count_reads_spectrum
    from shannon_tpu_torch.pipeline import run_pipeline

    script = _group_script()
    torch.cuda.empty_cache()
    report, launches = {"groups": {}}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        full, small = tmp / "reads.fasta", tmp / "small.fasta"
        write_fasta(full, ((f"r{i}", s) for i, s in enumerate(reads)))
        write_fasta(small, ((f"r{i}", s) for i, s in enumerate(reads[:MULTIHOST_SMALL])))
        left, right = _write_mates(p_reads[:MULTIHOST_SMALL], tmp)
        print(f"multi-process: inputs written in {time.perf_counter() - t0:.1f} s [{smi}]")

        def one_process(name: str, **inputs) -> set:
            cfg = AssemblyConfig(read_pad_length=MULTIHOST_PAD, out_dir=str(tmp / name))
            t0 = time.perf_counter()
            res = _with_card(lambda: run_pipeline(cfg, device=dev, **inputs), smi)
            print(f"multi-process: the one-process run_pipeline of the {name} files in "
                  f"{time.perf_counter() - t0:.2f} s, {len(res.transcripts)} transcripts [{smi}]")
            return res.canonical_set()

        def group(label: str, n_ranks: int, runs: list, extra: tuple = (),
                  visible: str = "0") -> list[dict]:
            """One group of n_ranks ranks; runs: (name, mode, input, the
            expected canonical transcript set)."""
            work = tmp / label
            t0 = time.perf_counter()
            markers, _out = script.launch_group(n_ranks, [
                *(x for name, mode, source, _ in runs for x in ("--job", name, mode, source)),
                "--device", dev.type, "--pad", str(MULTIHOST_PAD),
                "--capacity", str(AssemblyConfig.kmer_capacity), *extra,
            ], work, timeout=GROUP_TIMEOUT, env_extra={"CUDA_VISIBLE_DEVICES": visible})
            wall = time.perf_counter() - t0
            backends = sorted({m["backend"] for m in markers})
            cards = sorted({m.get("card", m["device"]) for m in markers})
            for name, mode, _source, want in runs:
                need = list(SHARDED_KERNELS)
                if mode == "ownership":
                    need += list(OWNERSHIP_KERNELS)
                for m in markers:
                    rec = m["runs"][name]
                    missing = [k for k in need if rec["launches"][k] == 0]
                    if missing:
                        raise AssertionError(f"{name}: rank {m['rank']} launched no {missing}")
                    if set(rec["transcripts"]) != want:
                        raise AssertionError(f"{name}: rank {m['rank']}'s transcripts differ "
                                             f"({len(rec['transcripts'])} against {len(want)})")
                    for kernel, count in rec["launches"].items():
                        launches[kernel] = launches.get(kernel, 0) + count
                got = {min(s, revcomp_str(s)) for _h, s in read_fastx(work / name /
                                                                    "transcripts.fasta")}
                if got != want:
                    raise AssertionError(f"{name}: rank 0's transcripts.fasta differs")
                recs = [m["runs"][name] for m in markers]
                print(f"multi-process {name}: {n_ranks} ranks over {'/'.join(backends)} on "
                      f"{cards}, '{mode}', run_pipeline "
                      f"{', '.join(f'{r['wall_s']:.2f}' for r in recs)} s (rank 0's count_s "
                      f"{recs[0]['stages']['spectrum+graph']['count_s']:.3f} s), "
                      f"{recs[0]['n_transcripts']} transcripts == the reference run's; local "
                      f"reads {[r['local_reads'] for r in recs]}; volumes of rank 0 "
                      f"{recs[0]['volumes']} [{smi}]")
                report["groups"][name] = {
                    "ranks": n_ranks, "mode": mode, "backend": backends,
                    "pipeline_s": [r["wall_s"] for r in recs], "stages": recs[0]["stages"],
                    "local_reads": [r["local_reads"] for r in recs],
                    "volumes": [r["volumes"] for r in recs],
                    "launches": [r["launches"] for r in recs],
                }
            clocks = [m["clock"] for m in markers]
            print(f"multi-process group {label}: {wall:.1f} s from launch to exit; seconds from "
                  f"the launch to each rank's start, joining, runs' end, end: "
                  f"{[[round(c[k], 1) for k in ('start', 'joined', 'runs_done', 'end')] for c in clocks]}, "
                  f"the group's exit {clocks[0]['exited']:.1f} [{smi}]")
            report["groups"][label] = {"wall_s": wall, "clocks": clocks}
            return markers

        small_set = one_process("small single-end", single=str(small))
        paired_set = one_process("small paired", left=left, right=right)
        group("two", 2, [
            ("full-width", "ownership", str(full), single.canonical_set()),
            ("small-replicate", "replicate", str(small), small_set),
            ("small-paired", "ownership", f"{left},{right}", paired_set),
        ], ("--save-evidence", "full-width"))
        cfg = AssemblyConfig()
        one = count_reads_spectrum(pack_reads(reads, pad_length=MULTIHOST_PAD), cfg.k,
                                   cfg.kmer_capacity, True, cfg.batch_reads, device=dev)
        kmers = one.key[: one.n].cpu().numpy().astype(np.uint64)
        counts = one.count[: one.n].cpu().numpy()
        for r in range(2):
            got = np.load(tmp / "two" / f"full-width.spectrum.p{r}.npz")
            if not (np.array_equal(got["kmers"], kmers) and np.array_equal(got["counts"], counts)):
                raise AssertionError(f"full-width: rank {r}'s spectrum != the one-process count")
        print(f"multi-process full-width: {len(reads)} reads, the replicated spectrum of every "
              f"rank == count_reads_spectrum here ({one.n} k-mers) [{smi}]")
        del one
        group("four", 4, [("small-ownership", "ownership", str(small), small_set)],
              ("--batch-reads", "32768"))
        if torch.cuda.device_count() < 2:
            print("nccl: not run (one card)")
            report["nccl"] = "not run (one card)"
        else:
            markers = group("nccl", 2, [("small-nccl", "ownership", str(small), small_set)],
                            visible="0,1")
            if {m["backend"] for m in markers} != {"nccl"}:
                raise AssertionError("the group on two cards did not run over nccl")
            report["nccl"] = "passed"
        rows = _ownership_rows(tmp / "two" / "full-width.evidence.p0.npz", 2, dev, smi)
    report["launches"] = {name: launches.get(name, 0) for name in REPLACES}
    return report, rows


def paired_scale_phase(truth, reads, dev, lib, watch: Watch, smi: str) -> dict:
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
        watch.reset()
        t0 = time.perf_counter()
        _run_cli(argv, smi)
        torch.cuda.synchronize(dev)
        e2e = time.perf_counter() - t0
        launches, clips = dict(lib.launches), list(watch.clips)
        merges = {"calls": len(watch.merges), "ms": watch.merge_ms()}
        peak = torch.cuda.max_memory_allocated(dev)
        stages = json.loads((out / "stats.json").read_text())["stages"]
        _launches_check(launches, "paired scale", stages["spectrum+graph"]["auto_min_abundance"],
                        clips)
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
    print(f"paired merges (K17): {merges['calls']} calls, {merges['ms']:.3f} ms of the "
          f"stream between CUDA events around them, inside count_s "
          f"{stages['spectrum+graph']['count_s']:.3f} s [{smi}]")
    print("paired quality " + json.dumps(quality))
    print("paired launches " + json.dumps(launches))
    if quality["recall_exact"] < PAIRED_RECALL_GATE:
        raise AssertionError(
            f"paired exact recall {quality['recall_exact']} < {PAIRED_RECALL_GATE}"
        )
    return {"n_reads": len(reads), "e2e_s": e2e, "reads_per_s": len(reads) / e2e,
            "resume_s": resume_s, "max_memory_allocated_bytes": peak, "stages": stages,
            "n_transcripts": len(seqs), "quality": quality, "launches": launches,
            "clips": clips, "merges": merges}


def quality_phase(dev, lib, watch: Watch, smi: str) -> dict:
    """The quality gates on the card: shannon_tpu_torch.quality's four
    sections at the reference's sizes, on CUDA, each held to the reference
    backend QUALITY_BACKEND's figures (QUALITY_FIGURES); launches counted
    from 0 over the four and checked as a scale phase's."""
    import torch

    from shannon_tpu_torch import quality

    lib.reset_counts()
    watch.reset()
    out = {"sections": {}}
    for name, run in quality.SECTIONS.items():
        t0 = time.perf_counter()
        section = run("device", dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        got = (section["sha256"], quality.section_sha256(section))
        figures = QUALITY_FIGURES[name]
        if got != figures[QUALITY_BACKEND]:
            raise AssertionError(f"quality {name}: {got} != the reference {QUALITY_BACKEND} "
                                 f"backend's {figures[QUALITY_BACKEND]}")
        equal = [b for b, f in figures.items() if f == got]
        print(f"quality {name}: {wall:.1f} s, transcripts {got[0]}, section {got[1]} == the "
              f"reference's {' and '.join(equal)} backend(s); " + json.dumps(
                  quality.headline(name, section)) + f" [{smi}]")
        out["sections"][name] = {"wall_s": wall, "sha256": got[0], "section_sha256": got[1],
                                 "equals": equal, **quality.headline(name, section)}
    launches = dict(lib.launches)
    print("quality launches " + json.dumps(launches))
    _launches_check(launches, "quality", max(watch.cuts), list(watch.clips),
                    merged=bool(watch.merges))
    out["launches"] = launches
    out["wall_s"] = sum(x["wall_s"] for x in out["sections"].values())
    return out


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

    watch = Watch()
    report = {"card": smi, "build_s": build_s}
    report["kernels"] = kernel_phase(dev, smi)
    entry_rows, report["entry"] = entry_phase(dev, lib, smi)
    report["kernels"].update(entry_rows)

    t0 = time.perf_counter()
    truth, reads = _scale_dataset(args.reads)
    print(f"scale dataset: {len(reads)} reads simulated in {time.perf_counter() - t0:.1f} s "
          f"[{smi}]")
    report["kernels"].update(thread_phase(reads, dev, smi))
    row = batch_reduce_row(reads, dev, smi)
    report["kernels"]["reduce_sorted_batch"] = row
    report["kernels"]["reduce_sorted"]["max_abs_err"] = max(
        report["kernels"]["reduce_sorted"]["max_abs_err"], row["max_abs_err"])
    rows, report["correction"], corrected = correction_phase(reads, dev, smi, watch)
    report["kernels"].update(rows)
    # K20's row is the main path's cut mode; its error covers the flagship
    # table's keep and cut modes too
    report["kernels"]["abundance_cut"]["max_abs_err"] = max(
        report["kernels"][name]["max_abs_err"]
        for name in ("abundance_cut", "abundance_cut_keep", "abundance_cut_cut"))
    rows, report["condense"] = condense_phase(corrected, dev, smi, watch)
    report["kernels"].update(rows)
    del corrected
    sf = sf_phase(dev, smi)
    report["sf_rounds"] = sf.pop("sf_rounds")
    report["kernels"].update(sf)
    parity_phase(reads, PARITY_READS, dev, smi)
    t0 = time.perf_counter()
    p_truth, p_reads = _scale_dataset(args.reads, paired=True)
    print(f"paired scale dataset: {len(p_reads)} reads simulated in "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    paired_parity_phase(p_reads, dev, smi)

    report["scale"], single = single_scale_phase(truth, reads, dev, lib, watch, smi)
    row = main_lookup_row(watch, smi)
    report["kernels"]["lookup_sorted_main"] = row
    report["kernels"]["lookup_sorted"]["max_abs_err"] = max(
        report["kernels"]["lookup_sorted"]["max_abs_err"], row["max_abs_err"])
    report["sharded"], report["kernels"]["owner_buckets"] = sharded_phase(
        truth, reads, single, dev, lib, watch, smi)
    t0 = time.perf_counter()
    report["multihost"], rows = multihost_phase(reads, p_reads, single, dev, smi)
    report["multihost"]["wall_s"] = time.perf_counter() - t0
    report["kernels"].update(rows)
    print(f"multi-process phase: {report['multihost']['wall_s']:.1f} s [{smi}]")
    del reads, single
    report["paired_scale"] = paired_scale_phase(p_truth, p_reads, dev, lib, watch, smi)
    del p_reads
    report["quality"] = quality_phase(dev, lib, watch, smi)
    print(f"quality phase: {report['quality']['wall_s']:.1f} s [{smi}]")
    report["wall_s"] = time.perf_counter() - t_start
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)

    paths = {"launches_single_end": report["scale"]["launches"],
             "launches_paired": report["paired_scale"]["launches"],
             "launches_entry": report["entry"]["launches"],
             "launches_sharded": report["sharded"]["launches"],
             "launches_multihost": report["multihost"]["launches"],
             "launches_quality": report["quality"]["launches"]}
    rows = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(counts[name] for counts in paths.values()),
         **{path: counts[name] for path, counts in paths.items()},
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
