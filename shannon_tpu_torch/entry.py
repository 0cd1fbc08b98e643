"""The flagship count-and-correct step on one GPU, and the sharded dry run.

Counterpart of ``__graft_entry__.py`` (``_example_batch``, ``entry``,
``dryrun_multichip``).  ``entry()`` gives the step and its arguments at the
reference's flagship shape: count the k-mers of one batch of 2-bit packed
reads (K1, ``torch.sort``, K2), slice the table to the correction capacity,
drop the k-mers below the abundance cut (K20's filter, one compaction) and
run one sibling-prune round (K22's sibling maxima of the real lanes, then
K23's decision and compaction in one pass), at 65,536 reads of 100 bp, k =
24, a 2^22-lane count table sliced to 2^21 lanes.  ``dryrun_multichip(n)`` runs one full sharded
step on an n-shard mesh (``parallel.mesh.make_mesh``) and holds each part
against the same work on one device.

    python -m shannon_tpu_torch.entry

runs the step once on the card and prints the number of k-mers it keeps,
then ``dryrun_multichip(8)``: 8 shards, on the one card where there is one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shannon_tpu_torch.config import AssemblyConfig
from shannon_tpu_torch.io.pack import ReadBatch, pack_reads
from shannon_tpu_torch.ops.condense import ContigArrays, build_contig_arrays
from shannon_tpu_torch.ops.correction import abundance_filter, sibling_prune_round
from shannon_tpu_torch.ops.count import (
    _slice_spectrum,
    count_spectrum,
    count_spectrum_packed,
    upload_words,
)
from shannon_tpu_torch.ops.thread import thread_reads_device
from shannon_tpu_torch.parallel.distributed import count_spectrum_sharded
from shannon_tpu_torch.parallel.mesh import make_mesh
from shannon_tpu_torch.pipeline import assemble
from shannon_tpu_torch.sim import random_seq, sample_reads, simulate_transcripts

K = 24
READ_LEN = 100
CAPACITY = 1 << 22
# The reference's static stand-in for pipeline.shrink_spectrum: correction
# runs on the sliced table, as the pipeline shrinks between counting and
# correction.
CORRECT_CAP = 1 << 21
N_READS = 1 << 16
MIN_ABUNDANCE = 1
SIBLING_RATIO = 0.1


def example_batch(n_reads: int, length: int, seed: int = 0) -> ReadBatch:
    """n_reads simulated reads of `length` bases (1% error) from four
    400-base transcripts, topped up with random reads, packed at pad
    `length` (``__graft_entry__._example_batch``, the same reads)."""
    rng = np.random.default_rng(seed)
    ts = simulate_transcripts(rng, n=4, length=400)
    reads = sample_reads(
        rng, ts, coverage=max(n_reads * length // (4 * 400), 2),
        read_length=length, error_rate=0.01,
    )[:n_reads]
    while len(reads) < n_reads:
        reads.append(random_seq(rng, length))
    return pack_reads(reads, pad_length=length)


def make_step(k: int, capacity: int, correct_cap: int, read_len: int):
    """step(words, lengths) -> (key, count, n) of the corrected table:
    count_spectrum_packed, the slice to correct_cap lanes,
    abundance_filter(MIN_ABUNDANCE), then sibling_prune_round(k,
    SIBLING_RATIO).  It runs wherever its arguments lie: the kernels on
    CUDA tensors, their plain versions on CPU tensors."""

    def step(words: torch.Tensor, lengths: torch.Tensor):
        spec = count_spectrum_packed(words, lengths, k=k, capacity=capacity, length=read_len)
        spec = _slice_spectrum(spec, correct_cap)
        spec = abundance_filter(spec, MIN_ABUNDANCE)
        spec = sibling_prune_round(spec, k, SIBLING_RATIO)
        return spec.key, spec.count, spec.n

    return step


def entry(device="cuda"):
    """(step, (words, lengths)) at the flagship shape: words [65,536, 7]
    int32 (the uint32 packed words' bit pattern) and lengths [65,536] int32
    on `device`.  A CUDA device without a card raises: there is no CPU
    fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but torch sees no CUDA device")
    batch = example_batch(N_READS, READ_LEN)
    args = (upload_words(batch.words, device), torch.from_numpy(batch.lengths).to(device))
    return make_step(K, CAPACITY, CORRECT_CAP, READ_LEN), args


def _contig_arrays_to(ca: ContigArrays, device) -> ContigArrays:
    return dataclasses.replace(ca, **{
        f.name: getattr(ca, f.name).to(device)
        for f in dataclasses.fields(ca) if isinstance(getattr(ca, f.name), torch.Tensor)
    })


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full sharded step on make_mesh(n_devices, device), held against
    the same work on one device (``__graft_entry__.py:74-166``): 256 reads
    a shard of example_batch, k = 24, 2^15 lanes.  The sharded count
    (K24, sort, K2, K25, the exchange) followed by abundance_filter(1) and
    sibling_prune_round(0.1) must equal count_spectrum (K24, sort, K2)
    followed by the same; threading each shard's reads on its own device
    must give the unsharded threading's events; assemble at n_devices =
    n must give the transcripts of n_devices = 1.  Returns the figures it
    prints."""
    mesh = make_mesh(n_devices, device)
    home = mesh[0]
    n_reads = 256 * n_devices
    batch = example_batch(n_reads, READ_LEN)
    codes = torch.from_numpy(batch.codes).to(home)
    lengths = torch.from_numpy(batch.lengths).to(home)
    dry_cap = 1 << 15

    spec, overflowed = count_spectrum_sharded(codes, lengths, K, dry_cap, mesh)
    spec = sibling_prune_round(abundance_filter(spec, MIN_ABUNDANCE), K, SIBLING_RATIO)
    if overflowed:
        raise AssertionError("sharded count overflowed in dryrun")
    if spec.n == 0:
        raise AssertionError("dryrun produced an empty spectrum")
    single = count_spectrum(codes, lengths, K, dry_cap)
    single = sibling_prune_round(abundance_filter(single, MIN_ABUNDANCE), K, SIBLING_RATIO)
    if spec.to_dict() != single.to_dict():
        raise AssertionError("sharded != single-device spectrum")

    # condensation on the gathered table, then data-parallel threading of
    # the same read shards, each on its own device
    ca = build_contig_arrays(spec, K, canonical=True)
    rows = n_reads // len(mesh)
    n_events = torch.cat([
        thread_reads_device(
            codes[i * rows : (i + 1) * rows].to(dev), lengths[i * rows : (i + 1) * rows].to(dev),
            _contig_arrays_to(ca, dev), K,
        )[2].to(home)
        for i, dev in enumerate(mesh)
    ])
    n_events_one = thread_reads_device(codes, lengths, ca, K)[2]
    if not torch.equal(n_events, n_events_one):
        raise AssertionError("sharded threading != single-device threading")
    if int(n_events.sum()) == 0:
        raise AssertionError("threading produced no events")

    # the whole pipeline with the sharded count against one device
    reads = batch.sequences()
    multi, one = (
        assemble(reads, AssemblyConfig(
            k=K, kmer_capacity=dry_cap, n_devices=n, min_transcript_length=30,
            min_output_abundance=0.0, batch_reads=max(16, n_reads),
        ), device=device)
        for n in (n_devices, 1)
    )
    if not multi.transcripts:
        raise AssertionError("full sharded step emitted nothing")
    if multi.canonical_set() != one.canonical_set():
        raise AssertionError("sharded full pipeline != single-device transcripts")
    figures = {"corrected_kmers": spec.n, "contigs": ca.n_contigs,
               "threading_events": int(n_events.sum()), "transcripts": len(multi.transcripts)}
    print(f"dryrun_multichip({n_devices}): ok — {figures['corrected_kmers']} corrected "
          f"k-mers, {figures['contigs']} contigs, {figures['threading_events']} threading "
          f"events, {figures['transcripts']} transcripts; sharded == single-device through "
          "MB+SF+enumeration")
    return figures


if __name__ == "__main__":
    fn, args = entry()
    _key, _count, n = fn(*args)
    print("entry(): ok —", n, "k-mers")
    dryrun_multichip(8)
