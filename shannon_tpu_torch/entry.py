"""The flagship count-and-correct step, on one GPU.

Counterpart of ``__graft_entry__.py:18-71`` (``_example_batch``,
``entry``): count the k-mers of one batch of 2-bit packed reads (K1,
``torch.sort``, K2), slice the table to the correction capacity, drop the
k-mers below the abundance cut (K20's keep flags, ``torch.cumsum``, K10) and
run one sibling-prune round (K22's sibling maxima, K23's keep flags,
``torch.cumsum``, K10).  ``entry()`` gives the step and its arguments at the
reference's flagship shape: 65,536 reads of 100 bp, k = 24, a 2^22-lane
count table sliced to 2^21 lanes.

    python -m shannon_tpu_torch.entry

runs the step once on the card and prints the number of k-mers it keeps.
"""

from __future__ import annotations

import numpy as np
import torch

from shannon_tpu_torch.io.pack import ReadBatch, pack_reads
from shannon_tpu_torch.ops.correction import abundance_filter, sibling_prune_round
from shannon_tpu_torch.ops.count import _slice_spectrum, count_spectrum_packed, upload_words
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


if __name__ == "__main__":
    fn, args = entry()
    _key, _count, n = fn(*args)
    print("entry(): ok —", n, "k-mers")
