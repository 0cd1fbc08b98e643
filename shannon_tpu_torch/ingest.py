"""Paired-end ingest: interleave two mate files into one packed batch.

Host code, numpy only.  Files are parsed by ``shannon_tpu_torch.native.pack_file``
(the C++ parser, or its pure-Python route where no ``g++`` is found; that is
host parsing, not a device fallback: :func:`native_route` says which runs).
Every batch is interleaved [L0, R0, L1, R1, ...] with mate 2
reverse-complemented into transcript orientation (FR protocol), so counting
and threading see both mates on one strand.
"""

from __future__ import annotations

import numpy as np

from shannon_tpu_torch import native
from shannon_tpu_torch.io.dna import decode_seq, encode_seq, revcomp_code_rows
from shannon_tpu_torch.io.pack import ReadBatch


def native_route() -> str:
    """'native' when the C++ ingest library loads, else 'python'."""
    return "native" if native.load() is not None else "python"


# copied from shannon_tpu/pipeline.py:536 (host helper in a JAX-importing module)
def normalize_mate2(reads: list[str]) -> list[str]:
    """Flip interleaved mate-2 reads ([L0, R0, L1, R1, ...]) into
    transcript orientation (FR protocol: mate 2 is sequenced from the
    opposite strand).  Runs through the same code-space RC as the file
    route (io.dna.revcomp_code_rows), so the two routes cannot diverge."""
    mates = reads[1::2]
    if not mates:
        return list(reads)
    pad = max(len(s) for s in mates)
    codes = np.full((len(mates), max(pad, 1)), 4, dtype=np.uint8)
    lengths = np.zeros(len(mates), dtype=np.int32)
    for i, s in enumerate(mates):
        enc = encode_seq(s)
        codes[i, : len(enc)] = enc
        lengths[i] = len(enc)
    rc = revcomp_code_rows(codes, lengths)
    out = list(reads)
    for i, li in enumerate(lengths):
        out[2 * i + 1] = decode_seq(rc[i, :li])
    return out


# copied from shannon_tpu/pipeline.py:562 (host helper in a JAX-importing module)
def ingest_paired_files(left: str, right: str, pad_length: int = 0) -> ReadBatch:
    """Pack a paired library from two mate files into one interleaved
    batch with mate 2 flipped to transcript orientation.  Batch-identical
    to the in-memory route pack_reads(normalize_mate2(interleaved),
    paired=True) (tests/test_torch_paired.py)."""
    bl = native.pack_file(left, pad_length=pad_length)
    br = native.pack_file(right, pad_length=pad_length)
    if bl.n_reads != br.n_reads:
        raise ValueError(f"paired inputs differ in length: {bl.n_reads} vs {br.n_reads}")
    return _interleave_pair_batches(bl, br)


# copied from shannon_tpu/pipeline.py:616 (host helper in a JAX-importing module)
def _interleave_pair_batches(bl: ReadBatch, br: ReadBatch) -> ReadBatch:
    """[L0, R0, L1, R1, ...] with mate 2 reverse-complemented into
    transcript orientation.  Auto pads may differ between the two files
    (a 150 bp and a 151 bp library), so both widen to the common pad."""
    pad = max(bl.pad_length, br.pad_length)
    n = bl.n_reads
    codes = np.full((2 * n, pad), 4, np.uint8)
    lengths = np.empty(2 * n, np.int32)
    codes[0::2, : bl.pad_length] = bl.codes
    lengths[0::2] = bl.lengths
    codes[1::2, : br.pad_length] = revcomp_code_rows(br.codes, br.lengths)
    lengths[1::2] = br.lengths
    return ReadBatch(codes=codes, lengths=lengths, paired=True)
