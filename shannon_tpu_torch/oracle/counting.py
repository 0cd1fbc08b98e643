# Copied from shannon_tpu/oracle/counting.py; equal to it apart from this line and the package name in imports.
"""Oracle k-mer counting — the semantics Jellyfish provides the reference
(SURVEY.md §2 L0, §3.2): exact (k-mer -> count) table over all reads.

Spec (binding for the TPU pipeline):
  * a k-mer is any window of k consecutive *valid* bases (A/C/G/T) in a
    read; windows containing N or crossing the read end produce nothing;
  * the packed value of a k-mer reads bases left->right as big-endian
    base-4 digits (A=0 < C=1 < G=2 < T=3), so numeric order == string
    lexicographic order;
  * unless strand-specific, the *canonical* k-mer is counted:
    min(value(seq), value(revcomp(seq)));
  * the count of a canonical k-mer is the total number of windows (over
    all reads, both orientations collapsed) whose canonical form is it.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from shannon_tpu_torch.io.dna import decode_seq, encode_seq


def str_to_kmer(s: str) -> int:
    """Pack a k-length string into its integer value."""
    codes = encode_seq(s)
    if (codes >= 4).any():
        raise ValueError(f"invalid base in k-mer {s!r}")
    v = 0
    for c in codes:
        v = (v << 2) | int(c)
    return v


def kmer_to_str(v: int, k: int) -> str:
    codes = np.array([(v >> (2 * (k - 1 - i))) & 3 for i in range(k)], dtype=np.uint8)
    return decode_seq(codes)


def revcomp_kmer(v: int, k: int) -> int:
    """Reverse complement in packed space."""
    r = 0
    for _ in range(k):
        r = (r << 2) | (3 - (v & 3))
        v >>= 2
    return r


def canon_kmer(v: int, k: int) -> int:
    return min(v, revcomp_kmer(v, k))


def _seq_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """All valid k-mer values of one code array (vectorized helper; the
    per-window semantics above).  Returns int64 array (k <= 32 fits for
    k <= 31; we keep k <= 32 by using uint64 arithmetic)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    c = codes.astype(np.uint64)
    vals = np.zeros(n, dtype=np.uint64)
    valid = np.ones(n, dtype=bool)
    for i in range(k):
        window = c[i : i + n]
        vals = (vals << np.uint64(2)) | (window & np.uint64(3))
        valid &= window < 4
    return vals[valid]


def _seq_kmers_canonical(codes: np.ndarray, k: int) -> np.ndarray:
    fwd = _seq_kmers(codes, k)
    if len(fwd) == 0:
        return fwd
    # revcomp of each value, vectorized 2-bit reversal
    v = fwd.copy()
    r = np.zeros_like(v)
    for _ in range(k):
        r = (r << np.uint64(2)) | ((~v) & np.uint64(3))
        v >>= np.uint64(2)
    return np.minimum(fwd, r)


def count_kmers(
    seqs: Iterable[str] | Iterable[np.ndarray],
    k: int,
    strand_specific: bool = False,
) -> dict[int, int]:
    """Exact (k-mer value -> count) over sequences (strings or code arrays)."""
    counts: dict[int, int] = {}
    for s in seqs:
        codes = encode_seq(s) if isinstance(s, str) else np.asarray(s)
        vals = (
            _seq_kmers(codes, k)
            if strand_specific
            else _seq_kmers_canonical(codes, k)
        )
        for v in vals.tolist():
            counts[v] = counts.get(v, 0) + 1
    return counts


def count_kmers_pure_python(
    seqs: Iterable[str], k: int, strand_specific: bool = False
) -> dict[int, int]:
    """Fully scalar Python counter — the honest stand-in for the reference's
    Python-side per-k-mer loops when benchmarking (BASELINE.md measurement
    plan).  Semantics identical to count_kmers."""
    counts: dict[int, int] = {}
    mask = (1 << (2 * k)) - 1
    code_of = {"A": 0, "C": 1, "G": 2, "T": 3, "a": 0, "c": 1, "g": 2, "t": 3}
    for s in seqs:
        v = 0
        run = 0  # consecutive valid bases ending here
        r = 0  # running revcomp value
        for ch in s:
            c = code_of.get(ch, -1)
            if c < 0:
                run = 0
                v = 0
                r = 0
                continue
            v = ((v << 2) | c) & mask
            r = (r >> 2) | ((3 - c) << (2 * (k - 1)))
            run += 1
            if run >= k:
                key = v if strand_specific else min(v, r)
                counts[key] = counts.get(key, 0) + 1
    return counts


def spectrum_arrays(counts: dict[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """Sorted (kmers, counts) arrays from a count dict — the canonical
    comparison form for parity tests against the device spectrum."""
    if not counts:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int64)
    kmers = np.fromiter(counts.keys(), dtype=np.uint64, count=len(counts))
    cnts = np.fromiter(counts.values(), dtype=np.int64, count=len(counts))
    order = np.argsort(kmers, kind="stable")
    return kmers[order], cnts[order]
