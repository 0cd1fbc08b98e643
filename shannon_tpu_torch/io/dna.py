# Copied from shannon_tpu/io/dna.py; equal to it apart from this line and the package name in imports.
"""DNA alphabet encoding shared by every layer.

Convention (fixed across oracle, host, and device code):
    A=0, C=1, G=2, T=3  (2 bits/base), anything else = BASE_INVALID (4).
Complement is ``3 - code``; reverse complement of a code array is
``3 - codes[::-1]``.  A k-mer's integer value reads the sequence
left-to-right as big-endian base-4 digits, so lexicographic order on
strings == numeric order on packed k-mers (used for canonicalization).
"""

from __future__ import annotations

import numpy as np

BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
BASE_INVALID = 4

_ENCODE_LUT = np.full(256, BASE_INVALID, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    _ENCODE_LUT[ord(_ch)] = _code
    _ENCODE_LUT[ord(_ch.lower())] = _code

_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """Sequence string -> uint8 code array (invalid chars -> BASE_INVALID)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENCODE_LUT[raw]


def decode_seq(codes: np.ndarray) -> str:
    """uint8 code array -> sequence string (BASE_INVALID -> 'N')."""
    codes = np.minimum(np.asarray(codes, dtype=np.uint8), BASE_INVALID)
    return _DECODE_LUT[codes].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space (invalid stays invalid)."""
    out = codes[::-1].copy()
    valid = out < 4
    out[valid] = 3 - out[valid]
    return out


def revcomp_str(seq: str) -> str:
    return decode_seq(revcomp_codes(encode_seq(seq)))


def revcomp_code_rows(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized ragged reverse-complement of a padded code matrix
    ([n, pad] uint8, rows valid to lengths[i], BASE_INVALID-padded):
    full-row reverse, then rotate each row left by (pad - length) so the
    reversed bases land back at the front.  Row-for-row identical to
    revcomp_codes on each valid prefix (tested) — the single
    implementation behind every mate-2 orientation normalization."""
    codes = np.asarray(codes, dtype=np.uint8)
    n, pad = codes.shape
    rev = codes[:, ::-1]
    cols = (
        np.arange(pad, dtype=np.int64)[None, :]
        + (pad - np.asarray(lengths, dtype=np.int64))[:, None]
    ) % pad
    rc = np.take_along_axis(rev, cols, axis=1)
    valid = rc < 4
    return np.where(valid, 3 - rc, BASE_INVALID).astype(np.uint8)


def canon_str(seq: str) -> str:
    """Canonical form of a sequence: min(seq, revcomp(seq)) lexicographic."""
    rc = revcomp_str(seq)
    return seq if seq <= rc else rc
