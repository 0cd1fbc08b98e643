"""k-mer keys and windowed extraction from 2-bit packed reads.

Counterpart of ``shannon_tpu/ops/kmers.py`` (packed format only).  A k-mer
is one ``int64`` key instead of the TPU's ``(hi, lo)`` uint32 pair: base i of
a window sits at bits ``[2(k-1-i), 2(k-1-i)+2)``, so the integer order of keys
is the lexicographic ``(hi, lo)`` order of the reference.  The device path
takes k <= 31: real keys stay below 2^62 and the pad key ``PAD = 2^63 - 1``
sorts after all of them (``shannon_tpu_torch.convert`` maps it to the
reference's all-ones SENTINEL pair).

Packed read words arrive as ``int32`` bit patterns (``np.uint32`` viewed as
``np.int32``); plain code widens them to int64 and masks with ``0xFFFFFFFF``
instead of using ``torch.uint32`` arithmetic.

``extract_kmers_packed`` is kernel K1: on CUDA tensors it launches the
hand-written kernel in ``csrc/kernels.cu``; on CPU tensors it runs
``extract_kmers_packed_plain``.
"""

from __future__ import annotations

import torch

from shannon_tpu_torch import kernels

PAD = (1 << 63) - 1
MAX_K = 31
_M32 = 0xFFFFFFFF


def check_k(k: int) -> None:
    """The device path carries a k-mer in one int64 below 2^62."""
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"k={k} is outside the device path's range 1..{MAX_K} (the pad "
            "key must be unreachable by a real k-mer)"
        )


def _rev2_32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups of each value in [0, 2^32)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & _M32


def revcomp_key(key: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2k-bit keys (ops/kmers.py:49 revcomp_hilo).
    Works on 32-bit halves so no intermediate reaches the sign bit."""
    c = (~key) & ((1 << (2 * k)) - 1)
    r_hi = _rev2_32(c & _M32)  # the 64-bit group reversal swaps the halves
    r_lo = _rev2_32(c >> 32)
    s = 64 - 2 * k
    if s < 32:
        return (r_hi << (32 - s)) | (r_lo >> s)
    return r_hi >> (s - 32)


def canonical_key(key: torch.Tensor, k: int) -> torch.Tensor:
    """min(v, rc(v)) (ops/kmers.py:69 canonical_hilo)."""
    return torch.minimum(key, revcomp_key(key, k))


def unpack_words(words: torch.Tensor, length: int) -> torch.Tensor:
    """[n, ceil(L/16)] int32 packed words -> [n, L] int64 codes 0..3
    (ops/kmers.py:131 unpack_words_device)."""
    n, ww = words.shape
    shifts = 2 * torch.arange(16, device=words.device)
    c = ((words.long() & _M32)[:, :, None] >> shifts) & 3
    return c.reshape(n, ww * 16)[:, :length]


def unpack_mask(mask: torch.Tensor, length: int) -> torch.Tensor:
    """[n, ceil(L/32)] int32 bit mask -> [n, L] bool
    (ops/kmers.py:142 unpack_mask_device)."""
    n, wm = mask.shape
    shifts = torch.arange(32, device=mask.device)
    b = ((mask.long() & _M32)[:, :, None] >> shifts) & 1
    return b.reshape(n, wm * 32)[:, :length].bool()


def extract_kmers_packed_plain(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    canonical: bool = True,
    length: int | None = None,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: k shifted ORs over the unpacked code plane
    (ops/kmers.py:78 _windows_from_c32)."""
    if length is None:
        length = 16 * words.shape[1]
    codes = unpack_words(words, length)
    n, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"pad_length {L} < k {k}")
    bad = None if mask is None else unpack_mask(mask, length)
    key = torch.zeros((n, W), dtype=torch.int64, device=words.device)
    valid = torch.ones((n, W), dtype=torch.bool, device=words.device)
    for i in range(k):
        key = (key << 2) | codes[:, i : i + W]
        if bad is not None:
            valid &= ~bad[:, i : i + W]
    col = torch.arange(W, device=words.device)
    valid &= (col[None, :] + k) <= lengths[:, None].long()
    if canonical:
        key = canonical_key(key, k)
    return torch.where(valid, key, PAD), valid


def _extract_kmers_cuda(words, lengths, k, canonical, length, mask):
    kernels.check_cuda("words", words, torch.int32, 2)
    kernels.check_cuda("lengths", lengths, torch.int32, 1)
    n, ww = words.shape
    if lengths.shape[0] != n:
        raise ValueError("words and lengths disagree on the read count")
    if length > 16 * ww:
        raise ValueError(f"length {length} exceeds the {16 * ww} packed bases")
    wm = 0
    if mask is not None:
        kernels.check_cuda("mask", mask, torch.int32, 2)
        wm = mask.shape[1]
        if mask.shape[0] != n or 32 * wm < length:
            raise ValueError(f"mask shape {tuple(mask.shape)} does not cover the reads")
    W = length - k + 1
    if W <= 0:
        raise ValueError(f"pad_length {length} < k {k}")
    keys = torch.empty((n, W), dtype=torch.int64, device=words.device)
    valid = torch.empty((n, W), dtype=torch.bool, device=words.device)
    lib = kernels.library()
    lib.call(
        "shannon_extract_kmers", words.device,
        kernels.ptr(words), kernels.ptr(lengths), kernels.ptr(mask),
        n, ww, wm, W, k, int(canonical), kernels.ptr(keys), kernels.ptr(valid),
    )
    lib.count("extract_kmers")
    return keys, valid


def extract_kmers_packed(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    canonical: bool = True,
    length: int | None = None,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every window's k-mer key over the 2-bit transfer format
    (io.pack.pack_words).  Returns (key [n, W] int64, valid [n, W] bool),
    W = length - k + 1.  Invalid windows (past the read length, or
    touching a position set in `mask`) hold PAD.  Kernel K1 on CUDA,
    the plain version on CPU (ops/kmers.py:151 extract_kmers_packed)."""
    check_k(k)
    if length is None:
        length = 16 * words.shape[1]
    if words.is_cuda:
        return _extract_kmers_cuda(words, lengths, k, canonical, length, mask)
    return extract_kmers_packed_plain(words, lengths, k, canonical, length, mask)
