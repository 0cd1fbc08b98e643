"""k-mer keys and windowed extraction from 2-bit packed reads or uint8 codes.

Counterpart of ``shannon_tpu/ops/kmers.py``.  A k-mer
is one ``int64`` key instead of the TPU's ``(hi, lo)`` uint32 pair: base i of
a window sits at bits ``[2(k-1-i), 2(k-1-i)+2)``, so the integer order of keys
is the lexicographic ``(hi, lo)`` order of the reference.  The device path
takes k <= 31: real keys stay below 2^62 and the pad key ``PAD = 2^63 - 1``
sorts after all of them (``shannon_tpu_torch.convert`` maps it to the
reference's all-ones SENTINEL pair).

Packed read words arrive as ``int32`` bit patterns (``np.uint32`` viewed as
``np.int32``); plain code widens them to int64 and masks with ``0xFFFFFFFF``
instead of using ``torch.uint32`` arithmetic.

``extract_kmers_packed`` is kernel K1 and ``extract_kmers`` (uint8 codes,
the sharded counter's and ``dryrun_multichip``'s input) kernel K24: on CUDA
tensors each launches its hand-written kernel in ``csrc/kernels.cu``; on CPU
tensors it runs its plain version.
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


def _windows_plain(codes, bad, lengths, k: int, canonical: bool):
    """Every window's key from [n, L] codes (only their low 2 bits count)
    and an optional [n, L] invalid-position mask: k shifted ORs
    (ops/kmers.py:78 _windows_from_c32)."""
    n, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"pad_length {L} < k {k}")
    key = torch.zeros((n, W), dtype=torch.int64, device=codes.device)
    valid = torch.ones((n, W), dtype=torch.bool, device=codes.device)
    for i in range(k):
        key = (key << 2) | (codes[:, i : i + W] & 3)
        if bad is not None:
            valid &= ~bad[:, i : i + W]
    col = torch.arange(W, device=codes.device)
    valid &= (col[None, :] + k) <= lengths[:, None].long()
    if canonical:
        key = canonical_key(key, k)
    return torch.where(valid, key, PAD), valid


def extract_kmers_packed_plain(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    canonical: bool = True,
    length: int | None = None,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: the windows of the unpacked code plane."""
    if length is None:
        length = 16 * words.shape[1]
    bad = None if mask is None else unpack_mask(mask, length)
    return _windows_plain(unpack_words(words, length), bad, lengths, k, canonical)


def extract_kmers_plain(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, canonical: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K24: a code >= 4 invalidates every window that touches
    it before the low 2 bits are read (ops/kmers.py:127-128)."""
    c = codes.long()
    return _windows_plain(c, c >= 4, lengths, k, canonical)


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


def _extract_codes_cuda(codes, lengths, k, canonical):
    kernels.check_cuda("codes", codes, torch.uint8, 2)
    kernels.check_cuda("lengths", lengths, torch.int32, 1)
    n, L = codes.shape
    if lengths.shape[0] != n:
        raise ValueError("codes and lengths disagree on the read count")
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"pad_length {L} < k {k}")
    keys = torch.empty((n, W), dtype=torch.int64, device=codes.device)
    valid = torch.empty((n, W), dtype=torch.bool, device=codes.device)
    lib = kernels.library()
    lib.call(
        "shannon_extract_codes", codes.device,
        kernels.ptr(codes), kernels.ptr(lengths), n, L, W, k, int(canonical),
        kernels.sm_count(codes.device), kernels.ptr(keys), kernels.ptr(valid),
    )
    lib.count("extract_codes")
    return keys, valid


def extract_kmers(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, canonical: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every window's k-mer key of [n, L] uint8 base codes (>= 4 invalid).
    Returns (key [n, W] int64, valid [n, W] bool), W = L - k + 1; windows
    past the read length or touching a code >= 4 hold PAD.  Kernel K24 on
    CUDA, the plain version on CPU (ops/kmers.py:116 extract_kmers)."""
    check_k(k)
    if codes.is_cuda:
        return _extract_codes_cuda(codes, lengths, k, canonical)
    return extract_kmers_plain(codes, lengths, k, canonical)
