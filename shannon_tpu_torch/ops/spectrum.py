"""Sorted-table lookups: exact hits (kernel K3), counts (K21), sibling
maxima (K22) and neighbor counts (K28).

Counterpart of ``shannon_tpu/ops/spectrum.py`` (``lookup_hilo``,
``lookup_counts``, ``sibling_maxes``, ``neighbor_counts``).  The TPU
switched between a sort-merge join and a binary search by a cost model of
that chip; here every lookup is one binary search per query.  On CUDA tensors each function
launches its hand-written kernel (``csrc/kernels.cu``, ``csrc/spectrum.cu``);
on CPU tensors its ``_plain`` version runs.

Contract (as in the reference): ``idx`` is meaningful only where ``hit``.
"""

from __future__ import annotations

import torch

from shannon_tpu_torch import kernels
from shannon_tpu_torch.ops.count import Spectrum
from shannon_tpu_torch.ops.kmers import PAD, canonical_key, check_k


def lookup_sorted_plain(
    table: torch.Tensor, query: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: lower bound by torch.searchsorted."""
    idx = torch.searchsorted(table, query.reshape(-1))
    idx = idx.clamp_(max=table.shape[0] - 1)
    hit = table[idx] == query.reshape(-1)
    return idx.reshape(query.shape), hit.reshape(query.shape)


def _lookup_sorted_cuda(table, query):
    kernels.check_cuda("table", table, torch.int64, 1)
    if query.device != table.device or query.dtype != torch.int64:
        raise ValueError("query must be int64 on the table's device")
    q = query.contiguous()
    idx = torch.empty(q.shape, dtype=torch.int64, device=q.device)
    hit = torch.empty(q.shape, dtype=torch.bool, device=q.device)
    lib = kernels.library()
    lib.call(
        "shannon_lookup_sorted", table.device,
        kernels.ptr(table), table.shape[0], kernels.ptr(q), q.numel(),
        kernels.ptr(idx), kernels.ptr(hit),
    )
    lib.count("lookup_sorted")
    return idx, hit


def lookup_sorted(
    table: torch.Tensor, query: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-hit lookup of int64 query keys (any shape) in a sorted int64
    table.  Returns (idx, hit) in the query's shape: idx is the lower
    bound clamped to len(table) - 1, valid where hit.  Kernel K3 on
    CUDA, the plain version on CPU."""
    if table.shape[0] == 0:
        raise ValueError("lookup in an empty table")
    if table.is_cuda:
        return _lookup_sorted_cuda(table, query)
    return lookup_sorted_plain(table, query)


def lookup_counts_plain(spec: Spectrum, query: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K21: K3's plain version and a gather."""
    if spec.capacity == 0:
        return torch.zeros(query.shape, dtype=torch.int32, device=query.device)
    idx, hit = lookup_sorted_plain(spec.key, query)
    return torch.where(hit, spec.count[idx], 0)


def _lookup_counts_cuda(spec: Spectrum, query: torch.Tensor) -> torch.Tensor:
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    kernels.check_cuda("count", spec.count, torch.int32, 1)
    if spec.count.shape[0] != spec.capacity:
        raise ValueError("key and count disagree on length")
    if query.device != spec.key.device or query.dtype != torch.int64:
        raise ValueError("query must be int64 on the table's device")
    q = query.contiguous()
    out = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    if spec.capacity == 0 or q.numel() == 0:
        return out
    lib = kernels.library()
    lib.call(
        "shannon_lookup_counts", spec.key.device,
        kernels.ptr(spec.key), kernels.ptr(spec.count), spec.capacity, kernels.ptr(q),
        q.numel(), kernels.ptr(out),
    )
    lib.count("lookup_counts")
    return out


def lookup_counts(spec: Spectrum, query: torch.Tensor) -> torch.Tensor:
    """int32 count of each int64 query key (any shape) in the sorted table,
    0 where absent (ops/spectrum.py:60 lookup_counts).  Queries must be in
    the table's orientation (canonical for a canonical spectrum).  Kernel
    K21 on CUDA, the plain version on CPU."""
    if spec.key.is_cuda:
        return _lookup_counts_cuda(spec, query)
    return lookup_counts_plain(spec, query)


def probe_keys(key: torch.Tensor, k: int, side: str, canonical: bool) -> torch.Tensor:
    """[8, C] probes per entry, rows (right, left) x base 0..3: siblings
    prefix.b / b.suffix for side='sib', extensions suffix.b / b.prefix
    for side='ext'."""
    mask = (1 << (2 * k)) - 1
    hs = 2 * (k - 1)
    rows = []
    for b in range(4):
        if side == "sib":
            rows.append((key & ~3) | b)
            rows.append((key & (mask >> 2)) | (b << hs))
        else:
            rows.append(((key << 2) | b) & mask)
            rows.append((key >> 2) | (b << hs))
    probes = torch.stack(rows)
    return canonical_key(probes, k) if canonical else probes


def sibling_maxes_plain(spec: Spectrum, k: int, canonical: bool = True):
    """Plain PyTorch K22: the [8, C] probe tensor, K21's plain version and
    a max over each side's rows."""
    counts = lookup_counts_plain(spec, probe_keys(spec.key, k, "sib", canonical))
    pad = spec.key == PAD
    return (
        torch.where(pad, 0, counts[0::2].amax(0)),
        torch.where(pad, 0, counts[1::2].amax(0)),
    )


def _sibling_maxes_cuda(spec: Spectrum, k: int, canonical: bool):
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    kernels.check_cuda("count", spec.count, torch.int32, 1)
    C = spec.capacity
    if spec.count.shape[0] != C:
        raise ValueError("key and count disagree on length")
    rmax = torch.empty(C, dtype=torch.int32, device=spec.key.device)
    lmax = torch.empty(C, dtype=torch.int32, device=spec.key.device)
    if C == 0:
        return rmax, lmax
    lib = kernels.library()
    lib.call(
        "shannon_sibling_maxes", spec.key.device,
        kernels.ptr(spec.key), kernels.ptr(spec.count), C, k, int(canonical),
        kernels.ptr(rmax), kernels.ptr(lmax),
    )
    lib.count("sibling_maxes")
    return rmax, lmax


def sibling_maxes(spec: Spectrum, k: int, canonical: bool = True):
    """(right_sib_max, left_sib_max), int32 [C]: the largest count among
    each entry's right siblings prefix.b and among its left siblings
    b.suffix, canonicalized when `canonical`; PAD lanes give 0
    (ops/spectrum.py:166 sibling_maxes).  Kernel K22 on CUDA, the plain
    version on CPU."""
    if spec.key.is_cuda:
        return _sibling_maxes_cuda(spec, k, canonical)
    return sibling_maxes_plain(spec, k, canonical)


def neighbor_counts_plain(spec: Spectrum, k: int, canonical: bool = True):
    """Plain PyTorch K28: the [8, C] extension and sibling probe tensors,
    K21's plain version on each, and a max over each side's sibling rows."""
    ext = lookup_counts_plain(spec, probe_keys(spec.key, k, "ext", canonical))
    sib = lookup_counts_plain(spec, probe_keys(spec.key, k, "sib", canonical))
    pad = spec.key == PAD
    return (
        torch.where(pad, 0, ext[0::2]),
        torch.where(pad, 0, ext[1::2]),
        torch.where(pad, 0, sib[0::2].amax(0)),
        torch.where(pad, 0, sib[1::2].amax(0)),
    )


def _neighbor_counts_cuda(spec: Spectrum, k: int, canonical: bool):
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    kernels.check_cuda("count", spec.count, torch.int32, 1)
    C = spec.capacity
    if spec.count.shape[0] != C:
        raise ValueError("key and count disagree on length")
    dev = spec.key.device
    rext = torch.empty((4, C), dtype=torch.int32, device=dev)
    lext = torch.empty((4, C), dtype=torch.int32, device=dev)
    rmax = torch.empty(C, dtype=torch.int32, device=dev)
    lmax = torch.empty(C, dtype=torch.int32, device=dev)
    if C == 0:
        return rext, lext, rmax, lmax
    lib = kernels.library()
    lib.call(
        "shannon_neighbor_counts", dev,
        kernels.ptr(spec.key), kernels.ptr(spec.count), C, k, int(canonical),
        *map(kernels.ptr, (rext, lext, rmax, lmax)),
    )
    lib.count("neighbor_counts")
    return rext, lext, rmax, lmax


def neighbor_counts(spec: Spectrum, k: int, canonical: bool = True):
    """(right_ext [4, C], left_ext [4, C], right_sib_max [C], left_sib_max
    [C]), int32, base axis first: the counts of each entry's right
    extensions suffix.b and left extensions b.prefix, and the largest count
    among its right siblings prefix.b and its left siblings b.suffix, all
    canonicalized when `canonical`; PAD lanes give 0
    (ops/spectrum.py:212 neighbor_counts).  Kernel K28 on CUDA, the plain
    version on CPU."""
    check_k(k)
    if spec.key.is_cuda:
        return _neighbor_counts_cuda(spec, k, canonical)
    return neighbor_counts_plain(spec, k, canonical)
