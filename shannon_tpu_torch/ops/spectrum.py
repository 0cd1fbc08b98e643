"""Sorted-table lookup (kernel K3).

Counterpart of ``shannon_tpu/ops/spectrum.py:137 lookup_hilo``.  The TPU
switched between a sort-merge join and a binary search by a cost model of
that chip; here every lookup is one binary search per query.

Contract (as in the reference): ``idx`` is meaningful only where ``hit``.
"""

from __future__ import annotations

import torch

from shannon_tpu_torch import kernels


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
