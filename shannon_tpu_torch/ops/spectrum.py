"""Sorted-table lookups: exact hits (kernel K3), counts (K21), sibling
maxima (K22) and neighbor counts (K28), and the layout of the 16-ary search
index that K3, K7, K21, K22 and K28 walk.

Counterpart of ``shannon_tpu/ops/spectrum.py`` (``lookup_hilo``,
``lookup_counts``, ``sibling_maxes``, ``neighbor_counts``).  The TPU
switched between a sort-merge join and a binary search by a cost model of
that chip; here every lookup is one search per query: K3, K21, K22 and K28
walk the index of ``csrc/search.cuh`` (built in the same call; K21's, K22's
and K28's over the real lanes alone, K22's and K28's with K7's probe-group
steps).  On CUDA tensors each function
launches its hand-written kernel (``csrc/kernels.cu``,
``csrc/spectrum.cu``); on CPU tensors its ``_plain`` version runs.

Contract: ``idx`` is the lower bound clamped to ``len(table) - 1`` on every
lane, a miss included (the reference promised ``idx`` only where ``hit``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from shannon_tpu_torch import kernels
from shannon_tpu_torch.ops.count import Spectrum
from shannon_tpu_torch.ops.kmers import PAD, canonical_key, check_k


# The 16-ary search index of K3, K7, K21, K22 and K28 (csrc/search.cuh, whose
# constants of the same names these must equal): SEARCH_FANOUT entries a
# node, levels up to the first of at most SEARCH_TOP_WORDS entries (the top,
# which each block holds in shared memory), at most SEARCH_MAX_LEVELS levels.
SEARCH_FANOUT = 16
SEARCH_MAX_LEVELS = 8
SEARCH_TOP_WORDS = 4096


class SearchLayout(NamedTuple):
    """The index of a table of n lanes.  Level 0 is the table; sizes[t]
    entries make level t + 1 and start at offsets[t] of the scratch, the
    top level (the last) at 0 and each level at a multiple of
    SEARCH_FANOUT entries; words in all."""

    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    words: int


def search_layout(n: int) -> SearchLayout:
    """Each level holds the last entry of every group of SEARCH_FANOUT
    entries of the level below; levels stop at the first of at most
    SEARCH_TOP_WORDS entries (no level at all for n <= SEARCH_FANOUT)."""
    if n < 1:
        raise ValueError("lookup in an empty table")
    if n >= 1 << 31:
        raise ValueError(f"{n} lanes: the search index takes tables below 2^31 lanes")
    sizes = []
    m = n
    while m > (SEARCH_TOP_WORDS if sizes else SEARCH_FANOUT):
        m = -(-m // SEARCH_FANOUT)
        sizes.append(m)
    offsets = [0] * len(sizes)
    words = 0
    for t in reversed(range(len(sizes))):
        offsets[t] = words
        words += -(-sizes[t] // SEARCH_FANOUT) * SEARCH_FANOUT
    return SearchLayout(tuple(sizes), tuple(offsets), words)


def search_index_plain(table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the index build (search_build_kernel): entry j
    of level t + 1 is table[min(16^(t+1) (j + 1), n) - 1], the last key of
    its subtree; the words that round a level up to whole nodes are PAD."""
    n = table.shape[0]
    layout = search_layout(n)
    index = torch.full((layout.words,), PAD, dtype=torch.int64, device=table.device)
    for t, (size, off) in enumerate(zip(layout.sizes, layout.offsets)):
        span = SEARCH_FANOUT ** (t + 1)
        last = torch.arange(1, size + 1, device=table.device) * span - 1
        index[off:off + size] = table[last.clamp_(max=n - 1)]
    return index


def search_args(n: int, device) -> tuple[torch.Tensor, ctypes.Array]:
    """What a search entry point (K3, K7, K21) takes beside its table: the
    index scratch, which the entry point fills, and the layout as the host
    words it checks (SEARCH_LAYOUT_WORDS: the number of levels, then the
    sizes and the offsets, each padded to SEARCH_MAX_LEVELS)."""
    lay = search_layout(n)
    return torch.empty(lay.words, dtype=torch.int64, device=device), layout_words(lay)


def layout_words(lay: SearchLayout) -> ctypes.Array:
    """The layout as the SEARCH_LAYOUT_WORDS host words an entry point checks."""
    pad = (0,) * (SEARCH_MAX_LEVELS - len(lay.sizes))
    return (ctypes.c_int64 * (1 + 2 * SEARCH_MAX_LEVELS))(
        len(lay.sizes), *lay.sizes, *pad, *lay.offsets, *pad
    )


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
    scratch, layout = search_args(table.shape[0], table.device)
    lib = kernels.library()
    lib.call(
        "shannon_lookup_sorted", table.device,
        kernels.ptr(table), table.shape[0], kernels.ptr(q), q.numel(),
        kernels.ptr(scratch), scratch.shape[0], layout, kernels.ptr(idx), kernels.ptr(hit),
    )
    lib.count("lookup_sorted")
    return idx, hit


def lookup_sorted(
    table: torch.Tensor, query: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-hit lookup of int64 query keys (any shape) in a sorted int64
    table.  Returns (idx, hit) in the query's shape: idx is the lower
    bound clamped to len(table) - 1, on a miss too.  Kernel K3 on CUDA
    (the index build and its walk), the plain version on CPU."""
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
    # the Spectrum contract: the real lanes come first, PAD with count 0
    # after them, so only key[:n_real] is searched
    n_real = min(spec.n, spec.capacity)
    if n_real == 0 or q.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    scratch, layout = search_args(n_real, spec.key.device)
    lib = kernels.library()
    lib.call(
        "shannon_lookup_counts", spec.key.device,
        kernels.ptr(spec.key), kernels.ptr(spec.count), n_real, kernels.ptr(q), q.numel(),
        kernels.ptr(scratch), scratch.shape[0], layout, kernels.sm_count(spec.key.device),
        kernels.ptr(out),
    )
    lib.count("lookup_counts")
    return out


def lookup_counts(spec: Spectrum, query: torch.Tensor) -> torch.Tensor:
    """int32 count of each int64 query key (any shape) in the sorted table,
    0 where absent (ops/spectrum.py:60 lookup_counts).  Queries must be in
    the table's orientation (canonical for a canonical spectrum).  Kernel
    K21 on CUDA (a walk of the search index of the real lanes
    key[:min(n, C)]), the plain version on CPU (over the whole table)."""
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


def _check_spectrum(spec: Spectrum) -> int:
    """The checks of K22's and K28's wrappers; returns C."""
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    kernels.check_cuda("count", spec.count, torch.int32, 1)
    if spec.count.shape[0] != spec.capacity:
        raise ValueError("key and count disagree on length")
    return spec.capacity


def _lane_walk_args(spec: Spectrum) -> tuple:
    """K22's and K28's arguments beside the table: the real lanes (the
    Spectrum contract: the real lanes come first, PAD with count 0 after
    them, so only key[:n_real] is searched and the kernel writes the lanes
    past it as zeros), the index scratch (none for a one-level top, which
    each block gathers from the table), its words and its layout words."""
    n_real = min(spec.n, spec.capacity)
    scratch, words, layout = None, 0, None
    if n_real:
        levels, words, layout = _sib_layout(n_real)
        if levels > 1:
            scratch = torch.empty(words, dtype=torch.int64, device=spec.key.device)
    return n_real, scratch, words, layout, kernels.sm_count(spec.key.device)


def _sibling_maxes_cuda(spec: Spectrum, k: int, canonical: bool, lanes: int | None = None):
    """K22: both maxima of the first `lanes` lanes (every lane by default;
    sibling_prune_round asks for the real lanes alone, past which the
    kernel then has nothing to fill)."""
    C = _check_spectrum(spec)
    lanes = C if lanes is None else lanes
    dev = spec.key.device
    rmax = torch.empty(lanes, dtype=torch.int32, device=dev)
    lmax = torch.empty(lanes, dtype=torch.int32, device=dev)
    if lanes == 0:
        return rmax, lmax
    n_real, scratch, words, layout, sms = _lane_walk_args(spec)
    lib = kernels.library()
    lib.call(
        "shannon_sibling_maxes", dev,
        kernels.ptr(spec.key), kernels.ptr(spec.count), n_real, lanes, k, int(canonical),
        kernels.ptr(scratch), words, layout, sms, kernels.ptr(rmax), kernels.ptr(lmax),
    )
    lib.count("sibling_maxes")
    return rmax, lmax


@functools.lru_cache(maxsize=64)
def _sib_layout(n: int) -> tuple[int, int, ctypes.Array]:
    """K22's and K28's index of n real lanes: its levels, its words and its
    layout's host words, made once for each n (the entry points read them
    and never write them)."""
    lay = search_layout(n)
    return len(lay.sizes), lay.words, layout_words(lay)


def sibling_maxes(spec: Spectrum, k: int, canonical: bool = True):
    """(right_sib_max, left_sib_max), int32 [C]: the largest count among
    each entry's right siblings prefix.b and among its left siblings
    b.suffix, canonicalized when `canonical`; PAD lanes give 0
    (ops/spectrum.py:166 sibling_maxes).  Kernel K22 on CUDA (the probes of
    the real lanes key[:min(n, C)], resolved on the search index of those
    lanes with K7's probe-group steps; zeros past them), the plain version
    on CPU (over the whole table)."""
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
    C = _check_spectrum(spec)
    dev = spec.key.device
    rext = torch.empty((4, C), dtype=torch.int32, device=dev)
    lext = torch.empty((4, C), dtype=torch.int32, device=dev)
    rmax = torch.empty(C, dtype=torch.int32, device=dev)
    lmax = torch.empty(C, dtype=torch.int32, device=dev)
    if C == 0:
        return rext, lext, rmax, lmax
    n_real, scratch, words, layout, sms = _lane_walk_args(spec)
    lib = kernels.library()
    lib.call(
        "shannon_neighbor_counts", dev,
        kernels.ptr(spec.key), kernels.ptr(spec.count), n_real, C, k, int(canonical),
        kernels.ptr(scratch), words, layout, sms, *map(kernels.ptr, (rext, lext, rmax, lmax)),
    )
    lib.count("neighbor_counts")
    return rext, lext, rmax, lmax


def neighbor_counts(spec: Spectrum, k: int, canonical: bool = True):
    """(right_ext [4, C], left_ext [4, C], right_sib_max [C], left_sib_max
    [C]), int32, base axis first: the counts of each entry's right
    extensions suffix.b and left extensions b.prefix, and the largest count
    among its right siblings prefix.b and its left siblings b.suffix, all
    canonicalized when `canonical`; PAD lanes give 0
    (ops/spectrum.py:212 neighbor_counts).  Kernel K28 on CUDA (the 16
    probes of the real lanes key[:min(n, C)], resolved on the search index
    of those lanes with K7's probe-group steps, as K22 resolves its 8;
    zeros past them), the plain version on CPU (over the whole table)."""
    check_k(k)
    if spec.key.is_cuda:
        return _neighbor_counts_cuda(spec, k, canonical)
    return neighbor_counts_plain(spec, k, canonical)
