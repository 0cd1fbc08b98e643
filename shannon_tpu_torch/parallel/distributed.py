"""Sharded k-mer counting (counterpart of
``shannon_tpu/parallel/distributed.py``).

One process drives the mesh (a tuple of ``torch.device``s, ``mesh.py``).
The rows of a batch split into ``D = len(mesh)`` contiguous equal blocks,
block i on ``mesh[i]``.  Per shard (the reference's ``shard_map`` body):

  1. extract the shard's window keys (K24 from uint8 codes, K1 from packed
     words) and pre-count them: ``torch.sort``, then K2 into ``capacity``
     lanes.  A local table past ``capacity`` keeps its first ``capacity``
     keys, silently, as the reference's ``_unique_reduce`` does;
  2. bucket the local table by owner shard (K25, ``owner_buckets``: a hash
     of the key's (hi, lo) uint32 halves mod D) into ``[D, bucket_cap]``
     keys and counts, with an overflow flag.

Then the caller does what the reference's collectives did:

  3. all_to_all: owner j stacks row j of every shard's buckets on
     ``mesh[j]``;
  4. each owner sorts its ``D * bucket_cap`` lanes and sums equal keys (K2
     with counts): the exact counts of its hash slice;
  5. all_gather: the slices' first ``bucket_cap`` lanes meet on ``mesh[0]``,
     are sorted and cut to ``capacity`` lanes.

Each count returns ``(Spectrum, overflowed)``.  ``overflowed``: a bucket or
a slice outgrew ``bucket_cap``, or the gathered keys outgrow ``capacity``.
The Spectrum's n counts every gathered key (the port's convention; the
reference's n stops at the capacity, so the two agree on ``to_dict()``).
Which reads share a shard decides each bucket's fill, and so the flag: the
rows are split exactly as the reference splits them.
"""

from __future__ import annotations

import numpy as np
import torch

from shannon_tpu_torch import kernels
from shannon_tpu_torch.ops.count import (
    Spectrum,
    count_window_keys,
    empty_spectrum,
    merge_batch,
    reduce_sorted,
    upload_words,
)
from shannon_tpu_torch.ops.kmers import PAD, extract_kmers, extract_kmers_packed
from shannon_tpu_torch.parallel.mesh import Mesh

_M32 = 0xFFFFFFFF
# The most owners K25 bins in shared memory (MAX_OWNERS in csrc/distributed.cu).
MAX_OWNERS = 1024
# Lanes a tile of K25's passes (OB_TILE in csrc/distributed.cu; the entry
# point refuses a scratch sized for any other tile).
_OWNER_TILE = 2048


def default_bucket_cap(capacity: int, n_dev: int) -> int:
    """A balanced hash gives each owner about capacity / D lanes; twice that
    is the slack (parallel/distributed.py:61-63)."""
    return max(-(-capacity // n_dev) * 2, 8)


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for a in [0, 2^32), in 16-bit halves so no
    intermediate reaches 2^63."""
    a0, a1 = a & 0xFFFF, a >> 16
    m0, m1 = m & 0xFFFF, m >> 16
    return (a0 * m0 + (((a0 * m1 + a1 * m0) & 0xFFFF) << 16)) & _M32


def owner_of(key: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Owner shard of each int64 key (parallel/distributed.py:37 _hash_dev):
    h = lo * 2654435761 + hi * 0x9E3779B9 in uint32, h ^= h >> 16, h mod D,
    on the key's (hi, lo) 32-bit halves.  Returns int64."""
    hi = (key >> 32) & _M32
    lo = key & _M32
    h = (_mul32(lo, 2654435761) + _mul32(hi, 0x9E3779B9)) & _M32
    h ^= h >> 16
    return h % n_dev


def owner_buckets_plain(
    key: torch.Tensor, count: torch.Tensor, n_dev: int, bucket_cap: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K25, as the reference does it
    (parallel/distributed.py:133-160): a stable sort by owner (PAD lanes
    last, as owner D), each lane's place among its owner's lanes, and index
    writes of the places below bucket_cap."""
    C = key.shape[0]
    dev = torch.where(key == PAD, n_dev, owner_of(key, n_dev))
    dev, order = torch.sort(dev, stable=True)
    first = torch.searchsorted(dev, torch.arange(n_dev + 1, device=key.device))
    within = torch.arange(C, device=key.device) - first[dev]
    real = dev < n_dev
    overflow = (real & (within >= bucket_cap)).any()
    put = real & (within < bucket_cap)
    at = dev[put] * bucket_cap + within[put]
    out_key = torch.full((n_dev * bucket_cap,), PAD, dtype=torch.int64, device=key.device)
    out_count = torch.zeros(n_dev * bucket_cap, dtype=torch.int32, device=key.device)
    out_key[at] = key[order][put]
    out_count[at] = count[order][put]
    return out_key.view(n_dev, bucket_cap), out_count.view(n_dev, bucket_cap), overflow


def _owner_buckets_cuda(key, count, n_dev, bucket_cap, n_real):
    kernels.check_cuda("key", key, torch.int64, 1)
    kernels.check_cuda("count", count, torch.int32, 1)
    C = key.shape[0]
    if count.shape[0] != C:
        raise ValueError("key and count disagree on length")
    if C >= 1 << 31:
        raise ValueError(f"{C} lanes exceed the int32 bucket places")
    if not 1 <= n_dev <= MAX_OWNERS:
        raise ValueError(f"n_dev={n_dev} is outside 1..{MAX_OWNERS}")
    dev = key.device
    # the [D, tiles] counts (then starts), then D totals
    scratch = torch.empty(n_dev * -(-n_real // _OWNER_TILE) + n_dev, dtype=torch.int32,
                          device=dev)
    out_key = torch.empty((n_dev, bucket_cap), dtype=torch.int64, device=dev)
    out_count = torch.empty((n_dev, bucket_cap), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    lib = kernels.library()
    lib.call(
        "shannon_owner_buckets", dev,
        kernels.ptr(key), kernels.ptr(count), n_real, n_dev, bucket_cap,
        kernels.ptr(scratch), scratch.shape[0], kernels.ptr(out_key), kernels.ptr(out_count),
        kernels.ptr(overflow),
    )
    lib.count("owner_buckets")
    return out_key, out_count, overflow


def owner_buckets(
    key: torch.Tensor, count: torch.Tensor, n_dev: int, bucket_cap: int, n_real: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partition a sorted table (PAD last) by owner shard, keeping key order
    inside each owner: (bucket keys [D, bucket_cap] int64, PAD past each
    bucket's lanes; bucket counts [D, bucket_cap] int32, 0 there; overflow,
    a 0-d bool tensor, true where an owner has more than bucket_cap real
    lanes, whose lanes past bucket_cap are dropped).  n_real: the table's
    real lanes, min(n, C) under the Spectrum contract (ops/count.py), which
    kernel K25 reads alone on CUDA; the plain version on CPU reads the whole
    table, as the reference does."""
    if bucket_cap < 1:
        raise ValueError(f"bucket_cap={bucket_cap} must be >= 1")
    if not 0 <= n_real <= key.shape[0]:
        raise ValueError(f"n_real={n_real} is outside 0..{key.shape[0]}")
    if key.is_cuda:
        return _owner_buckets_cuda(key, count, n_dev, bucket_cap, n_real)
    return owner_buckets_plain(key, count, n_dev, bucket_cap)


def sharded_tail(key: torch.Tensor, n_dev: int, capacity: int, bucket_cap: int):
    """One shard's half of _sharded_tail (parallel/distributed.py:126-160):
    the local pre-count of its window keys, then its owner buckets."""
    local = count_window_keys(key, capacity)
    return owner_buckets(local.key, local.count, n_dev, bucket_cap,
                         min(local.n, local.capacity))


def owner_slice(keys: torch.Tensor, counts: torch.Tensor, bucket_cap: int):
    """One owner's merge (parallel/distributed.py:162-180): its received
    bucket lanes (every shard's row for it) sorted, equal keys summed by K2.
    Returns (the first bucket_cap keys, their counts, n: the owner's distinct
    keys, which may exceed bucket_cap)."""
    keys, order = torch.sort(keys)
    key, count, _, n = reduce_sorted(keys, counts[order], keys.shape[0])
    return key[:bucket_cap], count[:bucket_cap], n


def gathered_spectrum(keys: torch.Tensor, counts: torch.Tensor, n_real: int,
                      capacity: int) -> Spectrum:
    """The gather's table (parallel/distributed.py:182-194): the owners'
    slices, concatenated, sorted and cut to capacity.  The slices are
    disjoint, so the sort needs no reduction."""
    key, order = torch.sort(keys)
    return Spectrum(key=key[:capacity], count=counts[order][:capacity], n=n_real)


def _gather(buckets: list, mesh: Mesh, capacity: int, bucket_cap: int) -> tuple[Spectrum, bool]:
    """The exchange, each owner's merge and the gather
    (parallel/distributed.py:162-194) over every shard's buckets."""
    home = mesh[0]
    slices, n_real, overflowed = [], 0, False
    for j, dev in enumerate(mesh):
        keys = torch.cat([bk[j].to(dev, non_blocking=True) for bk, _, _ in buckets])
        counts = torch.cat([bc[j].to(dev, non_blocking=True) for _, bc, _ in buckets])
        key, count, n = owner_slice(keys, counts, bucket_cap)
        overflowed |= n > bucket_cap
        n_real += min(n, bucket_cap)
        slices.append((key.to(home), count.to(home)))
    flags = torch.stack([flag.to(home) for _, _, flag in buckets])
    overflowed = overflowed or n_real > capacity or bool(flags.any())
    spec = gathered_spectrum(torch.cat([k for k, _ in slices]), torch.cat([c for _, c in slices]),
                             n_real, capacity)
    return spec, overflowed


def _shard_rows(tensors: tuple, mesh: Mesh) -> list[list[torch.Tensor]]:
    """Contiguous equal row blocks, block i moved to mesh[i]."""
    n, n_dev = tensors[0].shape[0], len(mesh)
    if n % n_dev:
        raise ValueError(
            f"a batch of shape {tuple(tensors[0].shape)} does not split into {n_dev} equal "
            "row shards"
        )
    m = n // n_dev
    return [[t[i * m : (i + 1) * m].to(dev, non_blocking=True) for t in tensors]
            for i, dev in enumerate(mesh)]


def count_spectrum_sharded(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    capacity: int,
    mesh: Mesh,
    canonical: bool = True,
    bucket_cap: int | None = None,
) -> tuple[Spectrum, bool]:
    """Global spectrum of [N, L] uint8 codes (N divisible by D) on mesh[0],
    and the overflow flag (parallel/distributed.py:44
    count_spectrum_sharded).  `capacity` is each shard's local table and
    the gathered table's capacity, as on one device."""
    n_dev = len(mesh)
    if bucket_cap is None:
        bucket_cap = default_bucket_cap(capacity, n_dev)
    buckets = [
        sharded_tail(extract_kmers(c, n, k, canonical)[0], n_dev, capacity, bucket_cap)
        for c, n in _shard_rows((codes, lengths), mesh)
    ]
    return _gather(buckets, mesh, capacity, bucket_cap)


def count_spectrum_sharded_packed(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    capacity: int,
    mesh: Mesh,
    canonical: bool = True,
    bucket_cap: int | None = None,
    length: int | None = None,
    mask: torch.Tensor | None = None,
) -> tuple[Spectrum, bool]:
    """count_spectrum_sharded over the 2-bit transfer format
    (parallel/distributed.py:80 count_spectrum_sharded_packed); `mask`
    (mid-read invalid positions) is sharded with the rows."""
    n_dev = len(mesh)
    if bucket_cap is None:
        bucket_cap = default_bucket_cap(capacity, n_dev)
    rows = (words, lengths) if mask is None else (words, lengths, mask)
    buckets = []
    for w, n, *m in _shard_rows(rows, mesh):
        keys, _ = extract_kmers_packed(w, n, k, canonical, length, m[0] if m else None)
        buckets.append(sharded_tail(keys, n_dev, capacity, bucket_cap))
    return _gather(buckets, mesh, capacity, bucket_cap)


def count_reads_spectrum_sharded(
    batch,
    k: int = 24,
    capacity: int = 1 << 22,
    mesh: Mesh | None = None,
    canonical: bool = True,
    batch_reads: int = 1 << 16,
) -> tuple[Spectrum, bool]:
    """Stream a packed-resident ReadBatch through
    count_spectrum_sharded_packed, merging batch to batch on mesh[0] as
    ops.count.count_reads_spectrum does (parallel/distributed.py:196
    count_reads_spectrum_sharded).  A short last batch is padded, as the
    reference pads it, to min(max(2^ceil(log2 rows), 2 D), batch_reads) rows
    of length 0.  Returns (spectrum, overflowed)."""
    n_dev = len(mesh)
    total: Spectrum | None = None
    overflowed = False
    for s in range(0, batch.n_reads, batch_reads):
        e = min(s + batch_reads, batch.n_reads)
        words, lengths, mask = batch.words[s:e], batch.lengths[s:e], batch.mask_rows(s, e)
        rows = e - s
        if rows != batch_reads:
            tgt = min(max(1 << max(rows - 1, 1).bit_length(), 2 * n_dev), batch_reads)
            if tgt > rows:
                words = np.pad(words, ((0, tgt - rows), (0, 0)))
                lengths = np.pad(lengths, (0, tgt - rows))
                if mask is not None:
                    mask = np.pad(mask, ((0, tgt - rows), (0, 0)))
        part, ovf = count_spectrum_sharded_packed(
            upload_words(words, "cpu"), torch.from_numpy(lengths), k, capacity, mesh, canonical,
            length=batch.pad_length, mask=None if mask is None else upload_words(mask, "cpu"),
        )
        overflowed |= ovf
        total = merge_batch(total, part)
    return (total if total is not None else empty_spectrum(capacity, mesh[0])), overflowed
