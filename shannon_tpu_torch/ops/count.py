"""k-mer counting: sort + run reduction into a capacity-padded spectrum.

Counterpart of ``shannon_tpu/ops/count.py``.  Per batch: extract window keys
(K1 from packed words, K24 from uint8 codes), ``torch.sort`` them, and
reduce runs of equal keys into a sorted table of unique keys and counts
(kernel K2, ``reduce_sorted``).  Batches
merge in one pass (kernel K17, ``merge_at``: a merge path over the real
lanes of both tables that sums the counts of equal keys as it goes).  The
table stays sorted and PAD-filled past ``n`` so it is ready for binary
search (K3).

Overflow contract: a table never drops a key silently.  A batch with more
distinct k-mers than ``capacity`` raises; a merge that does not fit the
fixed capacity is redone at a grown, tight capacity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shannon_tpu_torch import kernels
from shannon_tpu_torch.ops.kmers import PAD, extract_kmers, extract_kmers_packed


@dataclass
class Spectrum:
    """Sorted unique-k-mer table (ops/count.py:29 Spectrum): int64 keys
    and int32 counts of static capacity, PAD / 0 past `n` entries."""

    key: torch.Tensor  # [C] int64
    count: torch.Tensor  # [C] int32
    n: int  # number of real entries (may exceed C when overflowed)

    @property
    def capacity(self) -> int:
        return int(self.key.shape[0])

    @property
    def device(self) -> torch.device:
        return self.key.device

    def overflowed(self) -> bool:
        """True when the capacity was too small (last lane not padding)."""
        return self.n >= self.capacity

    def to_dict(self) -> dict[int, int]:
        n = min(self.n, self.capacity)
        keys = self.key[:n].cpu().tolist()
        return dict(zip(keys, self.count[:n].cpu().tolist()))


def empty_spectrum(capacity: int, device) -> Spectrum:
    return Spectrum(
        key=torch.full((capacity,), PAD, dtype=torch.int64, device=device),
        count=torch.zeros(capacity, dtype=torch.int32, device=device),
        n=0,
    )


def reduce_sorted_plain(
    keys: torch.Tensor, counts: torch.Tensor | None, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Plain PyTorch K2 (ops/count.py:158 _unique_reduce_unit and :110
    _unique_reduce)."""
    m = keys.shape[0]
    dev = keys.device
    real = keys != PAD
    is_start = real.clone()
    is_start[1:] &= keys[1:] != keys[:-1]
    starts = torch.nonzero(is_start).flatten()
    n = int(starts.shape[0])
    n_real = int(real.sum())  # pads sort last
    ends = torch.cat([starts[1:], torch.tensor([n_real], device=dev)])
    if counts is None:
        run_count = ends - starts
    else:
        prefix = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        prefix[1:] = torch.cumsum(counts.long(), 0)
        run_count = prefix[ends] - prefix[starts]
    c = min(n, capacity)
    out_key = torch.full((capacity,), PAD, dtype=torch.int64, device=dev)
    out_key[:c] = keys[starts[:c]]
    out_count = torch.zeros(capacity, dtype=torch.int32, device=dev)
    out_count[:c] = run_count[:c].int()
    start = torch.zeros(capacity, dtype=torch.int64, device=dev)
    start[:c] = starts[:c]
    return out_key, out_count, start, n


def _reduce_sorted_cuda(keys, counts, capacity):
    kernels.check_cuda("keys", keys, torch.int64, 1)
    m = keys.shape[0]
    if m >= 1 << 31:
        raise ValueError(f"{m} keys exceed the 2^31 that K2 takes (the reference's int32 n)")
    dev = keys.device
    if counts is not None:
        kernels.check_cuda("counts", counts, torch.int32, 1)
        if counts.shape[0] != m:
            raise ValueError("keys and counts disagree on length")
    out_key = torch.empty(capacity, dtype=torch.int64, device=dev)
    out_count = torch.zeros(capacity, dtype=torch.int32, device=dev)
    start = torch.empty(capacity, dtype=torch.int64, device=dev)
    scratch = kernels.scan_scratch(m, dev)
    lib = kernels.library()
    lib.call(
        "shannon_reduce_sorted", dev,
        kernels.ptr(keys), kernels.ptr(counts), m, capacity, kernels.ptr(scratch),
        scratch.shape[0], kernels.ptr(out_key), kernels.ptr(out_count), kernels.ptr(start),
    )
    lib.count("reduce_sorted")
    return out_key, out_count, start, kernels.scan_total(scratch)


def reduce_sorted(
    keys: torch.Tensor, counts: torch.Tensor | None, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Run reduction of sorted keys (PAD last) into a capacity-padded
    table.  counts=None counts each real lane once; otherwise a run's
    count is the sum of its lanes' int32 counts.  Returns (key [C] int64,
    count [C] int32, start [C] int64 = first lane of each run, valid in
    [:n], n = number of distinct keys).  Kernel K2 on CUDA, the plain
    version on CPU."""
    if keys.is_cuda:
        return _reduce_sorted_cuda(keys, counts, capacity)
    return reduce_sorted_plain(keys, counts, capacity)


def unique_first_sorted(
    keys: torch.Tensor, payloads: tuple[torch.Tensor, ...], capacity: int
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...], int]:
    """Dedupe sorted keys keeping each run's first payload
    (ops/count.py:69 unique_first_sorted), through K2's run starts."""
    key, _, start, n = reduce_sorted(keys, None, capacity)
    c = min(n, capacity)
    out = []
    for p in payloads:
        o = torch.zeros(capacity, dtype=p.dtype, device=p.device)
        o[:c] = p[start[:c]]
        out.append(o)
    return key, tuple(out), n


def count_window_keys(keys: torch.Tensor, capacity: int) -> Spectrum:
    """Count window keys (PAD where invalid) into a sorted Spectrum:
    torch.sort, then K2 with unit counts (ops/count.py:196
    _spectrum_from_windows).  Past `capacity` distinct keys the table keeps
    the first `capacity` and n counts them all."""
    keys = torch.sort(keys.reshape(-1)).values
    key, count, _, n = reduce_sorted(keys, None, capacity)
    return Spectrum(key=key, count=count, n=n)


def count_spectrum(
    codes: torch.Tensor, lengths: torch.Tensor, k: int, capacity: int, canonical: bool = True
) -> Spectrum:
    """Count every k-mer of one batch of [n, L] uint8 codes into a sorted
    Spectrum (ops/count.py:215 count_spectrum): K24, sort, K2."""
    return count_window_keys(extract_kmers(codes, lengths, k, canonical)[0], capacity)


def count_spectrum_packed(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    capacity: int,
    canonical: bool = True,
    length: int | None = None,
    mask: torch.Tensor | None = None,
) -> Spectrum:
    """Count every k-mer of one packed read batch into a sorted Spectrum
    (ops/count.py:227 count_spectrum_packed): K1, sort, K2."""
    keys, _ = extract_kmers_packed(words, lengths, k, canonical, length, mask)
    return count_window_keys(keys, capacity)


def merge_at_plain(a: Spectrum, b: Spectrum, capacity: int) -> Spectrum:
    """Plain PyTorch K17: torch.sort of the concatenation, then K2's plain
    version.  Equal keys sum their counts, so the sort needs no
    stability."""
    keys, order = torch.sort(torch.cat([a.key, b.key]))
    counts = torch.cat([a.count, b.count])[order]
    key, count, _, n = reduce_sorted_plain(keys, counts, capacity)
    return Spectrum(key=key, count=count, n=n)


def _merge_at_cuda(a: Spectrum, b: Spectrum, capacity: int) -> Spectrum:
    for name, spec in (("a", a), ("b", b)):
        kernels.check_cuda(f"{name}.key", spec.key, torch.int64, 1)
        kernels.check_cuda(f"{name}.count", spec.count, torch.int32, 1)
        if spec.count.shape[0] != spec.capacity:
            raise ValueError(f"{name}: key and count disagree on length")
    if a.device != b.device:
        raise ValueError(f"the tables lie on {a.device} and {b.device}")
    Ca, Cb = a.capacity, b.capacity
    dev = a.device
    key = torch.empty(capacity, dtype=torch.int64, device=dev)
    count = torch.zeros(capacity, dtype=torch.int32, device=dev)
    scratch = kernels.scan_scratch(Ca + Cb, dev)
    lib = kernels.library()
    lib.call(
        "shannon_merge_tables", dev,
        kernels.ptr(a.key), kernels.ptr(a.count), Ca, kernels.ptr(b.key), kernels.ptr(b.count),
        Cb, capacity, kernels.ptr(scratch), scratch.shape[0], kernels.ptr(key),
        kernels.ptr(count),
    )
    lib.count("merge_spectra")
    return Spectrum(key=key, count=count, n=kernels.scan_total(scratch))


def merge_at(a: Spectrum, b: Spectrum, capacity: int) -> Spectrum:
    """Merge two sorted spectra (PAD last; their capacities may differ)
    into `capacity` lanes; equal keys sum their counts, and n counts every
    distinct key even past `capacity` (ops/count.py:256 _merge_at).  Only
    the lanes before each table's first PAD are merged.  Kernel K17 (one
    merge-path pass that sums equal keys, no sort) on CUDA, the plain
    version on CPU."""
    if a.key.is_cuda:
        return _merge_at_cuda(a, b, capacity)
    return merge_at_plain(a, b, capacity)


def _slice_spectrum(spec: Spectrum, cap: int) -> Spectrum:
    if cap >= spec.capacity:
        return spec
    return Spectrum(key=spec.key[:cap], count=spec.count[:cap], n=spec.n)


def merge_spectra_fixed(a: Spectrum, b: Spectrum) -> Spectrum:
    if a.capacity != b.capacity:
        raise ValueError(f"capacity mismatch {a.capacity} != {b.capacity}")
    return merge_at(a, b, a.capacity)


def merge_spectra_sized(a: Spectrum, b: Spectrum) -> Spectrum:
    """Merge at tight capacity: the growth path when the merged table
    outgrows the fixed capacity."""
    a = _slice_spectrum(a, tight_capacity(a.n))
    b = _slice_spectrum(b, tight_capacity(b.n))
    return merge_at(a, b, tight_capacity(a.n + b.n))


# copied from shannon_tpu/ops/count.py:313 (host helper in a JAX module)
def tight_capacity(n: int, slack: float = 1.05, minimum: int = 1 << 19) -> int:
    """Smallest capacity >= n * slack on the geometric grid
    {2^k, 1.5 * 2^k}."""
    want = max(int(n * slack) + 1, minimum)
    p = 1 << (want - 1).bit_length()  # smallest 2^k >= want
    return p // 4 * 3 if p // 4 * 3 >= want else p


def shrink_spectrum(spec: Spectrum) -> Spectrum:
    """Re-wrap a spectrum at tight_capacity(n); copies so the larger
    table's memory is released."""
    cap = tight_capacity(spec.n)
    if cap >= spec.capacity:
        return spec
    return Spectrum(
        key=spec.key[:cap].clone(), count=spec.count[:cap].clone(), n=spec.n
    )


def spectrum_from_arrays(
    kmers: np.ndarray,
    counts: np.ndarray,
    capacity: int | None = None,
    device="cuda",
) -> Spectrum:
    """Spectrum from sorted uint64 keys and counts
    (ops/count.py:345 spectrum_from_arrays)."""
    n = len(kmers)
    if capacity is None:
        capacity = tight_capacity(n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} entries")
    spec = empty_spectrum(capacity, device)
    spec.key[:n] = torch.from_numpy(np.asarray(kmers, np.uint64).astype(np.int64))
    spec.count[:n] = torch.from_numpy(np.array(counts, np.int32))
    spec.n = n
    return spec


def upload_words(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host words as an int32 bit-pattern tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def count_reads_spectrum(
    batch,
    k: int = 24,
    capacity: int = 1 << 22,
    canonical: bool = True,
    batch_reads: int = 1 << 16,
    device="cuda",
) -> Spectrum:
    """Stream a packed-resident ReadBatch through count_spectrum_packed,
    merging into one spectrum (ops/count.py:409 count_reads_spectrum).

    `capacity` bounds the distinct k-mers of any ONE batch; across
    batches the merged table grows at tight capacity, so the returned
    capacity may differ from `capacity` but always holds every entry."""
    total: Spectrum | None = None
    for s in range(0, batch.n_reads, batch_reads):
        e = min(s + batch_reads, batch.n_reads)
        m = batch.mask_rows(s, e)
        part = count_spectrum_packed(
            upload_words(batch.words[s:e], device),
            torch.from_numpy(batch.lengths[s:e]).to(device),
            k,
            capacity,
            canonical,
            length=batch.pad_length,
            mask=None if m is None else upload_words(m, device),
        )
        if part.overflowed():
            raise RuntimeError(
                f"a read batch produced more than capacity={capacity} "
                "distinct k-mers; raise kmer_capacity or lower batch_reads"
            )
        total = merge_batch(total, part)
    return total if total is not None else empty_spectrum(capacity, device)


def merge_batch(total: Spectrum | None, part: Spectrum) -> Spectrum:
    """The batch loop's merge of a batch's table into the running total:
    at the fixed capacity while it fits, else at a grown, tight capacity
    (ops/count.py:409 count_reads_spectrum, parallel/distributed.py:196
    count_reads_spectrum_sharded)."""
    if total is None:
        return part
    if total.capacity == part.capacity:
        merged = merge_spectra_fixed(total, part)
        return merge_spectra_sized(total, part) if merged.overflowed() else merged
    return merge_spectra_sized(total, part)
