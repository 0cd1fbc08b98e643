"""Error correction: abundance cut, dead-end rescue and error-capped
sibling pruning over the sorted spectrum.

Counterpart of ``shannon_tpu/ops/correction.py`` (oracle spec in
``shannon_tpu/oracle/correction.py``).  Probe sets resolve once (kernel K7);
the rescue rounds (K8) and prune rounds (K9) then run as one host loop each,
stopping at the first round that changes nothing (the reference split them
into chunks only to stay inside a TPU worker's execution limit), and the
kept entries are compacted (K10).  On CUDA tensors each of these launches its
hand-written kernel in ``csrc/correction.cu``; on CPU tensors its ``_plain``
version runs.

Decision arithmetic is float32 throughout, with every constant a float32
value rounded as the reference rounds it, so the tests ``c < ratio * max_sib``
and ``c <= max(3, lam + 4 sqrt(lam) + 1)`` round exactly as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from shannon_tpu_torch import kernels
from shannon_tpu_torch.ops.count import Spectrum
from shannon_tpu_torch.ops.kmers import PAD, canonical_key
from shannon_tpu_torch.ops.spectrum import lookup_sorted_plain
from shannon_tpu_torch.oracle.correction import choose_min_abundance


def compact_plain(spec: Spectrum, keep: torch.Tensor) -> Spectrum:
    """Plain PyTorch K10: torch.nonzero and a gather."""
    sel = torch.nonzero(keep).flatten()
    n = int(sel.shape[0])
    key = torch.full_like(spec.key, PAD)
    key[:n] = spec.key[sel]
    count = torch.zeros_like(spec.count)
    count[:n] = spec.count[sel]
    return Spectrum(key=key, count=count, n=n)


def _compact_cuda(spec: Spectrum, keep: torch.Tensor) -> Spectrum:
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    kernels.check_cuda("count", spec.count, torch.int32, 1)
    kernels.check_cuda("keep", keep, torch.bool, 1)
    C = spec.capacity
    if spec.count.shape[0] != C or keep.shape[0] != C:
        raise ValueError("key, count and keep disagree on length")
    if C >= 1 << 31:
        raise ValueError(f"{C} lanes exceed the int32 keep scan")
    dev = spec.key.device
    scan = torch.cumsum(keep, 0, dtype=torch.int32)
    key = torch.empty_like(spec.key)
    count = torch.empty_like(spec.count)
    lib = kernels.library()
    lib.call(
        "shannon_compact_keep", dev,
        kernels.ptr(spec.key), kernels.ptr(spec.count), kernels.ptr(keep),
        kernels.ptr(scan), C, kernels.ptr(key), kernels.ptr(count),
    )
    lib.count("compact_keep")
    return Spectrum(key=key, count=count, n=int(scan[-1]) if C else 0)


def compact(spec: Spectrum, keep: torch.Tensor) -> Spectrum:
    """Keep entries where `keep`; the table stays sorted and PAD-filled
    (ops/correction.py:19 _compact).  Kernel K10 on CUDA, the plain version
    on CPU."""
    if spec.key.is_cuda:
        return _compact_cuda(spec, keep)
    return compact_plain(spec, keep)


def count_histogram(spec: Spectrum, max_count: int = 64) -> torch.Tensor:
    """[max_count + 1] int32 histogram of entry counts, clamped into the
    top bin, h[0] = 0 (ops/correction.py:32 count_histogram)."""
    pad = spec.key == PAD
    c = torch.where(pad, 0, spec.count.clamp(0, max_count)).long()
    h = torch.bincount(c, minlength=max_count + 1)
    h[0] = 0
    return h.int()


def auto_min_abundance(spec: Spectrum) -> int:
    """The auto abundance cut (min_abundance == 0), from the histogram."""
    return choose_min_abundance(count_histogram(spec, 1024).cpu().numpy())


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


def probe_resolve_plain(spec: Spectrum, k: int, canonical: bool, side: str):
    """Plain PyTorch K7: the [8, C] probe tensor, then torch.searchsorted."""
    return lookup_sorted_plain(spec.key, probe_keys(spec.key, k, side, canonical))


def _probe_lookup_cuda(spec: Spectrum, k: int, canonical: bool, side: str):
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    C = spec.capacity
    if C == 0:
        raise ValueError("lookup in an empty table")
    dev = spec.key.device
    idx = torch.empty((8, C), dtype=torch.int64, device=dev)
    hit = torch.empty((8, C), dtype=torch.bool, device=dev)
    lib = kernels.library()
    lib.call(
        "shannon_probe_lookup", dev,
        kernels.ptr(spec.key), C, k, int(side == "ext"), int(canonical),
        kernels.ptr(idx), kernels.ptr(hit),
    )
    lib.count("probe_lookup")
    return idx, hit


def probe_resolve(spec: Spectrum, k: int, canonical: bool, side: str):
    """(idx, hit) [8, C] of one probe set (ops/correction.py:78
    _probe_resolve); idx is the lower bound clamped to C - 1, meaningful
    only where hit.  Probe targets never change across rounds, so each set
    resolves once.  Kernel K7 on CUDA, the plain version on CPU."""
    if side not in ("sib", "ext"):
        raise ValueError(f"side must be 'sib' or 'ext', got {side!r}")
    if spec.key.is_cuda:
        return _probe_lookup_cuda(spec, k, canonical, side)
    return probe_resolve_plain(spec, k, canonical, side)


def cut_counts(spec: Spectrum, min_abundance: int):
    """(raw counts with pads zeroed, counts after the abundance cut)."""
    raw = torch.where(spec.key == PAD, 0, spec.count)
    return raw, torch.where(raw < min_abundance, 0, raw)


def _check_round(counts, probe_sets) -> None:
    kernels.check_cuda("counts", counts, torch.int32, 1)
    C = counts.shape[0]
    for idx, hit in probe_sets:
        kernels.check_cuda("idx", idx, torch.int64, 2)
        kernels.check_cuda("hit", hit, torch.bool, 2)
        if idx.shape != (8, C) or hit.shape != (8, C):
            raise ValueError(f"probe tables must be [8, {C}], got {tuple(idx.shape)}")


def rescue_round_plain(counts, raw, sidx, shit, eidx, ehit):
    """Plain PyTorch K8 (one round of ops/correction.py:143 _rescue_chunk)."""
    alive = counts > 0
    pa_s = shit & alive[sidx]
    pa_e = ehit & alive[eidx]
    rsib_dead = ~pa_s[0::2].any(0)
    lsib_dead = ~pa_s[1::2].any(0)
    rext_any = pa_e[0::2].any(0)
    lext_any = pa_e[1::2].any(0)
    resc = (
        (raw > 0)
        & (counts == 0)
        & ((lext_any & rsib_dead) | (rext_any & lsib_dead))
    )
    return torch.where(resc, raw, counts), bool(resc.any())


def _rescue_round_cuda(counts, raw, sidx, shit, eidx, ehit):
    _check_round(counts, ((sidx, shit), (eidx, ehit)))
    kernels.check_cuda("raw", raw, torch.int32, 1)
    if raw.shape != counts.shape:
        raise ValueError("raw and counts disagree on length")
    dev = counts.device
    out = torch.empty_like(counts)
    changed = torch.empty(1, dtype=torch.int32, device=dev)
    lib = kernels.library()
    lib.call(
        "shannon_rescue_round", dev,
        kernels.ptr(counts), kernels.ptr(raw), kernels.ptr(sidx), kernels.ptr(shit),
        kernels.ptr(eidx), kernels.ptr(ehit), counts.shape[0], kernels.ptr(out),
        kernels.ptr(changed),
    )
    lib.count("rescue_round")
    return out, bool(changed.item())


def rescue_round(counts, raw, sidx, shit, eidx, ehit):
    """One Jacobi dead-end rescue round (oracle.correction.dead_end_rescue):
    a dropped k-mer revives iff it extends an alive k-mer that is otherwise
    dead on that side.  Returns (new counts, whether any lane changed); the
    input is never written.  Kernel K8 on CUDA, the plain version on CPU."""
    if counts.is_cuda:
        return _rescue_round_cuda(counts, raw, sidx, shit, eidx, ehit)
    return rescue_round_plain(counts, raw, sidx, shit, eidx, ehit)


def prune_constants(sibling_ratio: float, error_rate: float) -> tuple[float, float]:
    """(ratio, eps3): the float32 values the prune decisions use,
    f32(sibling_ratio) and f32(error_rate) / f32(3), each rounded once as
    the reference rounds it (a Python double through a C float would round
    error_rate / 3 a second time)."""
    ratio = np.float32(sibling_ratio)
    eps3 = np.float32(error_rate) / np.float32(3.0)
    return float(ratio), float(eps3)


def prune_round_plain(counts, sidx, shit, ratio: float, eps3: float, use_cap: bool):
    """Plain PyTorch K9 (one round of ops/correction.py:184 _prune_chunk)."""
    def f32(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=counts.device)

    three, four, one = f32(3.0), f32(4.0), f32(1.0)

    def cap(F):
        lam = f32(eps3) * F
        return torch.maximum(three, lam + four * torch.sqrt(lam) + one)

    pc = torch.where(shit, counts[sidx], 0)
    rmax = pc[0::2].amax(0).float()
    lmax = pc[1::2].amax(0).float()
    cf = counts.float()
    dr = cf < f32(ratio) * rmax
    dl = cf < f32(ratio) * lmax
    if use_cap:
        dr &= cf <= cap(rmax)
        dl &= cf <= cap(lmax)
    doomed = (counts > 0) & (dr | dl)
    return torch.where(doomed, 0, counts), bool(doomed.any())


def _prune_round_cuda(counts, sidx, shit, ratio, eps3, use_cap):
    _check_round(counts, ((sidx, shit),))
    dev = counts.device
    out = torch.empty_like(counts)
    changed = torch.empty(1, dtype=torch.int32, device=dev)
    lib = kernels.library()
    lib.call(
        "shannon_prune_round", dev,
        kernels.ptr(counts), kernels.ptr(sidx), kernels.ptr(shit), counts.shape[0],
        ratio, eps3, int(use_cap), kernels.ptr(out), kernels.ptr(changed),
    )
    lib.count("prune_round")
    return out, bool(changed.item())


def prune_round(counts, sidx, shit, ratio: float, eps3: float, use_cap: bool):
    """One Jacobi sibling-prune round: prune x iff f32(c) < ratio *
    f32(max sibling count) on a side AND, when use_cap, f32(c) <= the
    error cap of that side.  ratio and eps3 come from prune_constants.
    Returns (new counts, whether any lane changed); the input is never
    written.  Kernel K9 on CUDA, the plain version on CPU."""
    if counts.is_cuda:
        return _prune_round_cuda(counts, sidx, shit, ratio, eps3, use_cap)
    return prune_round_plain(counts, sidx, shit, ratio, eps3, use_cap)


def correct_spectrum(
    spec: Spectrum,
    k: int,
    min_abundance: int,
    sibling_ratio: float,
    correction_rounds: int,
    canonical: bool = True,
    error_rate: float = 0.0,
) -> Spectrum:
    """Abundance cut (+ dead-end rescue when the cut is engaged), then
    error-capped pruning rounds to a fixpoint (ops/correction.py:240
    correct_spectrum).  min_abundance == 0 means auto, as in
    AssemblyConfig; the reference resolved it only in its pipeline.  On
    CUDA every step launches its kernel (K7-K10)."""
    if min_abundance == 0:
        min_abundance = auto_min_abundance(spec)
    if sibling_ratio <= 0.0:
        return compact(spec, (spec.count >= min_abundance) & (spec.key != PAD))
    sidx, shit = probe_resolve(spec, k, canonical, "sib")
    raw, counts = cut_counts(spec, min_abundance)
    if min_abundance > 1:
        eidx, ehit = probe_resolve(spec, k, canonical, "ext")
        for _ in range(k + 2):  # the oracle's dead_end_rescue round cap
            nxt, changed = rescue_round(counts, raw, sidx, shit, eidx, ehit)
            if not changed:
                break
            counts = nxt
        del eidx, ehit
    ratio, eps3 = prune_constants(sibling_ratio, error_rate)
    for _ in range(correction_rounds):
        nxt, changed = prune_round(counts, sidx, shit, ratio, eps3, error_rate > 0)
        if not changed:
            break
        counts = nxt
    return compact(spec, counts > 0)
