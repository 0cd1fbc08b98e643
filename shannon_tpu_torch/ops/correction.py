"""Error correction: abundance cut, dead-end rescue and error-capped
sibling pruning over the sorted spectrum.

Counterpart of ``shannon_tpu/ops/correction.py`` (oracle spec in
``shannon_tpu/oracle/correction.py``).  The abundance cut is one pass (kernel
K20).  Probe sets resolve once (K7); the rescue rounds then run as one call
of K8, which enqueues every round on the card and reads one flag at the end,
and the prune rounds (K9) as a host loop, each stopping at the first round
that changes nothing (the reference split them into chunks only to stay
inside a TPU worker's execution limit); the kept entries are compacted
(K10).  The auto abundance cut reads the count histogram (K16).  The
reference's single-round steps ``abundance_filter`` (K20's keep flags) and
``sibling_prune_round`` (the sibling maxima of K22, then K23's keep flags)
compact through K10 as well.  On CUDA tensors each of these launches its
hand-written kernel in ``csrc/correction.cu``, ``csrc/rescue.cu`` or
``csrc/spectrum.cu``; on CPU tensors its ``_plain`` version runs.

Decision arithmetic is float32 throughout, with every constant a float32
value rounded as the reference rounds it, so the tests ``c < ratio * max_sib``
and ``c <= max(3, lam + 4 sqrt(lam) + 1)`` round exactly as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from shannon_tpu_torch import kernels
from shannon_tpu_torch.ops.count import Spectrum
from shannon_tpu_torch.ops.kmers import PAD
from shannon_tpu_torch.ops.spectrum import (
    lookup_sorted_plain, probe_keys, search_args, sibling_maxes,
)
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
        raise ValueError(f"{C} lanes exceed the 2^31 that K10 takes (the reference's int32 n)")
    dev = spec.key.device
    key = torch.empty_like(spec.key)
    count = torch.empty_like(spec.count)
    scratch = kernels.scan_scratch(C, dev)
    lib = kernels.library()
    lib.call(
        "shannon_compact_keep", dev,
        kernels.ptr(spec.key), kernels.ptr(spec.count), kernels.ptr(keep), C,
        kernels.ptr(scratch), scratch.shape[0], kernels.ptr(key), kernels.ptr(count),
    )
    lib.count("compact_keep")
    return Spectrum(key=key, count=count, n=kernels.scan_total(scratch))


def compact(spec: Spectrum, keep: torch.Tensor) -> Spectrum:
    """Keep entries where `keep`; the table stays sorted and PAD-filled
    (ops/correction.py:19 _compact).  Kernel K10 on CUDA, the plain version
    on CPU."""
    if spec.key.is_cuda:
        return _compact_cuda(spec, keep)
    return compact_plain(spec, keep)


# The largest max_count for which kernel K16 keeps a block histogram of
# max_count + 1 int32 bins in the 48 KB of shared memory a launch gets without
# opting in (HIST_KERNEL_MAX_COUNT in csrc/correction.cu); above it K16 counts
# into the global bins.  A switch point, not a limit.
HISTOGRAM_MAX_COUNT = 8192


def count_histogram_plain(spec: Spectrum, max_count: int = 64) -> torch.Tensor:
    """Plain PyTorch K16: torch.bincount of the clamped counts."""
    pad = spec.key == PAD
    c = torch.where(pad, 0, spec.count.clamp(0, max_count)).long()
    h = torch.bincount(c, minlength=max_count + 1)
    h[0] = 0
    return h.int()


def _count_histogram_cuda(spec: Spectrum, max_count: int) -> torch.Tensor:
    if max_count < 0:
        raise ValueError(f"max_count must be >= 0, got {max_count}")
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    kernels.check_cuda("count", spec.count, torch.int32, 1)
    C = spec.capacity
    if spec.count.shape[0] != C:
        raise ValueError("key and count disagree on length")
    dev = spec.key.device
    hist = torch.empty(max_count + 1, dtype=torch.int32, device=dev)
    lib = kernels.library()
    lib.call(
        "shannon_count_histogram", dev,
        kernels.ptr(spec.key), kernels.ptr(spec.count), C, max_count, kernels.ptr(hist),
    )
    lib.count("count_histogram")
    return hist


def count_histogram(spec: Spectrum, max_count: int = 64) -> torch.Tensor:
    """[max_count + 1] int32 histogram of entry counts, clamped into the
    top bin, h[0] = 0 (ops/correction.py:32 count_histogram).  Kernel K16
    on CUDA (its shared-memory histogram up to HISTOGRAM_MAX_COUNT, its
    global one above), the plain version on CPU."""
    if spec.key.is_cuda:
        return _count_histogram_cuda(spec, max_count)
    return count_histogram_plain(spec, max_count)


def auto_min_abundance(spec: Spectrum) -> int:
    """The auto abundance cut (min_abundance == 0), from the histogram."""
    return choose_min_abundance(count_histogram(spec, 1024).cpu().numpy())


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
    scratch, layout = search_args(C, dev)
    lib = kernels.library()
    lib.call(
        "shannon_probe_lookup", dev,
        kernels.ptr(spec.key), C, k, int(side == "ext"), int(canonical),
        kernels.ptr(scratch), scratch.shape[0], layout, kernels.ptr(idx), kernels.ptr(hit),
    )
    lib.count("probe_lookup")
    return idx, hit


def probe_resolve(spec: Spectrum, k: int, canonical: bool, side: str):
    """(idx, hit) [8, C] of one probe set (ops/correction.py:78
    _probe_resolve); idx is the lower bound clamped to C - 1, on a miss
    too (the reference promised it only where hit).  Probe targets never
    change across rounds, so each set resolves once.  Kernel K7 on CUDA
    (the index build and its walk, with the PAD and probe-group shortcuts),
    the plain version on CPU."""
    if side not in ("sib", "ext"):
        raise ValueError(f"side must be 'sib' or 'ext', got {side!r}")
    if spec.key.is_cuda:
        return _probe_lookup_cuda(spec, k, canonical, side)
    return probe_resolve_plain(spec, k, canonical, side)


def abundance_cut_plain(
    spec: Spectrum, min_abundance: int, raw: bool = True, cut: bool = True, keep: bool = True
):
    """Plain PyTorch K20: torch.where and compares."""
    r = torch.where(spec.key == PAD, 0, spec.count)
    return (
        r if raw else None,
        torch.where(r < min_abundance, 0, r) if cut else None,
        (spec.key != PAD) & (spec.count >= min_abundance) if keep else None,
    )


def _abundance_cut_cuda(spec: Spectrum, min_abundance: int, raw: bool, cut: bool, keep: bool):
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    kernels.check_cuda("count", spec.count, torch.int32, 1)
    C = spec.capacity
    if spec.count.shape[0] != C:
        raise ValueError("key and count disagree on length")
    if not -(1 << 31) <= min_abundance < 1 << 31:
        raise ValueError(f"min_abundance {min_abundance} is not an int32")
    dev = spec.key.device
    outs = (
        torch.empty(C, dtype=torch.int32, device=dev) if raw else None,
        torch.empty(C, dtype=torch.int32, device=dev) if cut else None,
        torch.empty(C, dtype=torch.bool, device=dev) if keep else None,
    )
    if C and (raw or cut or keep):
        lib = kernels.library()
        lib.call(
            "shannon_abundance_cut", dev,
            kernels.ptr(spec.key), kernels.ptr(spec.count), C, min_abundance,
            *(kernels.ptr(o) for o in outs),
        )
        lib.count("abundance_cut")
    return outs


def abundance_cut(
    spec: Spectrum, min_abundance: int, raw: bool = True, cut: bool = True, keep: bool = True
):
    """(raw, cut, keep) of one pass over the table, each None where not
    asked for: raw = count with pads zeroed, cut = raw where raw >=
    min_abundance else 0 (ops/correction.py:134 _cut_counts), keep = real
    lanes of count >= min_abundance (the mask of :54 abundance_filter; with
    min_abundance <= 0 it keeps real lanes of count 0, which cut > 0 would
    not).  Kernel K20 on CUDA, the plain version on CPU."""
    if spec.key.is_cuda:
        return _abundance_cut_cuda(spec, min_abundance, raw, cut, keep)
    return abundance_cut_plain(spec, min_abundance, raw, cut, keep)


def cut_counts_plain(spec: Spectrum, min_abundance: int):
    """Plain PyTorch K20 in its cut mode."""
    return abundance_cut_plain(spec, min_abundance, keep=False)[:2]


def cut_counts(spec: Spectrum, min_abundance: int):
    """(raw counts with pads zeroed, counts after the abundance cut), K20
    in its cut mode."""
    return abundance_cut(spec, min_abundance, keep=False)[:2]


def abundance_filter(spec: Spectrum, min_abundance: int) -> Spectrum:
    """Drop the PAD lanes and the k-mers of count < min_abundance
    (ops/correction.py:54 abundance_filter): K20's keep flags, then K10."""
    return compact(spec, abundance_cut(spec, min_abundance, raw=False, cut=False)[2])


def _check_round(counts, probe_sets) -> None:
    kernels.check_cuda("counts", counts, torch.int32, 1)
    C = counts.shape[0]
    for idx, hit in probe_sets:
        kernels.check_cuda("idx", idx, torch.int64, 2)
        kernels.check_cuda("hit", hit, torch.bool, 2)
        if idx.shape != (8, C) or hit.shape != (8, C):
            raise ValueError(f"probe tables must be [8, {C}], got {tuple(idx.shape)}")


def _rescue_round_plain(counts, raw, sidx, shit, eidx, ehit):
    """One Jacobi round of ops/correction.py:143 _rescue_chunk (lines
    161-175): (new counts, lanes rescued)."""
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
    return torch.where(resc, raw, counts), int(resc.sum())


def rescue_rounds_plain(counts, raw, sidx, shit, eidx, ehit, rounds: int, info=None):
    """Plain PyTorch K8: the loop of plain Jacobi rounds, each over every
    lane, stopping after the first that rescues nothing."""
    changed, rescued = True, []
    while changed and len(rescued) < rounds:
        counts, n = _rescue_round_plain(counts, raw, sidx, shit, eidx, ehit)
        rescued.append(n)
        changed = n > 0
    if info is not None:
        info.update(rounds_run=len(rescued), rescued=rescued)
    return counts, changed


# Rounds one launch sequence of K8 takes: its state byte stamps a lane rescued
# in round t with t + 1 below 255 (RESCUE_MAX_ROUNDS in csrc/rescue.cu).  A
# longer call runs in chunks, each starting from the last one's counts, as the
# reference's own host loop chunks the rounds.
RESCUE_MAX_ROUNDS = 253


def _rescue_rounds_cuda(counts, raw, sidx, shit, eidx, ehit, rounds: int, info):
    _check_round(counts, ((sidx, shit), (eidx, ehit)))
    kernels.check_cuda("raw", raw, torch.int32, 1)
    if raw.shape != counts.shape:
        raise ValueError("raw and counts disagree on length")
    C = counts.shape[0]
    if C >= 1 << 31:
        raise ValueError(f"{C} lanes exceed the 2^31 that K8's int32 lane indices take")
    dev = counts.device
    lib = kernels.library()
    words = -(-C // 32)
    state = torch.empty(C, dtype=torch.uint8, device=dev)
    hits = torch.empty(C, dtype=torch.int16, device=dev)  # a cut lane's 16 hit flags
    bits = torch.empty(2 * words, dtype=torch.int32, device=dev)
    changed, frontier, rescued = True, [], []
    while changed and len(rescued) < rounds:
        r = min(rounds - len(rescued), RESCUE_MAX_ROUNDS)
        out = torch.empty_like(counts)
        ctl = torch.empty(2 * (r + 2), dtype=torch.int32, device=dev)
        lib.call(
            "shannon_rescue_rounds", dev,
            kernels.ptr(counts), kernels.ptr(raw), kernels.ptr(sidx), kernels.ptr(shit),
            kernels.ptr(eidx), kernels.ptr(ehit), C, r, kernels.ptr(state), kernels.ptr(hits),
            kernels.ptr(bits), words, kernels.ptr(ctl), kernels.ptr(out),
        )
        lib.count("rescue_rounds")
        ctl = ctl.tolist()  # the one host read of the chunk
        per_round = ctl[r + 3 : 2 * r + 3]
        run = next((t for t, n in enumerate(per_round, 1) if n == 0), r)
        frontier += ctl[1 : run + 1]
        rescued += per_round[:run]
        changed = per_round[run - 1] > 0
        counts = out
    if info is not None:
        info.update(rounds_run=len(rescued), rescued=rescued, frontier=frontier)
    return counts, changed


def rescue_rounds(counts, raw, sidx, shit, eidx, ehit, rounds: int, info=None):
    """Up to `rounds` Jacobi dead-end rescue rounds (ops/correction.py:143
    _rescue_chunk; oracle.correction.dead_end_rescue): a dropped k-mer
    (raw > 0, counts == 0) revives to its raw count iff it extends an alive
    k-mer that is otherwise dead on that side.  Stops after the first round
    that rescues nothing.  Returns (counts, whether the last round run
    rescued a lane; True when rounds < 1, as the reference's loop returns);
    the input is never written.  With a dict `info`, also the rounds run and
    each one's rescues (and, from K8, each one's frontier: the lanes it
    evaluated).  Kernel K8 on CUDA (every round enqueued at once, one host
    read at the end), the plain version on CPU."""
    if counts.is_cuda:
        return _rescue_rounds_cuda(counts, raw, sidx, shit, eidx, ehit, rounds, info)
    return rescue_rounds_plain(counts, raw, sidx, shit, eidx, ehit, rounds, info)


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


def prune_keep_plain(spec: Spectrum, rmax: torch.Tensor, lmax: torch.Tensor, ratio: float):
    """Plain PyTorch K23: float32 products and compares."""
    r = torch.tensor(ratio, dtype=torch.float32, device=spec.key.device)
    cf = spec.count.float()
    doomed = (cf < r * rmax.float()) | (cf < r * lmax.float())
    return (spec.key != PAD) & ~doomed


def _prune_keep_cuda(spec: Spectrum, rmax, lmax, ratio: float):
    kernels.check_cuda("key", spec.key, torch.int64, 1)
    for name, t in (("count", spec.count), ("rmax", rmax), ("lmax", lmax)):
        kernels.check_cuda(name, t, torch.int32, 1)
        if t.shape[0] != spec.capacity:
            raise ValueError(f"key and {name} disagree on length")
    C = spec.capacity
    keep = torch.empty(C, dtype=torch.bool, device=spec.key.device)
    if C:
        lib = kernels.library()
        lib.call(
            "shannon_prune_keep", spec.key.device,
            kernels.ptr(spec.key), kernels.ptr(spec.count), kernels.ptr(rmax),
            kernels.ptr(lmax), C, ratio, kernels.ptr(keep),
        )
        lib.count("prune_keep")
    return keep


def prune_keep(spec: Spectrum, rmax: torch.Tensor, lmax: torch.Tensor, ratio: float):
    """Keep flags of one sibling-prune round (ops/correction.py:61
    sibling_prune_round, lines 68-74): real lanes where neither f32(count)
    < ratio * f32(rmax) nor f32(count) < ratio * f32(lmax).  No count > 0
    guard and no error cap, unlike prune_round: a real lane of count 0
    beside a positive sibling is dropped.  ratio is the float32 value from
    prune_constants.  Kernel K23 on CUDA, the plain version on CPU."""
    if spec.key.is_cuda:
        return _prune_keep_cuda(spec, rmax, lmax, ratio)
    return prune_keep_plain(spec, rmax, lmax, ratio)


def sibling_prune_round(
    spec: Spectrum, k: int, sibling_ratio: float, canonical: bool = True
) -> Spectrum:
    """One Jacobi round of sibling-ratio pruning, then compaction
    (ops/correction.py:61 sibling_prune_round): K22's sibling maxima, K23's
    keep flags with f32(sibling_ratio), then K10."""
    rmax, lmax = sibling_maxes(spec, k, canonical)
    ratio, _ = prune_constants(sibling_ratio, 0.0)
    return compact(spec, prune_keep(spec, rmax, lmax, ratio))


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
    CUDA every step launches its kernel (K7-K10, K16, K20)."""
    if min_abundance == 0:
        min_abundance = auto_min_abundance(spec)
    if sibling_ratio <= 0.0:
        return abundance_filter(spec, min_abundance)
    sidx, shit = probe_resolve(spec, k, canonical, "sib")
    raw, counts = cut_counts(spec, min_abundance)
    if min_abundance > 1:
        eidx, ehit = probe_resolve(spec, k, canonical, "ext")
        # the oracle's dead_end_rescue round cap
        counts, _ = rescue_rounds(counts, raw, sidx, shit, eidx, ehit, k + 2)
        del eidx, ehit
    ratio, eps3 = prune_constants(sibling_ratio, error_rate)
    for _ in range(correction_rounds):
        nxt, changed = prune_round(counts, sidx, shit, ratio, eps3, error_rate > 0)
        if not changed:
            break
        counts = nxt
    return compact(spec, counts > 0)
