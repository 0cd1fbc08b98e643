"""Error correction: abundance cut, dead-end rescue and error-capped
sibling pruning over the sorted spectrum.

Counterpart of ``shannon_tpu/ops/correction.py`` (oracle spec in
``shannon_tpu/oracle/correction.py``).  Probe sets resolve once through
K3; the rescue and prune rounds then run as one loop each, stopping at the
first round that changes nothing (the reference split them into chunks only
to stay inside a TPU worker's execution limit).

Decision arithmetic is float32 throughout, with every constant a float32
tensor, so the tests ``c < ratio * max_sib`` and
``c <= max(3, lam + 4 sqrt(lam) + 1)`` round exactly as in the reference.
"""

from __future__ import annotations

import torch

from shannon_tpu.oracle.correction import choose_min_abundance
from shannon_tpu_torch.ops.count import Spectrum
from shannon_tpu_torch.ops.kmers import PAD, canonical_key
from shannon_tpu_torch.ops.spectrum import lookup_sorted


def compact(spec: Spectrum, keep: torch.Tensor) -> Spectrum:
    """Keep entries where `keep`; the table stays sorted and PAD-filled
    (ops/correction.py:19 _compact)."""
    sel = torch.nonzero(keep).flatten()
    n = int(sel.shape[0])
    key = torch.full_like(spec.key, PAD)
    key[:n] = spec.key[sel]
    count = torch.zeros_like(spec.count)
    count[:n] = spec.count[sel]
    return Spectrum(key=key, count=count, n=n)


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


def abundance_filter(spec: Spectrum, min_abundance: int) -> Spectrum:
    return compact(spec, (spec.count >= min_abundance) & (spec.key != PAD))


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


def probe_resolve(spec: Spectrum, k: int, canonical: bool, side: str):
    """(idx, hit) [8, C] of one probe set (ops/correction.py:78
    _probe_resolve).  Probe targets never change across rounds, so each
    set resolves once."""
    return lookup_sorted(spec.key, probe_keys(spec.key, k, side, canonical))


def cut_counts(spec: Spectrum, min_abundance: int):
    """(raw counts with pads zeroed, counts after the abundance cut)."""
    raw = torch.where(spec.key == PAD, 0, spec.count)
    return raw, torch.where(raw < min_abundance, 0, raw)


def rescue_rounds(counts, raw, sidx, shit, eidx, ehit, rounds: int):
    """Dead-end rescue (oracle.correction.dead_end_rescue): a dropped
    k-mer revives iff it extends an alive k-mer that is otherwise dead
    on that side.  Jacobi rounds to a fixpoint, at most `rounds`."""
    for _ in range(rounds):
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
        if not bool(resc.any()):
            break
        counts = torch.where(resc, raw, counts)
    return counts


def prune_rounds(
    counts, sidx, shit, sibling_ratio: float, error_rate: float, rounds: int
):
    """Jacobi sibling-prune rounds to a fixpoint, at most `rounds`
    (ops/correction.py:184 _prune_chunk): prune x iff
    f32(c) < ratio * f32(max sibling count) on a side AND, when
    error_rate > 0, f32(c) <= the error cap of that side."""
    def f32(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=counts.device)

    ratio = f32(sibling_ratio)
    eps3 = f32(error_rate) / f32(3.0)
    three, four, one = f32(3.0), f32(4.0), f32(1.0)

    def cap(F):
        lam = eps3 * F
        return torch.maximum(three, lam + four * torch.sqrt(lam) + one)

    for _ in range(rounds):
        pc = torch.where(shit, counts[sidx], 0)
        rmax = pc[0::2].amax(0).float()
        lmax = pc[1::2].amax(0).float()
        cf = counts.float()
        dr = cf < ratio * rmax
        dl = cf < ratio * lmax
        if error_rate > 0:
            dr &= cf <= cap(rmax)
            dl &= cf <= cap(lmax)
        doomed = (counts > 0) & (dr | dl)
        if not bool(doomed.any()):
            break
        counts = torch.where(doomed, 0, counts)
    return counts


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
    AssemblyConfig; the reference resolved it only in its pipeline."""
    if min_abundance == 0:
        min_abundance = auto_min_abundance(spec)
    if sibling_ratio <= 0.0:
        return abundance_filter(spec, min_abundance)
    sidx, shit = probe_resolve(spec, k, canonical, "sib")
    raw, counts = cut_counts(spec, min_abundance)
    if min_abundance > 1:
        eidx, ehit = probe_resolve(spec, k, canonical, "ext")
        counts = rescue_rounds(counts, raw, sidx, shit, eidx, ehit, k + 2)
        del eidx, ehit
    counts = prune_rounds(
        counts, sidx, shit, sibling_ratio, error_rate, correction_rounds
    )
    return compact(spec, counts > 0)
