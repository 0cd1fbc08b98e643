"""Read threading: map every read to its contig-path runs.

Counterpart of ``shannon_tpu/ops/thread.py`` (spec in its module
docstring; matches oracle thread_read_runs).  Window keys come from K1 in
forward orientation, their node lanes from K3.  A run is a maximal stretch
of windows that hit the node table; an event is recorded at a run start
or where the window's contig offset is 0.

The output for the host is the flat evidence of ``compact_thread_outputs``
(every real event and run, in (read, position) order, plus per-read
counts); ``rect`` rebuilds the per-read rows that ``runs_to_flat_paths``
(copied from the reference) turns into evidence paths.
"""

from __future__ import annotations

import numpy as np
import torch

from shannon_tpu_torch.ops.condense import ContigArrays
from shannon_tpu_torch.ops.kmers import extract_kmers_packed
from shannon_tpu_torch.ops.spectrum import lookup_sorted


def row_compact(flag: torch.Tensor, payloads: tuple, width: int) -> tuple:
    """Per row, move the flagged columns' payloads to the front in column
    order; -1 elsewhere.  Returns [N, width] tensors."""
    N = flag.shape[0]
    dest = torch.cumsum(flag, 1) - 1
    r, c = torch.nonzero(flag, as_tuple=True)
    d = dest[r, c]
    out = []
    for p in payloads:
        o = torch.full((N, width), -1, dtype=p.dtype, device=p.device)
        o[r, d] = p[r, c]
        out.append(o)
    return tuple(out)


def thread_windows(keys: torch.Tensor, valid: torch.Tensor, ca: ContigArrays):
    """Threading body on window keys (ops/thread.py:104 _thread_windows).
    Returns (ev_cid [N, W], ev_run [N, W], n_events [N], run_p0, run_p1,
    run_o0, run_o1 [N, R]), -1-padded, R = (W + 1) // 2 + 1."""
    N, W = keys.shape
    idx, hit = lookup_sorted(ca.node_key, keys)
    hit &= valid
    cid = torch.where(hit, ca.node_cid[idx], -1)
    off = torch.where(hit, ca.node_off[idx], -1)

    prev_hit = torch.zeros_like(hit)
    prev_hit[:, 1:] = hit[:, :-1]
    next_hit = torch.zeros_like(hit)
    next_hit[:, :-1] = hit[:, 1:]
    run_start = hit & ~prev_hit
    run_end = hit & ~next_hit
    run_id = torch.where(hit, torch.cumsum(run_start, 1) - 1, -1)

    is_event = hit & (run_start | (off == 0))
    n_events = is_event.sum(1)
    ev_cid, ev_run = row_compact(is_event, (cid, run_id), W)
    max_runs = (W + 1) // 2 + 1
    col = torch.arange(W, device=keys.device).expand(N, W)
    run_p0, run_o0 = row_compact(run_start, (col, off), max_runs)
    run_p1, run_o1 = row_compact(run_end, (col, off), max_runs)
    return ev_cid, ev_run, n_events, run_p0, run_p1, run_o0, run_o1


def thread_reads_device_packed(
    words: torch.Tensor,
    lengths: torch.Tensor,
    ca: ContigArrays,
    k: int,
    length: int | None = None,
    mask: torch.Tensor | None = None,
):
    """Thread one packed read batch through the node table
    (ops/thread.py:53 thread_reads_device_packed)."""
    keys, valid = extract_kmers_packed(
        words, lengths, k, canonical=False, length=length, mask=mask
    )
    return thread_windows(keys, valid, ca)


def compact_thread_outputs(ev_cid, ev_run, n_events, run_p0, run_p1, run_o0, run_o1):
    """Across-read compaction (ops/thread.py:178 compact_thread_outputs):
    every real event and every real run in (read, position) order.
    Returns (c_cid, c_run, c_p0, c_p1, c_o0, c_o1, n_events, n_runs)."""
    ve = ev_cid >= 0
    vr = run_p0 >= 0
    return (
        ev_cid[ve], ev_run[ve],
        run_p0[vr], run_p1[vr], run_o0[vr], run_o1[vr],
        n_events, vr.sum(1),
    )


def rect(flat: np.ndarray, counts: np.ndarray, width: int) -> np.ndarray:
    """Flat per-read segments -> [rows, width] -1-padded rows (the
    rectangular split of ops/thread.py:266 unpack_evidence)."""
    n_rows = len(counts)
    out = np.full((n_rows, max(width, 0)), -1, np.int64)
    total = int(counts.sum())
    row_of = np.repeat(np.arange(n_rows), counts)
    col = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    out[row_of, col] = flat[:total]
    return out


# copied from shannon_tpu/ops/thread.py:315 (host helper in a JAX module)
def runs_to_flat_paths(
    ev_cid: np.ndarray,
    ev_run: np.ndarray,
    n_events: np.ndarray,
    run_p0: np.ndarray,
    run_p1: np.ndarray,
    rc_pair: np.ndarray | None,
    rescue: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized single-end evidence construction: device threading
    rows -> flat path arrays (flat node ids, row offsets, unit weights),
    with each path followed by its reverse-complement twin when rc_pair
    is given — the array equivalent of paths_to_lists + expand_paths
    for the unpaired mode (VERDICT r2 item 5: the per-row Python loop
    was coverage-dependent and read-scale).  Emission order matches
    expand_paths exactly: read-major, runs in read order, forward then
    RC; duplicate paths merge downstream in NodeGraph._dedup_rows."""
    N, w = ev_cid.shape
    col = np.arange(w, dtype=np.int32)[None, :]
    valid = col < n_events[:, None]
    if not rescue:
        windows = np.where(run_p0 != -1, run_p1 - run_p0, -1)
        best = windows.argmax(axis=1).astype(np.int32)  # ties: earliest
        valid &= ev_run == best[:, None]
    if not valid.any():
        z = np.empty(0, np.int64)
        return z, np.zeros(1, np.int64), z
    prev_run = np.empty_like(ev_run)
    prev_run[:, 0] = -2
    prev_run[:, 1:] = ev_run[:, :-1]
    start2d = valid & ((col == 0) | (ev_run != prev_run))
    flat = ev_cid[valid].astype(np.int64)
    starts = start2d[valid]
    path_id = np.cumsum(starts) - 1
    lens = np.bincount(path_id).astype(np.int64)
    n_paths = len(lens)
    offs = np.zeros(n_paths + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    if rc_pair is None:
        return flat, offs, np.ones(n_paths, np.int64)
    total = len(flat)
    lens2 = np.repeat(lens, 2)
    offs2 = np.zeros(2 * n_paths + 1, np.int64)
    np.cumsum(lens2, out=offs2[1:])
    out = np.empty(2 * total, np.int64)
    within = np.arange(total, dtype=np.int64) - offs[path_id]
    out[offs2[2 * path_id] + within] = flat
    rev = flat[offs[path_id] + lens[path_id] - 1 - within]
    out[offs2[2 * path_id + 1] + within] = np.asarray(rc_pair, np.int64)[rev]
    return out, offs2, np.ones(2 * n_paths, np.int64)
