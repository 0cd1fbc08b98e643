"""Read threading: map every read to its contig-path runs.

Counterpart of ``shannon_tpu/ops/thread.py`` (spec in its module
docstring; matches oracle thread_read_runs).  Window keys come from K1 in
forward orientation, their node lanes from K3.  A run is a maximal stretch
of windows that hit the node table; an event is recorded at a run start
or where the window's contig offset is 0.

Two kernels follow the lookup: K4 (``thread_windows``) scans each read row
and writes its events and runs to the front of -1-padded rows, and K5
(``compact_thread_outputs``) moves every real event and run of the batch
to the front of flat arrays in (read, position) order, plus per-read
counts.  On CPU tensors their plain twins run.  ``rect`` rebuilds the
per-read rows on the host, which ``runs_to_flat_paths`` (single-end) or
``paths_to_lists`` (paired; both copied from the reference) turn into
evidence.
"""

from __future__ import annotations

import numpy as np
import torch

from shannon_tpu_torch import kernels
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


def max_runs(W: int) -> int:
    """Runs a row of W windows can hold: R = (W + 1) // 2 + 1."""
    return (W + 1) // 2 + 1


def thread_windows_plain(idx, hit, valid, node_cid, node_off):
    """Plain PyTorch K4: the threading body after the lookup
    (ops/thread.py:104 _thread_windows, lines 115-174)."""
    N, W = idx.shape
    hit = hit & valid
    cid = torch.where(hit, node_cid[idx], -1)
    off = torch.where(hit, node_off[idx], -1)

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
    R = max_runs(W)
    col = torch.arange(W, device=idx.device).expand(N, W)
    run_p0, run_o0 = row_compact(run_start, (col, off), R)
    run_p1, run_o1 = row_compact(run_end, (col, off), R)
    return ev_cid, ev_run, n_events, run_p0, run_p1, run_o0, run_o1


def _thread_windows_cuda(idx, hit, valid, node_cid, node_off):
    kernels.check_cuda("idx", idx, torch.int64, 2)
    kernels.check_cuda("hit", hit, torch.bool, 2)
    kernels.check_cuda("valid", valid, torch.bool, 2)
    kernels.check_cuda("node_cid", node_cid, torch.int64, 1)
    kernels.check_cuda("node_off", node_off, torch.int64, 1)
    if hit.shape != idx.shape or valid.shape != idx.shape:
        raise ValueError("idx, hit and valid disagree on shape")
    N, W = idx.shape
    R = max_runs(W)
    dev = idx.device
    ev = [torch.empty((N, W), dtype=torch.int64, device=dev) for _ in range(2)]
    n_events = torch.empty(N, dtype=torch.int64, device=dev)
    runs = [torch.empty((N, R), dtype=torch.int64, device=dev) for _ in range(4)]
    lib = kernels.library()
    lib.call(
        "shannon_thread_rows", dev,
        kernels.ptr(idx), kernels.ptr(hit), kernels.ptr(valid),
        kernels.ptr(node_cid), kernels.ptr(node_off), N, W, R,
        *map(kernels.ptr, ev), kernels.ptr(n_events), *map(kernels.ptr, runs),
    )
    lib.count("thread_rows")
    return ev[0], ev[1], n_events, *runs


def thread_windows(idx, hit, valid, node_cid, node_off):
    """Per read row, from the node lookup of its windows (idx, hit [N, W];
    idx meaningful only where hit) and their validity: the row's events
    and run geometry.  Returns (ev_cid [N, W], ev_run [N, W], n_events
    [N], run_p0, run_p1, run_o0, run_o1 [N, R]), int64, -1-padded,
    R = (W + 1) // 2 + 1.  Kernel K4 on CUDA, the plain version on CPU."""
    if idx.is_cuda:
        return _thread_windows_cuda(idx, hit, valid, node_cid, node_off)
    return thread_windows_plain(idx, hit, valid, node_cid, node_off)


def thread_reads_device_packed(
    words: torch.Tensor,
    lengths: torch.Tensor,
    ca: ContigArrays,
    k: int,
    length: int | None = None,
    mask: torch.Tensor | None = None,
):
    """Thread one packed read batch through the node table
    (ops/thread.py:53 thread_reads_device_packed): K1, K3, then K4."""
    keys, valid = extract_kmers_packed(
        words, lengths, k, canonical=False, length=length, mask=mask
    )
    idx, hit = lookup_sorted(ca.node_key, keys)
    return thread_windows(idx, hit, valid, ca.node_cid, ca.node_off)


def compact_thread_outputs_plain(ev_cid, ev_run, n_events, run_p0, run_p1, run_o0, run_o1):
    """Plain PyTorch K5 (ops/thread.py:178 compact_thread_outputs)."""
    ve = ev_cid >= 0
    vr = run_p0 >= 0
    return (
        ev_cid[ve], ev_run[ve],
        run_p0[vr], run_p1[vr], run_o0[vr], run_o1[vr],
        n_events, vr.sum(1),
    )


def _compact_thread_outputs_cuda(ev_cid, ev_run, n_events, run_p0, run_p1, run_o0, run_o1):
    rows_e, rows_r = (ev_cid, ev_run), (run_p0, run_p1, run_o0, run_o1)
    for name, t in zip(("ev_cid", "ev_run", "run_p0", "run_p1", "run_o0", "run_o1"),
                       rows_e + rows_r):
        kernels.check_cuda(name, t, torch.int64, 2)
    kernels.check_cuda("n_events", n_events, torch.int64, 1)
    N, W = ev_cid.shape
    R = run_p0.shape[1]
    if ev_run.shape != (N, W) or any(t.shape != (N, R) for t in rows_r) or n_events.shape != (N,):
        raise ValueError("threading rows disagree on shape")
    dev = ev_cid.device
    lib = kernels.library()
    n_runs = torch.empty(N, dtype=torch.int64, device=dev)
    lib.call("shannon_row_counts", dev, kernels.ptr(run_p0), N, R, kernels.ptr(n_runs))
    end_e = torch.cumsum(n_events, 0)
    end_r = torch.cumsum(n_runs, 0)
    tot_e, tot_r = torch.stack([end_e[-1], end_r[-1]]).tolist() if N else (0, 0)
    flat_e = [torch.empty(tot_e, dtype=torch.int64, device=dev) for _ in rows_e]
    flat_r = [torch.empty(tot_r, dtype=torch.int64, device=dev) for _ in rows_r]
    for counts, ends, width, rows, flat in (
        (n_events, end_e, W, rows_e, flat_e), (n_runs, end_r, R, rows_r, flat_r)
    ):
        ins = [kernels.ptr(t) for t in rows] + [None] * (4 - len(rows))
        outs = [kernels.ptr(t) for t in flat] + [None] * (4 - len(flat))
        lib.call(
            "shannon_compact_rows", dev,
            kernels.ptr(counts), kernels.ptr(ends), N, width, len(rows), *ins, *outs,
        )
    lib.count("compact_rows")
    return (*flat_e, *flat_r, n_events, n_runs)


def compact_thread_outputs(ev_cid, ev_run, n_events, run_p0, run_p1, run_o0, run_o1):
    """Across-read compaction (ops/thread.py:178 compact_thread_outputs):
    every real event and every real run in (read, position) order.
    Returns (c_cid, c_run, c_p0, c_p1, c_o0, c_o1, n_events, n_runs).
    Kernel K5 on CUDA (copies each row's first n_events events and its
    real runs, the layout K4 writes), the plain version on CPU."""
    args = (ev_cid, ev_run, n_events, run_p0, run_p1, run_o0, run_o1)
    if ev_cid.is_cuda:
        return _compact_thread_outputs_cuda(*args)
    return compact_thread_outputs_plain(*args)


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


# copied from shannon_tpu/ops/thread.py:367 (host helper in a JAX module)
def paths_to_lists(
    ev_cid: np.ndarray,
    ev_run: np.ndarray,
    n_events: np.ndarray,
    run_p0: np.ndarray,
    run_p1: np.ndarray,
    run_o0: np.ndarray,
    run_o1: np.ndarray,
    rescue: bool = True,
) -> list[list]:
    """Host conversion to per-read Run lists (aligned with batch rows;
    [] = unthreadable read): [[Run0, Run1, ...], ...] with each Run
    carrying (path, p0, p1, o0, o1) — see oracle.multibridge.Run.
    rescue=False keeps only each read's longest run (by window count
    p1 - p0 + 1, ties -> earliest)."""
    from shannon_tpu_torch.oracle.multibridge import Run

    ev_cid = np.asarray(ev_cid)
    ev_run = np.asarray(ev_run)
    n_events = np.asarray(n_events)
    run_p0 = np.asarray(run_p0)
    run_p1 = np.asarray(run_p1)
    run_o0 = np.asarray(run_o0)
    run_o1 = np.asarray(run_o1)
    out: list[list] = []
    for i in range(ev_cid.shape[0]):
        n = int(n_events[i])
        if n == 0:
            out.append([])
            continue
        cids = ev_cid[i, :n]
        rids = ev_run[i, :n]
        # split events into runs at run-id changes
        cuts = np.nonzero(np.diff(rids))[0] + 1
        paths = [seg.tolist() for seg in np.split(cids, cuts)]
        run_ids = [int(rids[0])] + [int(rids[c]) for c in cuts]
        runs = [
            Run(
                path=paths[t],
                p0=int(run_p0[i, r]),
                p1=int(run_p1[i, r]),
                o0=int(run_o0[i, r]),
                o1=int(run_o1[i, r]),
            )
            for t, r in enumerate(run_ids)
        ]
        if rescue:
            out.append(runs)
        else:
            best = max(
                range(len(runs)),
                key=lambda t: (runs[t].p1 - runs[t].p0, -t),
            )
            out.append([runs[best]])
    return out
