"""Batched sparse-flow solver: per X-node greedy max-min transport with
seeded restarts, bit-identical to the oracle solver.

Counterpart of ``shannon_tpu/ops/sparseflow.py``.  Nodes are padded to
(MAXD, MAXD) = (8, 8) margins; each job is solved with sf_restarts + 1
seeds at once and the best restart is chosen on the device with the
oracle's key.  On CUDA tensors this is kernel K6 (``csrc/sparseflow.cu``);
on CPU tensors its plain twin, where flows are float32 and the tie hash
wraps at uint32, computed in int64 with a mask after every multiply and
add.

One deliberate difference from the reference's device solver: pairings
come back in the greedy's pick order, as the oracle's ``solve_node`` emits
them, not in row-major cell order.  ``sparse_flow`` numbers the split
copies in pairing order, and that numbering can change which transcripts
survive, so the row-major order made the reference's device path differ
from the oracle on some inputs (ROADMAP Queue 3).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from shannon_tpu_torch import kernels
from shannon_tpu_torch.oracle.sparseflow import SF_MAXD, _node_flows, fnv1a, node_blocks, solve_node

MAXD = SF_MAXD
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without an int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def tie_hash(i: torch.Tensor, j: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The oracle's uint32 tie hash (ops/sparseflow.py:27 _tie_hash_dev)."""
    h = _mul32(i, 2654435761) ^ _mul32(j, 40503) ^ (seed & _M32)
    h = _mul32(h ^ (h >> 16), 2246822519)
    return h ^ (h >> 13)


def greedy_core(a, b, seeds, use_hash, max_steps: int):
    """Greedy max-min decomposition of margins a [B, M], b [B, N]
    (ops/sparseflow.py:49 _greedy_core).  Ties go to the smallest flat
    index, or with use_hash to the largest tie hash (then the smallest
    flat index).  Returns (flow tensors F [B, M, N], picks [B, max_steps]:
    the flat cell of each step's pairing, -1 once nothing is left)."""
    B, M = a.shape
    N = b.shape[1]
    dev = a.device
    # margin totals summed left to right, as the oracle's numpy sum does
    # for its (at most 8) entries
    sa, sb = a[:, 0], b[:, 0]
    for c in range(1, M):
        sa = sa + a[:, c]
    for c in range(1, N):
        sb = sb + b[:, c]
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    eps = torch.tensor(1e-6, dtype=torch.float32, device=dev) * torch.maximum(
        torch.maximum(sa, sb), one
    )
    ii = torch.arange(M, device=dev)[:, None].expand(M, N)
    jj = torch.arange(N, device=dev)[None, :].expand(M, N)
    h = tie_hash(ii[None], jj[None], seeds[:, None, None])  # [B, M, N]
    F = torch.zeros((B, M, N), dtype=torch.float32, device=dev)
    picks = torch.full((B, max_steps), -1, dtype=torch.int64, device=dev)
    for step in range(max_steps):
        m = torch.minimum(a[:, :, None], b[:, None, :])
        best = m.amax(dim=(1, 2))
        active = best > eps
        ties = m >= best[:, None, None]
        flat_lex = torch.argmax(ties.reshape(B, -1).int(), dim=1)
        hm = torch.where(ties, h, 0).amax(dim=(1, 2))
        cand = ties & (h == hm[:, None, None])
        flat_hash = torch.argmax(cand.reshape(B, -1).int(), dim=1)
        flat = torch.where(use_hash, flat_hash, flat_lex)
        picks[:, step] = torch.where(active, flat, -1)
        oh_i = torch.nn.functional.one_hot(flat // N, M).float()
        oh_j = torch.nn.functional.one_hot(flat % N, N).float()
        f = torch.where(active, best, 0.0)
        a = a - f[:, None] * oh_i
        b = b - f[:, None] * oh_j
        F = F + f[:, None, None] * (oh_i[:, :, None] * oh_j[:, None, :])
    return F, picks


def batched_greedy_packed_plain(buf: torch.Tensor, k_restarts: int, max_steps: int = 2 * MAXD):
    """Plain PyTorch K6: solve every job of buf [B, 2*MAXD+1] int32 (a
    bits | b bits | node seed) with k_restarts + 1 seeded greedy runs.
    Returns the winning restart's flow tensors [B, MAXD, MAXD] float32 and
    its picks [B, max_steps] int64; the winner minimizes (pairing count,
    uint64 support mask at stride MAXD, restart index), as the oracle's
    _best_of_restarts (ops/sparseflow.py:88 batched_greedy_packed)."""
    B = buf.shape[0]
    K = k_restarts + 1
    dev = buf.device
    a1 = buf[:, :MAXD].contiguous().view(torch.float32)
    b1 = buf[:, MAXD : 2 * MAXD].contiguous().view(torch.float32)
    node_seed = buf[:, 2 * MAXD].long() & _M32
    a = a1.repeat_interleave(K, 0)
    b = b1.repeat_interleave(K, 0)
    r = torch.arange(K, device=dev).repeat(B)
    seeds = torch.where(r > 0, (node_seed.repeat_interleave(K) + r) & _M32, 0)
    F, picks = greedy_core(a, b, seeds, r > 0, max_steps)  # [B*K, M, N]

    nz = F > 0
    counts = nz.sum(dim=(1, 2)).reshape(B, K)
    cell = torch.arange(MAXD * MAXD, device=dev).reshape(MAXD, MAXD)
    one_bit = torch.ones_like(cell)
    lo_bit = torch.where(cell < 32, one_bit << cell.clamp(max=31), 0)
    hi_bit = torch.where(cell >= 32, one_bit << (cell - 32).clamp(min=0), 0)
    lo_mask = torch.where(nz, lo_bit, 0).sum(dim=(1, 2)).reshape(B, K)
    hi_mask = torch.where(nz, hi_bit, 0).sum(dim=(1, 2)).reshape(B, K)
    cand = counts == counts.amin(1, keepdim=True)
    hi_m = torch.where(cand, hi_mask, _M32)
    cand &= hi_m == hi_m.amin(1, keepdim=True)
    lo_m = torch.where(cand, lo_mask, _M32)
    cand &= lo_m == lo_m.amin(1, keepdim=True)
    best_r = torch.argmax(cand.int(), dim=1)  # first True
    rows = torch.arange(B, device=dev)
    return (
        F.reshape(B, K, MAXD, MAXD)[rows, best_r],
        picks.reshape(B, K, max_steps)[rows, best_r],
    )


def _batched_greedy_packed_cuda(buf: torch.Tensor, k_restarts: int, max_steps: int):
    kernels.check_cuda("buf", buf, torch.int32, 2)
    if buf.shape[1] != 2 * MAXD + 1:
        raise ValueError(f"buf must be [B, {2 * MAXD + 1}], got {tuple(buf.shape)}")
    if k_restarts < 0 or not 0 < max_steps <= 2 * MAXD:
        raise ValueError(f"k_restarts={k_restarts}, max_steps={max_steps} out of range")
    B = buf.shape[0]
    K = k_restarts + 1
    dev = buf.device
    picks = torch.empty((B * K, max_steps), dtype=torch.int32, device=dev)
    flows = torch.empty((B * K, max_steps), dtype=torch.float32, device=dev)
    nnz = torch.empty(B * K, dtype=torch.int32, device=dev)
    support = torch.empty(B * K, dtype=torch.int64, device=dev)
    F = torch.empty((B, MAXD, MAXD), dtype=torch.float32, device=dev)
    out_picks = torch.empty((B, max_steps), dtype=torch.int64, device=dev)
    lib = kernels.library()
    lib.call(
        "shannon_sf_greedy", dev,
        kernels.ptr(buf), B, K, max_steps,
        *map(kernels.ptr, (picks, flows, nnz, support, F, out_picks)),
    )
    lib.count("sf_greedy")
    return F, out_picks


def batched_greedy_packed(buf: torch.Tensor, k_restarts: int, max_steps: int = 2 * MAXD):
    """Solve every job of buf [B, 2*MAXD+1] int32 (a bits | b bits | node
    seed) with k_restarts + 1 seeded greedy runs; returns the winning
    restart's flow tensors [B, MAXD, MAXD] float32 and picks [B,
    max_steps] int64 (the flat cell of each step's pairing, -1 once
    nothing is left).  Kernel K6 on CUDA, the plain version on CPU."""
    if buf.is_cuda:
        return _batched_greedy_packed_cuda(buf, k_restarts, max_steps)
    return batched_greedy_packed_plain(buf, k_restarts, max_steps)


def solve_nodes_device(g, xs: list[int], config, edge_flows=None, *, device) -> dict[int, list]:
    """Batched solver for every X-node in xs, mirroring oracle solve_node
    (same block plan, margins, seeds, restart selection, threshold, and
    pairing order); one job per (node, block).  Nodes of degree > MAXD go
    to the host solver, which gives identical pairings
    (ops/sparseflow.py:143 solve_nodes_device).  Unlike the reference,
    small rounds stay on the device too: on an NVIDIA H100 80GB HBM3 at
    700 W the batched solver beat the host loop about tenfold already at 8
    jobs (chip_smoke.py's SF round timing; PERF.md)."""
    R = config.sf_restarts
    jobs = []  # (v, ins, outs, rows, cols, ab, bb, s, node_seed)
    result: dict[int, list] = {}
    for v in xs:
        ins, outs, a, b, s = _node_flows(g, v, edge_flows)
        if s <= 0:
            result[v] = []
            continue
        if len(ins) > MAXD or len(outs) > MAXD:
            result[v] = solve_node(g, v, config, edge_flows)
            continue
        result[v] = []
        node_seed = fnv1a(g.nodes[v].seq.encode()) ^ config.seed
        for rows, cols, ab, bb in node_blocks(a, b, config, s):
            jobs.append((v, ins, outs, rows, cols, ab, bb, s, node_seed))
    if not jobs:
        return result
    buf = np.zeros((len(jobs), 2 * MAXD + 1), np.int32)
    fbuf = buf[:, : 2 * MAXD].view(np.float32)
    sbuf = buf[:, 2 * MAXD :].view(np.uint32)
    for bi, (_v, _ins, _outs, _r, _c, ab, bb, _s, node_seed) in enumerate(jobs):
        fbuf[bi, : len(ab)] = ab
        fbuf[bi, MAXD : MAXD + len(bb)] = bb
        sbuf[bi, 0] = np.uint32(node_seed & _M32)
    F, picks = batched_greedy_packed(torch.from_numpy(buf).to(device), k_restarts=R)
    F, picks = F.cpu().numpy(), picks.cpu().numpy()
    for bi, (v, ins, outs, brows, bcols, _ab, _bb, s, _seed) in enumerate(jobs):
        thresh = np.float32(config.sf_min_flow_frac) * np.float32(s)
        for flat in picks[bi][picks[bi] >= 0]:  # the greedy's pick order
            i, j = divmod(int(flat), MAXD)
            if F[bi, i, j] >= thresh:
                result[v].append((ins[brows[i]], outs[bcols[j]], float(F[bi, i, j])))
    return result


def make_solver(device):
    """The sparse_flow solver hook bound to `device`."""
    return partial(solve_nodes_device, device=device)
