"""Port parity: the batched sparse-flow solver (tie hash, greedy max-min
restarts, restart selection, node-level solver) and the unpadded greedy
without restarts (batched_greedy, K29's plain version) against
shannon_tpu.ops.sparseflow on JAX-CPU and the oracle's host solver, and
the one deliberate departure from the reference (pairing order).

Tolerance: exact — float32 flow tensors bitwise equal, pairings equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.sparseflow import batched_greedy as ref_greedy
from shannon_tpu.ops.sparseflow import batched_greedy_packed as ref_batched
from shannon_tpu.ops.sparseflow import solve_nodes_device as ref_solve_nodes_device
from shannon_tpu.oracle.assemble import AssemblyResult, dedupe_and_filter
from shannon_tpu.oracle.nodegraph import Node, NodeGraph
from shannon_tpu.oracle.sparseflow import solve_node, tie_hash as oracle_tie_hash
from shannon_tpu.parallel.components import assemble_components as ref_assemble_components
from shannon_tpu.pipeline import assemble as ref_assemble
from shannon_tpu.sim import random_seq, sample_reads, simulate_transcripts
from shannon_tpu.utils.timing import StageTimer
from shannon_tpu_torch import pipeline as tpipe
from shannon_tpu_torch.components import device_components
from shannon_tpu_torch.ops import sparseflow as tsf

MAXD = tsf.MAXD


def test_tie_hash_matches_oracle():
    rng = np.random.default_rng(1)
    i = rng.integers(0, MAXD, 4096).astype(np.uint32)
    j = rng.integers(0, MAXD, 4096).astype(np.uint32)
    for seed in (0, 1, 123456789, 0xFFFFFFFF, 0x9E3779B9):
        want = oracle_tie_hash(i, j, seed)
        got = tsf.tie_hash(
            torch.from_numpy(i.astype(np.int64)), torch.from_numpy(j.astype(np.int64)),
            torch.tensor(seed),
        )
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _buffers(rng, B: int, integer: bool) -> np.ndarray:
    buf = np.zeros((B, 2 * MAXD + 1), np.int32)
    f = buf[:, : 2 * MAXD].view(np.float32)
    for r in range(B):
        M, N = int(rng.integers(1, MAXD + 1)), int(rng.integers(1, MAXD + 1))
        if integer:  # small integers: many exact ties
            a = rng.integers(1, 4, M).astype(np.float32)
            b = rng.integers(1, 4, N).astype(np.float32)
        else:
            a = rng.uniform(0.1, 50, M).astype(np.float32)
            b = rng.uniform(0.1, 50, N).astype(np.float32)
        s = np.float32(0.5) * (a.sum() + b.sum())
        f[r, :M] = a * (s / a.sum())
        f[r, MAXD : MAXD + N] = b * (s / b.sum())
    buf[:, 2 * MAXD] = rng.integers(0, 1 << 31, B, dtype=np.int64).astype(np.int32)
    return buf


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("restarts", [0, 4])
def test_batched_greedy_packed_matches_reference(integer, restarts):
    rng = np.random.default_rng(restarts + 10 * integer)
    buf = _buffers(rng, 96, integer)
    want = np.asarray(ref_batched(jnp.asarray(buf), k_restarts=restarts))
    got, picks = tsf.batched_greedy_packed(torch.from_numpy(buf), restarts)
    got = got.numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the picks name exactly the nonzero cells, each once
    for row, p in zip(got, picks.numpy()):
        p = p[p >= 0]
        assert len(set(p.tolist())) == len(p)
        assert sorted(p.tolist()) == np.flatnonzero(row.reshape(-1) > 0).tolist()


# The reference's own cases (tests/test_sparseflow_ops.py CASES).
GREEDY_CASES = [
    ([5.0, 3.0], [5.0, 3.0]),
    ([5.0, 3.0], [4.0, 4.0]),
    ([10.0, 1.0, 1.0], [6.0, 6.0]),
    ([2.0, 2.0, 2.0], [2.0, 2.0, 2.0]),
    ([7.5, 2.5], [2.5, 2.5, 5.0]),
    ([1e-8, 5.0], [5.0, 1e-8]),
    ([4.0], [1.0, 1.0, 1.0, 1.0]),
]


def _greedy_both(a, b, seeds, use_hash, max_steps=2 * MAXD):
    """(port F, reference F) of batched_greedy on the same jobs; seeds are
    given to the port as int64 uint32 values."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    seeds, use_hash = np.asarray(seeds, np.uint32), np.asarray(use_hash, bool)
    want = np.asarray(ref_greedy(jnp.asarray(a), jnp.asarray(b), jnp.asarray(seeds),
                                 jnp.asarray(use_hash), max_steps=max_steps))
    got = tsf.batched_greedy(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(seeds.astype(np.int64)),
                             torch.from_numpy(use_hash), max_steps)
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("case", range(len(GREEDY_CASES)))
@pytest.mark.parametrize("seed", [None, 1, 123456789])
def test_batched_greedy_matches_reference_on_its_cases(case, seed):
    """Each case padded to MAXD, as the reference's test pads it, and
    unpadded (M, N < MAXD)."""
    a, b = GREEDY_CASES[case]
    M, N = len(a), len(b)
    ap = np.zeros((1, MAXD), np.float32)
    bp = np.zeros((1, MAXD), np.float32)
    ap[0, :M], bp[0, :N] = a, b
    got, want = _greedy_both(ap, bp, [seed or 0], [seed is not None])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    got, want = _greedy_both([a], [b], [seed or 0], [seed is not None])
    assert got.shape == (1, M, N)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.sum() > 0


@pytest.mark.parametrize("shape", ["padded", "unpadded"])
@pytest.mark.parametrize("max_steps", [2 * MAXD, 3])
def test_batched_greedy_matches_reference_on_random_jobs(shape, max_steps):
    """30 random jobs as in the reference's test (integer margins scaled to
    equal totals), with a seed each and hashed ties on every other job;
    padded to MAXD or all at one unpadded M x N < MAXD; all steps or only
    the first 3."""
    rng = np.random.default_rng(max_steps)
    n_jobs = 30
    width = MAXD if shape == "padded" else None
    Mu, Nu = 5, 3
    a = np.zeros((n_jobs, width or Mu), np.float32)
    b = np.zeros((n_jobs, width or Nu), np.float32)
    for r in range(n_jobs):
        M = int(rng.integers(1, MAXD + 1)) if width else Mu
        N = int(rng.integers(1, MAXD + 1)) if width else Nu
        x = rng.integers(1, 20, size=M).astype(np.float32)
        y = rng.integers(1, 20, size=N).astype(np.float32)
        s = 0.5 * (x.sum() + y.sum())
        a[r, :M] = x * (s / x.sum())
        b[r, :N] = y * (s / y.sum())
    seeds = rng.integers(0, 2**32, n_jobs, dtype=np.int64).astype(np.uint32)
    use_hash = np.arange(n_jobs) % 2 == 1
    got, want = _greedy_both(a, b, seeds, use_hash, max_steps)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    nnz = (got > 0).sum(axis=(1, 2))
    assert nnz.max() > 3 if max_steps > 3 else nnz.max() == 3


def test_batched_greedy_takes_int32_seed_bits():
    """A seed above 2^31 given as its int32 bit pattern is the same seed."""
    rng = np.random.default_rng(5)
    a = rng.integers(1, 4, (16, MAXD)).astype(np.float32)
    b = a[:, ::-1].copy()
    seeds = np.full(16, 0xF0000001, np.uint32)
    use_hash = torch.ones(16, dtype=torch.bool)
    as_int64 = tsf.batched_greedy(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(seeds.astype(np.int64)), use_hash)
    as_int32 = tsf.batched_greedy(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(seeds.view(np.int32)), use_hash)
    assert torch.equal(as_int64, as_int32)


def test_restart_rows_feed_batched_greedy_to_k6():
    """batched_greedy on restart_rows' rows, then best_restart, is K6's
    plain version: the unpacked greedy and the packed solver agree."""
    buf = torch.from_numpy(_buffers(np.random.default_rng(3), 64, integer=True))
    R = 4
    F = tsf.batched_greedy(*tsf.restart_rows(buf, R)).reshape(64, R + 1, MAXD, MAXD)
    best = tsf.best_restart(F)
    want, _picks = tsf.batched_greedy_packed(buf, R)
    assert torch.equal(F[torch.arange(64), best], want)
    assert (best > 0).any()


def degenerate_buffers(rng, B: int) -> np.ndarray:
    """Jobs the greedy finds hardest to break ties on: all margins equal
    (every cell ties at every step), zero margins (nothing to pair, as the
    reference's padding rows), one side zero, and margins at the eps
    threshold."""
    buf = np.zeros((B, 2 * MAXD + 1), np.int32)
    f = buf[:, : 2 * MAXD].view(np.float32)
    for r in range(B):
        M, N = int(rng.integers(1, MAXD + 1)), int(rng.integers(1, MAXD + 1))
        kind = r % 4
        if kind == 0:  # all ties
            f[r, :M] = 2.0
            f[r, MAXD : MAXD + N] = 2.0 * M / N
        elif kind == 2:  # one side zero
            f[r, :M] = rng.integers(1, 5, M)
        elif kind == 3:  # tiny margins next to a large one
            f[r, :M] = 1e-7
            f[r, 0] = 3.0
            f[r, MAXD : MAXD + N] = np.float32(3.0 + 1e-7 * (M - 1)) / N
    buf[:, 2 * MAXD] = rng.integers(0, 1 << 31, B, dtype=np.int64).astype(np.int32)
    return buf


@pytest.mark.parametrize("restarts", [0, 4])
def test_batched_greedy_packed_degenerate_margins_match_reference(restarts):
    buf = degenerate_buffers(np.random.default_rng(restarts), 64)
    want = np.asarray(ref_batched(jnp.asarray(buf), k_restarts=restarts))
    got, picks = tsf.batched_greedy_packed(torch.from_numpy(buf), restarts)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert (picks[1::4] == -1).all()  # zero margins pair nothing
    assert (picks[0::4, 0] >= 0).all()


@pytest.mark.parametrize("restarts", [0, 1, 4, 40])
@pytest.mark.parametrize("max_steps", [4, 16])
def test_batched_greedy_packed_plain_matches_reference_at_any_restarts(restarts, max_steps):
    """K6's plain twin against the reference on the degenerate buffers, at
    restart counts below, at and above a block's warps of the kernel (8)
    and with the greedy cut short; its picks name exactly the flow
    tensor's nonzero cells, each once."""
    buf = degenerate_buffers(np.random.default_rng(restarts + max_steps), 48)
    want = np.asarray(ref_batched(jnp.asarray(buf), k_restarts=restarts, max_steps=max_steps))
    got, picks = tsf.batched_greedy_packed_plain(torch.from_numpy(buf), restarts, max_steps)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert picks.shape == (48, max_steps) and picks.dtype == torch.int64
    for row, p in zip(got.numpy(), picks.numpy()):
        p = p[p >= 0]
        assert sorted(p.tolist()) == np.flatnonzero(row.reshape(-1) > 0).tolist()


def test_batched_greedy_packed_plain_takes_no_job():
    F, picks = tsf.batched_greedy_packed_plain(torch.zeros((0, 2 * MAXD + 1), dtype=torch.int32),
                                               4, 5)
    assert F.shape == (0, MAXD, MAXD) and picks.shape == (0, 5) and picks.dtype == torch.int64


# ---- K6's warp design, transcribed ---------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)


def _tie_hash_np(i, j, seed):
    """The uint32 tie hash on uint64 arrays, reduced mod 2^32 after each
    multiply (csrc/sparseflow.cu tie_hash)."""
    h = ((i * np.uint64(2654435761)) & _M32) ^ ((j * np.uint64(40503)) & _M32) ^ seed
    h = ((h ^ (h >> np.uint64(16))) * np.uint64(2246822519)) & _M32
    return h ^ (h >> np.uint64(13))


def _sf_key(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def _sf_unkey(k: np.ndarray) -> np.ndarray:
    u = np.where(k & np.uint32(0x80000000), k & np.uint32(0x7FFFFFFF), ~k)
    return u.astype(np.uint32).view(np.float32)


def k6_transcription(buf: np.ndarray, k_restarts: int, max_steps: int):
    """csrc/sparseflow.cu sf_greedy_kernel in numpy: a row of 32 lanes a
    (job, restart), lane l holding cells 2l and 2l + 1 (row l // 4) and
    only the margins a[row], b[c0], b[c1]; a step is the max of the lanes'
    order-preserving keys, the ties' ballots, with hashed ties where more
    than one cell ties the max of the tied cells' hashes, and the lowest
    set bit; then each warp of a
    job (W = min(K, 8), restarts w, w + W, ...) keeps its least (count,
    mask), earliest first, and the least (count, mask, restart) of the
    job's warps wins.  Returns (F [B, 8, 8] float32, picks [B, max_steps]
    int64)."""
    B, K = buf.shape[0], k_restarts + 1
    f = buf[:, : 2 * MAXD].view(np.float32)
    a, b = f[:, :MAXD], f[:, MAXD:]
    sa, sb = a[:, 0].copy(), b[:, 0].copy()
    for c in range(1, MAXD):
        sa, sb = sa + a[:, c], sb + b[:, c]
    eps = np.float32(1e-6) * np.maximum(np.maximum(sa, sb), np.float32(1.0))
    lane = np.arange(32)
    row, c0 = lane >> 2, 2 * (lane & 3)
    job = np.repeat(np.arange(B), K)
    r = np.tile(np.arange(K), B)
    ar, b0, b1 = a[job][:, row], b[job][:, c0], b[job][:, c0 + 1]
    node_seed = buf[:, 2 * MAXD].view(np.uint32).astype(np.uint64)[job]
    seed = np.where(r > 0, (node_seed + r.astype(np.uint64)) & _M32, np.uint64(0))[:, None]
    h0 = _tie_hash_np(row.astype(np.uint64), c0.astype(np.uint64), seed)
    h1 = _tie_hash_np(row.astype(np.uint64), (c0 + 1).astype(np.uint64), seed)
    hashed = (r > 0)[:, None]
    R = B * K
    f0 = np.zeros((R, 32), np.float32)
    f1 = np.zeros((R, 32), np.float32)
    picks = np.full((R, max_steps), -1, np.int64)
    mask = np.zeros(R, np.uint64)
    n = np.zeros(R, np.int64)
    live = np.ones(R, bool)
    rows = np.arange(R)
    for step in range(max_steps):
        m0, m1 = np.minimum(ar, b0), np.minimum(ar, b1)
        best = _sf_unkey(_sf_key(np.maximum(m0, m1)).max(axis=1))
        live &= best > eps[job]
        t0, t1 = m0 >= best[:, None], m1 >= best[:, None]
        # the hash only where more than one cell ties
        by_hash = hashed & ((t0.sum(axis=1) + t1.sum(axis=1)) > 1)[:, None]
        hm = np.maximum(np.where(t0, h0, 0), np.where(t1, h1, 0)).max(axis=1)[:, None]
        t0 = np.where(by_hash, t0 & (h0 == hm), t0)
        t1 = np.where(by_hash, t1 & (h1 == hm), t1)
        L = np.argmax(t0 | t1, axis=1)
        flat = 2 * L + np.where(t0[rows, L], 0, 1)
        pi, pj = (flat >> 3)[:, None], (flat & 7)[:, None]
        bst, on = best[:, None], live[:, None]
        ar = np.where(on & (row == pi), ar - bst, ar)
        b0 = np.where(on & (c0 == pj), b0 - bst, b0)
        b1 = np.where(on & (c0 + 1 == pj), b1 - bst, b1)
        f0 = np.where(on & (flat[:, None] == 2 * lane), bst, f0)
        f1 = np.where(on & (flat[:, None] == 2 * lane + 1), bst, f1)
        picks[:, step] = np.where(live, flat, -1)
        mask |= np.where(live, np.uint64(1) << flat.astype(np.uint64), np.uint64(0))
        n += live
    W = min(K, 8)
    win = np.zeros(B, np.int64)
    for j in range(B):
        posts = []
        for w in range(W):  # each warp's best of its restarts, earliest first
            mine = [(int(n[j * K + x]), int(mask[j * K + x]), x) for x in range(w, K, W)]
            posts.append(min(mine))
        win[j] = j * K + min(posts)[2]
    F = np.stack([f0[win], f1[win]], axis=2).reshape(B, MAXD, MAXD)
    return F, picks[win]


TRANSCRIPTION_BUFFERS = {
    "degenerate": lambda seed: degenerate_buffers(np.random.default_rng(seed), 40),
    "integer": lambda seed: _buffers(np.random.default_rng(seed), 40, integer=True),
    "real": lambda seed: _buffers(np.random.default_rng(seed), 40, integer=False),
}


@pytest.mark.parametrize("kind", list(TRANSCRIPTION_BUFFERS))
@pytest.mark.parametrize("restarts", [0, 1, 4, 8, 40])
@pytest.mark.parametrize("max_steps", [1, 4, 16])
def test_k6_transcription_matches_plain(kind, restarts, max_steps):
    """The kernel's warp step and its selection by warps, in numpy, give
    the plain twin's flows bitwise and its picks (and so the reference's,
    which the plain twin is held to)."""
    buf = TRANSCRIPTION_BUFFERS[kind](restarts * 16 + max_steps)
    F, picks = k6_transcription(buf, restarts, max_steps)
    want, want_picks = tsf.batched_greedy_packed_plain(torch.from_numpy(buf), restarts,
                                                       max_steps)
    np.testing.assert_array_equal(F.view(np.int32), want.numpy().view(np.int32))
    np.testing.assert_array_equal(picks, want_picks.numpy())


def k29_transcription(a: np.ndarray, b: np.ndarray, seeds: np.ndarray, use_hash: np.ndarray,
                      max_steps: int) -> np.ndarray:
    """csrc/sparseflow.cu sf_jobs_kernel in numpy: a warp a row, lane l
    holding cells 2l and 2l + 1 of the zero-padded 8 x 8 grid (row l // 4)
    and only the margins they touch; K6's step (sf_best, sf_pick): the max
    of the lanes' order-preserving keys, a ballot a cell of the lane, with
    hashed ties where more than one cell ties the max of the tied cells'
    hashes, and the lowest set bit, then that lane's first tied cell; a
    stopped row changes nothing.  Returns F [B, M, N] float32 at stride
    N."""
    B, M = a.shape
    N = b.shape[1]
    C, G = 2, 32  # cells a lane, lanes a row
    ap = np.zeros((B, MAXD), np.float32)
    bp = np.zeros((B, MAXD), np.float32)
    ap[:, :M], bp[:, :N] = a, b
    sa, sb = ap[:, 0].copy(), bp[:, 0].copy()
    for c in range(1, MAXD):
        sa, sb = sa + ap[:, c], sb + bp[:, c]
    eps = np.float32(1e-6) * np.maximum(np.maximum(sa, sb), np.float32(1.0))
    gl = np.arange(G)
    row, c0 = (gl * C) >> 3, (gl * C) & (MAXD - 1)
    col = c0[:, None] + np.arange(C)  # [G, C]
    cell = gl[:, None] * C + np.arange(C)
    ar, bm = ap[:, row], bp[:, col]  # [B, G], [B, G, C]
    seed = (seeds.astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)[:, None, None]
    h = _tie_hash_np(np.broadcast_to(row[:, None], (G, C)).astype(np.uint64),
                     col.astype(np.uint64), seed)
    h = np.where(use_hash[:, None, None], h, np.uint64(0))
    f = np.zeros((B, G, C), np.float32)
    rows = np.arange(B)
    for _step in range(max_steps):
        m = np.minimum(ar[:, :, None], bm)
        best = _sf_unkey(_sf_key(m.max(axis=2)).max(axis=1))
        active = best > eps
        t = m >= best[:, None, None]
        by_hash = use_hash & (t.sum(axis=(1, 2)) > 1)
        hm = np.where(t, h, np.uint64(0)).max(axis=(1, 2))
        e = np.where(by_hash[:, None, None], t & (h == hm[:, None, None]), t)
        L = np.argmax(e.any(axis=2), axis=1)
        flat = L * C + np.argmax(e[rows, L], axis=1)
        pi, pj = flat >> 3, flat & (MAXD - 1)
        bst, on = best[:, None], active[:, None]
        ar = np.where(on & (row[None] == pi[:, None]), ar - bst, ar)
        on3, bst3 = active[:, None, None], best[:, None, None]
        bm = np.where(on3 & (col[None] == pj[:, None, None]), bm - bst3, bm)
        f = np.where(on3 & (cell[None] == flat[:, None, None]), bst3, f)
    return f.reshape(B, MAXD, MAXD)[:, :M, :N]


def _greedy_rows(kind: str, seed: int, M: int, N: int, B: int = 48):
    """K29's rows at one M x N: all cells tied, small integers (many ties),
    real margins, or rows mixing every smaller real size (zero margins past
    it, some rows all zero); a uint32 seed each, hashed ties on every other
    row."""
    rng = np.random.default_rng(seed)
    a = np.zeros((B, M), np.float32)
    b = np.zeros((B, N), np.float32)
    for r in range(B):
        m, n = (int(rng.integers(1, M + 1)), int(rng.integers(1, N + 1))) if kind == "mixed" \
            else (M, N)
        if kind == "ties":
            x, y = np.full(m, 2.0, np.float32), np.full(n, np.float32(2.0 * m / n))
        elif kind == "integer":
            x, y = rng.integers(1, 4, m).astype(np.float32), rng.integers(1, 4, n).astype(np.float32)
        elif kind == "mixed" and r % 5 == 0:
            continue
        else:
            x, y = rng.uniform(0.1, 50, m).astype(np.float32), rng.uniform(0.1, 50, n).astype(np.float32)
        a[r, :m], b[r, :n] = x, y
    seeds = rng.integers(0, 1 << 32, B, dtype=np.int64)
    return a, b, seeds, np.arange(B) % 2 == 1


@pytest.mark.parametrize("kind", ["ties", "integer", "real", "mixed"])
@pytest.mark.parametrize("shape", [(8, 8), (3, 5), (1, 8)])
@pytest.mark.parametrize("max_steps", [1, 4, 16])
def test_k29_transcription_matches_plain(kind, shape, max_steps):
    """K29's warp step, in numpy, gives the plain twin's flows bitwise and
    the reference's batched_greedy's, on rows of every real size below M x
    N too."""
    a, b, seeds, use_hash = _greedy_rows(kind, 100 * shape[0] + 10 * shape[1] + max_steps,
                                         *shape)
    got = k29_transcription(a, b, seeds, use_hash, max_steps)
    want = tsf.batched_greedy_plain(torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(seeds), torch.from_numpy(use_hash), max_steps)
    ref = np.asarray(ref_greedy(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(seeds.astype(np.uint32)), jnp.asarray(use_hash),
                                max_steps=max_steps))
    assert got.shape == tuple(want.shape) == ref.shape == (48, *shape)
    np.testing.assert_array_equal(got.view(np.int32), want.numpy().view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert (got > 0).any()


def test_sf_key_orders_every_finite_float():
    """The kernel's uint32 key of a float keeps the order of any finite
    floats, zeros of both signs, subnormals and the extremes included, and
    decodes back to the same bits."""
    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * np.float32(1e3),
        np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 3.4e38, -3.4e38, 1e-6, 2.0],
                 np.float32),
    ])
    k = _sf_key(x)
    # sorted by key, the floats do not fall (-0.0 sorts just below +0.0)
    assert (np.diff(x[np.argsort(k)].astype(np.float64)) >= 0).all()
    assert len(np.unique(k)) == len(np.unique(x.view(np.uint32)))
    np.testing.assert_array_equal(_sf_unkey(k).view(np.uint32), x.view(np.uint32))


def _x_node_graph(rng, n_x: int) -> tuple[NodeGraph, list[int]]:
    """n_x X-nodes u0,u1 -> v -> w0,w1 with varied, often tied abundances."""
    nodes: list[Node] = []
    xs = []
    for _ in range(n_x):
        ab = [float(rng.integers(1, 8)) for _ in range(4)]
        for j in range(2):
            nodes.append(Node(seq=random_seq(rng, 30), abundance=ab[j], klen=10))
        nodes.append(Node(seq=random_seq(rng, 30), abundance=ab[0] + ab[1], klen=10))
        for j in range(2):
            nodes.append(Node(seq=random_seq(rng, 30), abundance=ab[2 + j], klen=10))
        xs.append(len(nodes) - 3)
    g = NodeGraph(k=21, nodes=nodes)
    for v in xs:
        g.add_edge(v - 2, v)
        g.add_edge(v - 1, v)
        g.add_edge(v, v + 1)
        g.add_edge(v, v + 2)
    return g, xs


@pytest.mark.parametrize("n_x", [1, 5, 40])
def test_solve_nodes_device_matches_host_solver(n_x):
    """Rounds of every size take the batched solver."""
    g, xs = _x_node_graph(np.random.default_rng(n_x), n_x)
    cfg = AssemblyConfig(k=21)
    got = tsf.solve_nodes_device(g, xs, cfg, device=torch.device("cpu"))
    assert sorted(got) == sorted(xs)
    for v in xs:
        assert got[v] == solve_node(g, v, cfg), v  # order included


def test_small_rounds_take_the_batched_solver(monkeypatch):
    """The reference solves rounds of at most 32 jobs on the host; the
    port sends every round to the batched solver."""
    g, xs = _x_node_graph(np.random.default_rng(8), 8)
    cfg = AssemblyConfig(k=21)
    calls = []
    plain = tsf.batched_greedy_packed_plain
    monkeypatch.setattr(tsf, "batched_greedy_packed_plain",
                        lambda buf, *a: calls.append(len(buf)) or plain(buf, *a))
    got = tsf.solve_nodes_device(g, xs, cfg, device=torch.device("cpu"))
    assert len(calls) == 1 and 8 <= calls[0] <= 32  # one round, one job per block
    for v in xs:
        assert got[v] == solve_node(g, v, cfg), v


def test_solver_hook_is_bound_to_device():
    g, xs = _x_node_graph(np.random.default_rng(3), 36)
    cfg = AssemblyConfig(k=21, sf_restarts=2)
    solver = tsf.make_solver(torch.device("cpu"))
    got = solver(g, xs, cfg, None)
    for v in xs:
        assert got[v] == solve_node(g, v, cfg)


# The one place the port departs from shannon_tpu.ops.sparseflow: the
# reference's batched solver returns a node's pairings in row-major cell
# order, the oracle's solve_node (and the port) in the greedy's pick order.
# sparse_flow numbers the split copies in pairing order, so the reference's
# order can change the transcripts.


def test_pairing_order_departs_from_reference_node_level():
    """Same pairings as sets; the reference reorders some nodes' lists,
    the port keeps the oracle's order."""
    g, xs = _x_node_graph(np.random.default_rng(40), 40)
    cfg = AssemblyConfig(k=21)
    ref = ref_solve_nodes_device(g, xs, cfg)
    got = tsf.solve_nodes_device(g, xs, cfg, device=torch.device("cpu"))
    reordered = 0
    for v in xs:
        want = solve_node(g, v, cfg)
        assert sorted(ref[v]) == sorted(want), v
        assert got[v] == want, v
        reordered += ref[v] != want
    assert reordered > 0


def _subsampled_dataset(seed: int, n_tr: int = 200, n_reads: int = 3000):
    """Like the smoke's parity subset: a random subset of reads from many
    1,500 bp transcripts at log-normal abundance, so SF rounds carry more
    than 32 jobs and take the batched solver."""
    rng = np.random.default_rng(seed)
    abund = np.exp(rng.normal(0, 1, n_tr))
    truth = simulate_transcripts(rng, n=n_tr, length=1500)
    reads = sample_reads(
        rng, truth, abundances=(abund / abund.mean()).tolist(), coverage=4,
        read_length=100, error_rate=0.01,
    )
    return [reads[i] for i in np.sort(rng.choice(len(reads), n_reads, replace=False))]


def test_pairing_order_departs_from_reference_in_transcripts():
    """On one graph and one set of read evidence, the back half with the
    reference's batched solver gives other transcripts than with the
    oracle's host solver; with the port's solver it gives the oracle's.
    The port's entry point and the reference's device path each give the
    transcripts of their own solver."""
    reads = _subsampled_dataset(2)
    cfg = AssemblyConfig(kmer_capacity=1 << 18, n_devices=1)
    cpu = torch.device("cpu")
    timer = StageTimer(echo=False)
    batch = pack_reads(reads, pad_length=cfg.read_pad_length)
    cgraph, _, ca = tpipe._graph_device(batch, cfg, cpu, timer)
    comps = device_components(ca)
    evidence = tpipe._thread_device(batch, ca, cgraph, cfg, cpu, timer)

    def back_half(solver):
        g = NodeGraph.from_contig_graph(cgraph)
        g.set_paths_flat(*evidence)
        transcripts, *_ = ref_assemble_components(g, comps, cfg, solver=solver)
        final = dedupe_and_filter(transcripts, cfg)
        return AssemblyResult(transcripts=final, stats={}).canonical_set()

    oracle = back_half(None)
    reference = back_half(ref_solve_nodes_device)
    assert reference != oracle
    assert back_half(tsf.make_solver(cpu)) == oracle
    assert tpipe.assemble(reads, cfg, device=cpu).canonical_set() == oracle
    assert ref_assemble(reads, cfg, backend="device").canonical_set() == reference
