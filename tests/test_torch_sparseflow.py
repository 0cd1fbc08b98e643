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
