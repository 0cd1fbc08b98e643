# Copied from shannon_tpu/oracle/sparseflow.py; equal to it apart from this line and the package name in imports.
"""Oracle sparse flow — per-node sparsest flow decomposition (reference
stage 4 SF; SURVEY.md §3.1 'Sparse flow', §4.3).

Spec (binding for the TPU pipeline):

  * For every remaining X-node v (indeg>1, outdeg>1 after MB), take
    in-flows a_i = abund(u_i) / outdeg(u_i) and out-flows
    b_j = abund(w_j) / indeg(w_j) (a neighbor's abundance is divided
    evenly among its parallel branch directions — the only local
    estimate available without resolved global flow), then rescale both
    sides to a common total s = (Σa + Σb)/2.

  * **Decomposition**: find a sparse nonnegative matrix F with row sums a
    and column sums b.  Solver: greedy max-min — repeatedly pick the
    (i, j) maximizing min(a_i, b_j), assign f_ij = min(a_i, b_j), deduct;
    stop when residuals vanish.  This yields <= m+n-1 pairings and
    recovers the exact sparsest solution whenever abundances are
    well-separated (the information-optimality regime of the paper).

  * **Determinism / portability** (SURVEY.md §8 hard part 4): ties in
    the max-min choice are broken by an arithmetic uint32 hash
    h(i, j, seed) — NOT a host RNG — so the batched device solver
    reproduces the oracle bit-for-bit.  `sf_restarts` restarts vary the
    seed (seed_r = mix(config.seed, fnv1a(node.seq), r)); the sparsest
    result wins, ties between restarts broken by lexicographically
    smallest pairing set.  Restart 0 uses plain smallest-(i, j) ties.

  * Pairings with f_ij < sf_min_flow_frac * s are dropped.  v then
    splits into one copy per surviving pairing exactly as in MB, with
    abundance f_ij (per-k-mer), and read paths reroute the same way.
    Iterate with condensation until no X-nodes remain (or max rounds).
"""

from __future__ import annotations

import numpy as np

from shannon_tpu_torch.config import AssemblyConfig
from shannon_tpu_torch.oracle.nodegraph import NodeGraph

SF_MAXD = 8  # padded margin size per side of the batched device solver
# (ops/sparseflow.MAXD re-exports this); the restart-selection bitmask
# uses stride SF_MAXD so host and device compute identical keys and the
# device side vectorizes over the fixed [MAXD, MAXD] flow tensors


def fnv1a(data: bytes) -> int:
    h = 2166136261
    for byte in data:
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h


def tie_hash(i: np.ndarray, j: np.ndarray, seed: int) -> np.ndarray:
    """Portable uint32 mixing hash used for tie-breaking (same formula
    on device)."""
    h = (
        np.uint32(i) * np.uint32(2654435761)
        ^ np.uint32(j) * np.uint32(40503)
        ^ np.uint32(seed)
    )
    h = np.uint32(h ^ (h >> np.uint32(16))) * np.uint32(2246822519)
    return np.uint32(h ^ (h >> np.uint32(13)))


def greedy_decompose(
    a: np.ndarray, b: np.ndarray, seed: int | None = None
) -> list[tuple[int, int, float]]:
    """Greedy max-min transport decomposition of margins (a, b) in
    float32.  seed=None: ties -> smallest flat (i, j); else ties ->
    maximum tie_hash(i, j, seed)."""
    a = a.astype(np.float32).copy()
    b = b.astype(np.float32).copy()
    eps = np.float32(1e-6) * max(a.sum(), b.sum(), np.float32(1.0))
    out: list[tuple[int, int, float]] = []
    for _ in range(len(a) + len(b)):
        m = np.minimum.outer(a, b).astype(np.float32)  # m[i,j]=min(a_i,b_j)
        best = m.max()
        if best <= eps:
            break
        ties = m >= best  # float32 exact max comparison
        if seed is None:
            flat = int(np.argmax(ties))  # first True = smallest (i, j)
        else:
            ii, jj = np.nonzero(ties)
            h = tie_hash(ii.astype(np.uint32), jj.astype(np.uint32), seed)
            # max hash wins; residual hash ties -> smallest flat (i, j)
            cand = np.nonzero(h == h.max())[0]
            flats = ii[cand] * len(b) + jj[cand]
            flat = int(flats.min())
        i, j = divmod(flat, len(b))
        f = np.float32(min(a[i], b[j]))
        out.append((int(i), int(j), float(f)))
        a[i] -= f
        b[j] -= f
    return out


def block_decompose(
    a: np.ndarray, b: np.ndarray, tol: float
) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
    """Maximum-cardinality block decomposition of transport margins:
    partition rows and columns into groups with |sum(rows) - sum(cols)|
    <= tol per group, maximizing the number of groups.

    This attains the LP's sparsity target EXACTLY: any feasible flow's
    support graph decomposes into connected components whose row/column
    sums balance, and a component on (p rows, q cols) needs >= p+q-1
    nonzeros — so min #nonzeros = m + n - (max #blocks), and a greedy
    max-min tree solution per block achieves it.  The reference solves
    min Σ|f| with ℓ1 reweighting toward the same sparsest support
    (SURVEY.md §3.1 'Sparse flow'); exhaustive decomposition is
    feasible here because dBG node degrees are tiny (<= 8 per side)
    and, unlike IRLS, it is bit-portable across backends (pure float64
    sums + comparisons, no matrix solves).

    Deterministic: maximize #blocks, then minimize total imbalance,
    then lexicographically smallest (row-mask, col-mask) sequence.
    Returns [] when no decomposition within tolerance exists beyond the
    trivial whole-node block (callers then keep plain greedy) or when
    m + n is too large to enumerate.
    """
    m, n = len(a), len(b)
    if m + n > 12 or m <= 1 or n <= 1:
        return []  # a single row/col admits only the trivial block
    af = [float(x) for x in a]
    bf = [float(x) for x in b]
    if m == 2 and n == 2:
        # closed form for the dominant dBG case (the DP's exact result)
        d_id = max(abs(af[0] - bf[0]), abs(af[1] - bf[1]))
        s_id = abs(af[0] - bf[0]) + abs(af[1] - bf[1])
        d_cr = max(abs(af[0] - bf[1]), abs(af[1] - bf[0]))
        s_cr = abs(af[0] - bf[1]) + abs(af[1] - bf[0])
        ok_id, ok_cr = d_id <= tol, d_cr <= tol
        if ok_id and (not ok_cr or s_id <= s_cr):
            return [((0,), (0,)), ((1,), (1,))]
        if ok_cr:
            return [((0,), (1,)), ((1,), (0,))]
        return []
    sum_a = {mask: sum(af[i] for i in range(m) if mask >> i & 1)
             for mask in range(1 << m)}
    sum_b = {mask: sum(bf[j] for j in range(n) if mask >> j & 1)
             for mask in range(1 << n)}
    from functools import lru_cache

    @lru_cache(maxsize=None)
    def best(mr: int, mc: int):
        """-> (#blocks, -total_imbalance... ) best value + block list,
        as (blocks, imbalance, seq) with seq the chosen (sR, sC) list;
        None if infeasible."""
        if mr == 0 and mc == 0:
            return (0, 0.0, ())
        if mr == 0 or mc == 0:
            return None
        low = mr & -mr  # lowest remaining row anchors the block
        rest_r = mr ^ low
        out = None
        sub_r = rest_r
        while True:  # enumerate submasks of rest_r (ascending by loop order)
            s_rows = low | sub_r
            sa = sum_a[s_rows]
            sub_c = mc
            while sub_c:  # nonempty submasks of mc
                imb = abs(sa - sum_b[sub_c])
                if imb <= tol:
                    tail = best(mr ^ s_rows, mc ^ sub_c)
                    if tail is not None:
                        cand = (
                            tail[0] + 1,
                            tail[1] + imb,
                            ((s_rows, sub_c),) + tail[2],
                        )
                        if (
                            out is None
                            or cand[0] > out[0]
                            or (cand[0] == out[0] and cand[1] < out[1])
                            or (cand[0] == out[0] and cand[1] == out[1]
                                and cand[2] < out[2])
                        ):
                            out = cand
                sub_c = (sub_c - 1) & mc
            if sub_r == 0:
                break
            sub_r = (sub_r - 1) & rest_r
        return out

    full = (1 << m) - 1, (1 << n) - 1
    res = best(*full)
    if res is None or res[0] <= 1:
        return []
    blocks = []
    for s_rows, s_cols in res[2]:
        rows = tuple(i for i in range(m) if s_rows >> i & 1)
        cols = tuple(j for j in range(n) if s_cols >> j & 1)
        blocks.append((rows, cols))
    return blocks


def edge_flows_from_paths(g: NodeGraph) -> dict[tuple[int, int], int]:
    """Read-crossing counts per edge: every consecutive (a, b) in every
    evidence path is one observed traversal.  The most direct junction
    flow estimate available (reference: copy counts maintained through
    every split — SURVEY.md §3.1)."""
    flows: dict[tuple[int, int], int] = {}
    for p, w in zip(g.paths, g.path_weight_list()):
        for i in range(len(p) - 1):
            e = (p[i], p[i + 1])
            flows[e] = flows.get(e, 0) + w
    return flows


def _node_flows(
    g: NodeGraph,
    v: int,
    edge_flows: dict[tuple[int, int], int] | None = None,
) -> tuple[list[int], list[int], np.ndarray, np.ndarray, float]:
    """SF margins for X-node v.  When every in- and out-edge of v has
    read-crossing support, the margins are those crossing counts
    (direct evidence); otherwise fall back to neighbor abundance split
    evenly over its parallel branches (the only local estimate).
    All float32 (device parity)."""
    node = g.nodes[v]
    ins = sorted(node.inc)
    outs = sorted(node.out)
    a = b = None
    if edge_flows is not None:
        fa = [edge_flows.get((u, v), 0) for u in ins]
        fb = [edge_flows.get((v, w), 0) for w in outs]
        if all(x > 0 for x in fa) and all(x > 0 for x in fb):
            a = np.array(fa, dtype=np.float32)
            b = np.array(fb, dtype=np.float32)
    if a is None:
        a = np.array(
            [
                np.float32(g.nodes[u].abundance)
                / np.float32(max(len(g.nodes[u].out), 1))
                for u in ins
            ],
            dtype=np.float32,
        )
        b = np.array(
            [
                np.float32(g.nodes[w].abundance)
                / np.float32(max(len(g.nodes[w].inc), 1))
                for w in outs
            ],
            dtype=np.float32,
        )
    s = np.float32(0.5) * (a.sum() + b.sum())
    if a.sum() > 0:
        a = a * (s / a.sum())
    if b.sum() > 0:
        b = b * (s / b.sum())
    return ins, outs, a, b, float(s)


def node_blocks(
    a: np.ndarray, b: np.ndarray, config: AssemblyConfig, s: float
) -> list[tuple[tuple[int, ...], tuple[int, ...], np.ndarray, np.ndarray]]:
    """Block plan for one node's margins: the sparsest-decomposition
    blocks (block_decompose, tolerance sf_block_tol * s) with per-block
    margins rebalanced to a common total (float32, mirroring
    _node_flows), or the trivial whole-node block when no decomposition
    exists / refinement is disabled.  Shared by the host and batched
    device solvers so both produce identical pairings."""
    m, n = len(a), len(b)
    trivial = [(tuple(range(m)), tuple(range(n)), a, b)]
    if config.sf_block_tol <= 0.0:
        return trivial
    tol = float(np.float32(config.sf_block_tol) * np.float32(s))
    blocks = block_decompose(a, b, tol)
    if not blocks:
        return trivial
    out = []
    for rows, cols in blocks:
        ab = a[list(rows)].astype(np.float32)
        bb = b[list(cols)].astype(np.float32)
        sb = np.float32(0.5) * (ab.sum() + bb.sum())
        if ab.sum() > 0:
            ab = ab * (sb / ab.sum())
        if bb.sum() > 0:
            bb = bb * (sb / bb.sum())
        out.append((rows, cols, ab, bb))
    return out


def _best_of_restarts(
    ab: np.ndarray, bb: np.ndarray, node_seed: int, config: AssemblyConfig
) -> list[tuple[int, int, float]]:
    """Greedy + seeded restarts on one margin pair; selection key =
    (pairing count, support-bitmask) — bitmask bit i*SF_MAXD+j (the
    device solver's fixed stride, so both solvers pick identically)."""
    best = greedy_decompose(ab, bb, seed=None)

    def key(sol: list[tuple[int, int, float]]) -> tuple:
        mask = 0
        for i, j, _ in sol:
            mask |= 1 << (i * SF_MAXD + j)
        return (len(sol), mask)

    for r in range(config.sf_restarts):
        cand = greedy_decompose(ab, bb, seed=(node_seed + r + 1) & 0xFFFFFFFF)
        if key(cand) < key(best):
            best = cand
    return best


def solve_node(
    g: NodeGraph, v: int, config: AssemblyConfig, edge_flows=None
) -> list[tuple[int, int, float]]:
    """Sparse-flow pairings for X-node v: [(in_node, out_node, flow)].
    Exact-sparsest: greedy max-min within each balanced block of the
    margins (node_blocks); greedy alone is a basic (tree) solution and
    can overshoot the sparsest support when its max-min pick crosses a
    block boundary (tested known answer)."""
    ins, outs, a, b, s = _node_flows(g, v, edge_flows)
    if s <= 0:
        return []
    node_seed = fnv1a(g.nodes[v].seq.encode()) ^ config.seed
    thresh = np.float32(config.sf_min_flow_frac) * np.float32(s)
    result: list[tuple[int, int, float]] = []
    for rows, cols, ab, bb in node_blocks(a, b, config, s):
        for i, j, f in _best_of_restarts(ab, bb, node_seed, config):
            if f >= thresh:
                result.append((ins[rows[i]], outs[cols[j]], float(f)))
    return result


def sparse_flow(
    g: NodeGraph,
    config: AssemblyConfig,
    max_rounds: int = 16,
    solver=None,
) -> int:
    """Resolve all remaining X-nodes in place; returns #nodes split.

    solver(g, xs, config) -> {node: pairings} decomposes a round's
    X-nodes; default is the per-node host solver, the device backend
    passes the batched kernel (ops/sparseflow.solve_nodes_device) —
    both produce identical pairings (tested)."""
    from shannon_tpu_torch.oracle.multibridge import _evidence_at, filter_noise_pairs

    total = 0
    for _ in range(max_rounds):
        g.condense()
        xs = g.x_nodes()
        if not xs:
            break
        flows = edge_flows_from_paths(g) if config.sf_use_read_flows else None
        if solver is None:
            solved = {v: solve_node(g, v, config, flows) for v in xs}
        else:
            solved = solver(g, xs, config, flows)
        # evidence union (round 5, recall-first): the margins are LOCAL
        # abundance estimates, and at noisy shared-exon nodes the
        # decomposition's pairing choice deletes continuations that
        # reads DIRECTLY witnessed (splicing gate: 12 of 14 resolution
        # failures were SF dropping read-witnessed pairings the margins
        # mis-assigned).  Every above-noise-floor evidence pairing is
        # therefore added to the split with its read-crossing weight as
        # flow — the LP refines abundances, it must never contradict
        # direct observation.
        ev = _evidence_at(g)
        split_map: dict[int, dict[tuple[int, int], int]] = {}
        for v in xs:
            pairings = solved.get(v) or []
            pairs_ev = filter_noise_pairs(ev.get(v), config)
            if pairs_ev:
                node_v = g.nodes[v]
                inc_set, out_set = set(node_v.inc), set(node_v.out)
                have = {(u, w) for u, w, _f in pairings}
                for (a_, b_), wt in sorted(pairs_ev.items()):
                    if (
                        (a_, b_) not in have
                        and a_ in inc_set
                        and b_ in out_set
                    ):
                        pairings.append((a_, b_, float(wt)))
            if not pairings:
                continue
            node = g.nodes[v]
            copies: dict[tuple[int, int], int] = {}
            for u, w, f in pairings:
                nid = g.add_node(node.seq, f, node.klen)
                copies[(u, w)] = nid
            split_map[v] = copies
        if not split_map:
            break
        for v, copies in split_map.items():
            for (u, w), nid in copies.items():
                if u not in split_map:
                    g.add_edge(u, nid)
                if w not in split_map:
                    g.add_edge(nid, w)
        # adjacent split X-nodes: connect copies that agree on the shared
        # edge (flow between specific copies is unknown locally; the
        # conservative join keeps all consistent continuations)
        for v, copies in split_map.items():
            for (u, w), nid in copies.items():
                if u in split_map:
                    for (u2, w2), nid2 in split_map[u].items():
                        if w2 == v:
                            g.add_edge(nid2, nid)
                if w in split_map:
                    for (u2, w2), nid2 in split_map[w].items():
                        if u2 == v:
                            g.add_edge(nid, nid2)
        # reroute read paths (MB semantics except interior misses keep
        # the path prefix instead of dropping the path)
        from shannon_tpu_torch.oracle.multibridge import _reroute_paths

        _reroute_paths(g, split_map, drop_on_interior_miss=False)
        for v in split_map:
            g.remove_node(v)
        total += len(split_map)
    g.condense()
    return total
