"""Component-scheduled assembly back half: MB + SF + enumeration per
bucket of weakly-connected components.

Copied from ``shannon_tpu/parallel/components.py``, whose package imports
JAX at import time (``shannon_tpu/parallel/__init__.py``).  The only
change: the partition helpers come from ``shannon_tpu_torch.ops.partition``.
"""

from __future__ import annotations

import numpy as np

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.oracle.assemble import (
    Transcript,
    enumerate_transcripts,
)
from shannon_tpu.oracle.multibridge import multibridge
from shannon_tpu.oracle.nodegraph import Node, NodeGraph
from shannon_tpu.oracle.sparseflow import sparse_flow


def device_components(ca) -> list[list[int]]:
    """Weakly-connected components of the device contig graph
    (ops/partition.connected_components — exact C-speed pass over the
    device-emitted edge arrays); oracle-format component lists,
    identical to ContigGraph.components() (tested)."""
    from shannon_tpu_torch.ops.partition import (
        components_to_lists,
        connected_components,
    )

    return components_to_lists(connected_components(ca), ca.n_contigs)


def _subgraph(
    g: NodeGraph, node_ids: list[int], path_idx: np.ndarray
) -> NodeGraph:
    """Induced subgraph over node_ids with the given evidence paths,
    ids remapped to dense [0, len(node_ids)).

    Path selection + remap is pure array work on the flat path storage
    (VERDICT r3 item 4: the old per-element Python remap over the lazy
    g.paths list view was the bulk of the 24.6s of unattributed
    assembly time at 1M reads); only the per-node adjacency lists stay
    Python (they are component-local and tiny)."""
    remap_arr = np.full(len(g.nodes), -1, np.int64)
    remap_arr[node_ids] = np.arange(len(node_ids), dtype=np.int64)
    remap_l = remap_arr.tolist()
    nodes = [
        Node(
            seq=g.nodes[v].seq,
            abundance=g.nodes[v].abundance,
            klen=g.nodes[v].klen,
            out=[remap_l[w] for w in g.nodes[v].out],
            inc=[remap_l[w] for w in g.nodes[v].inc],
        )
        for v in node_ids
    ]
    flat, offs, weights = g.flat_paths()
    pi = np.asarray(path_idx, np.int64)
    lens = np.diff(offs)[pi]
    noffs = np.zeros(len(pi) + 1, np.int64)
    np.cumsum(lens, out=noffs[1:])
    src = np.repeat(offs[:-1][pi], lens) + (
        np.arange(int(noffs[-1]), dtype=np.int64)
        - np.repeat(noffs[:-1], lens)
    )
    sub = NodeGraph(k=g.k, nodes=nodes, paths=[])
    sub.set_paths_flat(remap_arr[flat[src]], noffs, weights[pi])
    return sub


def assemble_components(
    g: NodeGraph,
    comps: list[list[int]],
    config: AssemblyConfig,
    solver=None,
    bucket_edges: tuple[int, ...] = (1, 2, 4, 16, 64, 256),
) -> tuple[list[Transcript], int, int, bool]:
    """MB + SF + transcript enumeration scheduled per component bucket.

    Returns (raw transcripts, n_mb_splits, n_sf_splits, truncated,
    phase_s) — the same output as running multibridge/sparse_flow/
    enumerate_transcripts on the whole graph (identical transcript
    multiset; MB and SF use only component-local evidence, so the
    grouping is free to choose).  comps must be the weakly-connected
    components of g (device partitioner or ContigGraph.components()).
    phase_s accumulates per-phase wall-clock across buckets.
    """
    import time

    from shannon_tpu_torch.ops.partition import bucket_components

    t_sched0 = time.perf_counter()
    # component id per node -> per path (a path never leaves its
    # component: every step follows an edge) — vectorized over the flat
    # path storage (VERDICT r3 item 4)
    n_nodes = len(g.nodes)
    comp_of = np.full(n_nodes, -1, np.int64)
    comp_sizes = np.fromiter((len(c) for c in comps), np.int64, len(comps))
    all_members = np.fromiter(
        (v for c in comps for v in c), np.int64, int(comp_sizes.sum())
    )
    comp_of[all_members] = np.repeat(
        np.arange(len(comps), dtype=np.int64), comp_sizes
    )
    flat, offs, _w = g.flat_paths()
    n_paths = len(offs) - 1
    if n_paths:
        first_node = flat[offs[:-1]]
        path_comp = comp_of[first_node]
        p_order = np.argsort(path_comp, kind="stable")  # path order kept
        comp_counts = np.bincount(
            path_comp[path_comp >= 0], minlength=len(comps)
        )
        comp_pstart = np.zeros(len(comps) + 1, np.int64)
        np.cumsum(comp_counts, out=comp_pstart[1:])
        p_sorted = p_order[np.argsort(path_comp[p_order] < 0, kind="stable")]
        # p_sorted[comp_pstart[c]:comp_pstart[c+1]] = path ids of comp c
    else:
        comp_pstart = np.zeros(len(comps) + 1, np.int64)
        p_sorted = np.empty(0, np.int64)

    transcripts: list[Transcript] = []
    n_mb = n_sf = 0
    truncated = False
    phase_s = {
        "schedule": 0.0,
        "subgraph": 0.0,
        "multibridge": 0.0,
        "sparseflow": 0.0,
        "enumerate": 0.0,
    }

    # fast path: single-node, edge-free components emit directly
    trivial: list[int] = []
    complex_comps: list[int] = []
    for ci, comp in enumerate(comps):
        v = comp[0]
        if (
            len(comp) == 1
            and not g.nodes[v].out
            and not g.nodes[v].inc
        ):
            trivial.append(ci)
        else:
            complex_comps.append(ci)
    for ci in trivial:
        node = g.nodes[comps[ci][0]]
        transcripts.append(Transcript(seq=node.seq, abundance=node.abundance))

    # bucket the remaining components by size and assemble each bucket
    # as one merged subgraph (components stay independent inside it)
    sizes = [len(comps[ci]) for ci in complex_comps]
    buckets = bucket_components(sizes, bucket_edges)
    phase_s["schedule"] += time.perf_counter() - t_sched0
    for edge in sorted(buckets, key=lambda e: (e == 0, e)):
        members = buckets[edge]
        ts0 = time.perf_counter()
        node_ids = [v for m in members for v in comps[complex_comps[m]]]
        path_idx = (
            np.concatenate(
                [
                    p_sorted[
                        comp_pstart[complex_comps[m]] : comp_pstart[
                            complex_comps[m] + 1
                        ]
                    ]
                    for m in members
                ]
            )
            if members
            else np.empty(0, np.int64)
        )
        sub = _subgraph(g, node_ids, path_idx)
        t0 = time.perf_counter()
        n_mb += multibridge(sub, config)
        t1 = time.perf_counter()
        n_sf += sparse_flow(sub, config, solver=solver)
        t2 = time.perf_counter()
        ts, tr = enumerate_transcripts(sub, config)
        phase_s["subgraph"] += t0 - ts0
        phase_s["multibridge"] += t1 - t0
        phase_s["sparseflow"] += t2 - t1
        phase_s["enumerate"] += time.perf_counter() - t2
        transcripts.extend(ts)
        truncated = truncated or tr
    return transcripts, n_mb, n_sf, truncated, phase_s
