"""Graph partitioning: weakly-connected components of the contig graph.

Copied from ``shannon_tpu/ops/partition.py`` (a host scipy pass over the
device-built edge arrays; the reference module imports JAX through its
ContigArrays import, so it cannot be imported here).  The only change:
``connected_components`` reads the port's ContigArrays.
"""

from __future__ import annotations

import numpy as np

from shannon_tpu_torch.ops.condense import ContigArrays


def connected_components(ca: ContigArrays) -> np.ndarray:
    """Component label per contig lane: the minimum contig id reachable
    (undirected), matching ContigGraph.components() ordering.  -1 on
    non-contig lanes."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _cc

    C2 = int(ca.out_edges.shape[1])
    n = ca.n_contigs
    out_e = ca.out_edges[:, :n].cpu().numpy()  # [4, n]
    valid = out_e >= 0
    src = np.broadcast_to(np.arange(n, dtype=np.int64)[None, :], out_e.shape)[
        valid
    ]
    tgt = out_e[valid].astype(np.int64)
    adj = coo_matrix(
        (np.ones(len(src), np.int8), (src, tgt)), shape=(n, n)
    )
    _, raw = _cc(adj, directed=True, connection="weak")
    # relabel each component by its minimum member id (the oracle's
    # deterministic labeling)
    min_id = np.full(raw.max(initial=-1) + 1, np.iinfo(np.int64).max)
    np.minimum.at(min_id, raw, np.arange(n, dtype=np.int64))
    labels = np.full(C2, -1, np.int64)
    if n:
        labels[:n] = min_id[raw]
    return labels


def components_to_lists(labels: np.ndarray, n_contigs: int) -> list[list[int]]:
    """Host: component label array -> oracle-format component lists
    (sorted ids, ordered by minimum member = label)."""
    labels = np.asarray(labels[:n_contigs])
    order = np.argsort(labels, kind="stable")
    out: list[list[int]] = []
    prev = None
    for cid in order:
        l = labels[cid]
        if l != prev:
            out.append([])
            prev = l
        out[-1].append(int(cid))
    return out


def bucket_components(
    sizes: list[int], bucket_edges: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
) -> dict[int, list[int]]:
    """Group component indices into padded size classes (components of
    size <= edge go in bucket `edge`); oversized ones land in bucket 0
    (processed individually)."""
    buckets: dict[int, list[int]] = {}
    for i, s in enumerate(sizes):
        for e in bucket_edges:
            if s <= e:
                buckets.setdefault(e, []).append(i)
                break
        else:
            buckets.setdefault(0, []).append(i)
    return buckets
