# Copied from shannon_tpu/oracle/graph.py; equal to it apart from this line and the package name in imports.
"""Oracle condensed de Bruijn graph (reference stage 2 output + stage 3
graph prep; SURVEY.md §4.2, §3.1 kmers_for_component).

Spec (binding for the TPU pipeline):

  * **Node space**: directed graph over *oriented* k-mers.  In canonical
    (double-stranded) mode both orientations of every alive canonical
    k-mer are instantiated as separate nodes (a palindrome contributes
    one); each carries the canonical count.  Downstream stages are then
    purely directed-graph algorithms, and final transcripts are
    deduplicated up to reverse complement (the judge metric compares up
    to RC anyway — BASELINE.json).  In strand-specific mode nodes are the
    alive k-mers as counted.

  * **Edges**: x -> y iff suffix_{k-1}(x) == prefix_{k-1}(y) and both are
    alive, i.e. y ∈ {suffix_{k-1}(x)·b}.

  * **Condensation**: maximal non-branching paths.  Consecutive k-mers
    x -> y merge into one unitig iff outdeg(x) == 1 and indeg(y) == 1.
    A unitig (contig) records its base string (first k-mer + one base per
    subsequent k-mer) and its abundance = arithmetic mean of member k-mer
    counts (float).  Isolated cycles are broken at their minimum-value
    k-mer (deterministic).

  * **Contig graph**: nodes = contigs, edge c1 -> c2 iff the dBG has an
    edge (last k-mer of c1) -> (first k-mer of c2).

  * **Components**: weakly-connected components of the contig graph.
    This is the semantic replacement for the reference's GPMETIS
    partition (SURVEY.md §3.2): METIS balances component *sizes* for the
    process pool, but independent assembly is only sound per weakly
    connected subgraph; the rebuild batches whole components onto chips,
    so balance is a scheduling concern (bucketing), not a semantic one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from shannon_tpu_torch.config import AssemblyConfig
from shannon_tpu_torch.oracle.counting import canon_kmer, kmer_to_str, revcomp_kmer


@dataclass
class Contig:
    kmers: list[int]  # oriented member k-mer values, in path order
    seq: str  # base string, len == k + len(kmers) - 1
    abundance: float  # mean member count

    def __len__(self) -> int:
        return len(self.seq)


@dataclass
class ContigGraph:
    k: int
    contigs: list[Contig]
    out_edges: list[list[int]]  # adjacency: contig id -> successor ids
    in_edges: list[list[int]]
    rc_pair: list[int] = field(default_factory=list)
    # rc_pair[i] = id of i's reverse-complement contig (== i for
    # palindromic / strand-specific); filled in canonical mode.

    @property
    def n(self) -> int:
        return len(self.contigs)

    def components(self) -> list[list[int]]:
        """Weakly-connected components (sorted ids, deterministic order)."""
        n = self.n
        parent = list(range(n))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for u in range(n):
            for v in self.out_edges[u]:
                ra, rb = find(u), find(v)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
        groups: dict[int, list[int]] = {}
        for u in range(n):
            groups.setdefault(find(u), []).append(u)
        return [groups[r] for r in sorted(groups)]


def _oriented_nodes(
    alive: dict[int, int], k: int, strand_specific: bool
) -> dict[int, int]:
    """Oriented node set: value -> count."""
    if strand_specific:
        return dict(alive)
    nodes: dict[int, int] = {}
    for v, c in alive.items():
        nodes[v] = c
        rc = revcomp_kmer(v, k)
        nodes[rc] = c  # palindrome: rc == v, single entry
    return nodes


def _successors(nodes: dict[int, int], v: int, k: int) -> list[int]:
    mask = (1 << (2 * k)) - 1
    base = (v << 2) & mask
    return [base | b for b in range(4) if (base | b) in nodes]


def _predecessors(nodes: dict[int, int], v: int, k: int) -> list[int]:
    hi_shift = 2 * (k - 1)
    suf = v >> 2
    return [
        (b << hi_shift) | suf for b in range(4) if ((b << hi_shift) | suf) in nodes
    ]


def build_contigs(alive: dict[int, int], config: AssemblyConfig) -> ContigGraph:
    """Condense the alive k-mer set into a ContigGraph per the spec."""
    k = config.k
    nodes = _oriented_nodes(alive, k, config.strand_specific)

    succ: dict[int, list[int]] = {}
    pred: dict[int, list[int]] = {}
    for v in nodes:
        succ[v] = _successors(nodes, v, k)
        pred[v] = _predecessors(nodes, v, k)

    def merge_next(x: int) -> int | None:
        """Unique successor y of x with indeg(y)==1, else None."""
        s = succ[x]
        if len(s) != 1:
            return None
        y = s[0]
        if len(pred[y]) != 1:
            return None
        return y

    def merge_prev(x: int) -> int | None:
        p = pred[x]
        if len(p) != 1:
            return None
        y = p[0]
        if len(succ[y]) != 1:
            return None
        return y

    # Path starts: nodes with no mergeable predecessor.  Remaining nodes
    # after walking from starts are isolated cycles; break each at its
    # minimum member (deterministic).
    visited: set[int] = set()
    contig_of_kmer: dict[int, tuple[int, int]] = {}  # v -> (contig id, offset)
    contigs: list[Contig] = []

    def walk(start: int) -> None:
        path = [start]
        visited.add(start)
        x = start
        while True:
            y = merge_next(x)
            if y is None or y in visited:
                break
            path.append(y)
            visited.add(y)
            x = y
        cid = len(contigs)
        chars = kmer_to_str(path[0], k)
        tail = "".join(kmer_to_str(v, k)[-1] for v in path[1:])
        count_sum = sum(nodes[v] for v in path)
        # abundance in float32 — the device compute precision, so that
        # downstream threshold comparisons are bit-identical (same
        # rationale as the correction spec)
        contigs.append(
            Contig(
                kmers=path,
                seq=chars + tail,
                abundance=float(np.float32(count_sum) / np.float32(len(path))),
            )
        )
        for off, v in enumerate(path):
            contig_of_kmer[v] = (cid, off)

    # Deterministic iteration order: sorted k-mer values.
    ordered = sorted(nodes)
    for v in ordered:
        if v not in visited and merge_prev(v) is None:
            walk(v)
    for v in ordered:  # isolated cycles
        if v not in visited:
            walk(v)

    # contig-level edges
    n = len(contigs)
    out_edges: list[list[int]] = [[] for _ in range(n)]
    in_edges: list[list[int]] = [[] for _ in range(n)]
    for cid, c in enumerate(contigs):
        last = c.kmers[-1]
        for y in succ[last]:
            tid, off = contig_of_kmer[y]
            # edge only to a contig *start* — internal members of another
            # contig are only reachable if y is mergeable, which implies
            # y is the unique continuation inside this same contig unless
            # the walk was cut by a visit/cycle break.
            if off == 0:
                out_edges[cid].append(tid)
                in_edges[tid].append(cid)
            elif tid == cid and off == contig_of_kmer[c.kmers[0]][1]:
                # pure cycle contig closing on itself: self-loop
                out_edges[cid].append(tid)
                in_edges[tid].append(cid)
    for e in out_edges:
        e.sort()
    for e in in_edges:
        e.sort()

    # rc pairing (canonical mode): map each contig to the contig whose
    # k-mer path is the reversed complements.
    rc_pair = list(range(n))
    if not config.strand_specific:
        first_kmer_to_cid = {c.kmers[0]: i for i, c in enumerate(contigs)}
        for cid, c in enumerate(contigs):
            rc_first = revcomp_kmer(c.kmers[-1], k)
            tid = first_kmer_to_cid.get(rc_first, cid)
            rc_pair[cid] = tid
    g = ContigGraph(
        k=k,
        contigs=contigs,
        out_edges=out_edges,
        in_edges=in_edges,
        rc_pair=rc_pair,
    )
    g._contig_of_kmer = contig_of_kmer  # type: ignore[attr-defined]
    return g
