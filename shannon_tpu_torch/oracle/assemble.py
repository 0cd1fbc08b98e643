# Copied from shannon_tpu/oracle/assemble.py; equal to it apart from this line and the package name in imports.
"""Oracle end-to-end assembly — the reference's `shannon.py` stage
sequence (SURVEY.md §4.1) in pure Python.

Pipeline:  count -> correct -> condense -> thread reads -> multibridge ->
sparse flow -> enumerate transcripts -> dedupe (up to RC) -> length filter.

Transcript spec (binding):
  * transcripts are all maximal source->sink paths of the resolved graph
    (every node with indeg==0 starts paths; isolated cycles emit once,
    entered at their lowest-id node, traversed until closing);
  * a path's sequence concatenates node strings with the (k-1)-overlap
    dropped; its abundance estimate is the minimum node abundance along
    the path;
  * per-component enumeration is capped at max_paths_per_component
    (reported, never silent);
  * in canonical (double-stranded) mode each transcript appears in both
    orientations by construction; the output keeps the lexicographically
    smaller of (seq, revcomp(seq)) and drops exact duplicates;
  * transcripts shorter than min_transcript_length are dropped.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from shannon_tpu_torch.config import AssemblyConfig
from shannon_tpu_torch.io.dna import encode_seq, revcomp_str
from shannon_tpu_torch.oracle.counting import count_kmers
from shannon_tpu_torch.oracle.correction import clip_tips, correct_kmers
from shannon_tpu_torch.oracle.graph import build_contigs
from shannon_tpu_torch.oracle.multibridge import multibridge, thread_reads
from shannon_tpu_torch.oracle.nodegraph import NodeGraph
from shannon_tpu_torch.oracle.sparseflow import sparse_flow


@dataclass
class Transcript:
    seq: str
    abundance: float

    def canonical(self) -> str:
        rc = revcomp_str(self.seq)
        return self.seq if self.seq <= rc else rc


@dataclass
class AssemblyResult:
    transcripts: list[Transcript]
    stats: dict = field(default_factory=dict)

    def canonical_set(self) -> set[str]:
        """The judge-metric view: transcript set up to reverse complement
        (BASELINE.json)."""
        return {t.canonical() for t in self.transcripts}


def enumerate_transcripts(
    g: NodeGraph, config: AssemblyConfig
) -> tuple[list[Transcript], bool]:
    """All maximal paths per the transcript spec.  Returns (transcripts,
    truncated?)."""
    k1 = g.k - 1
    out: list[Transcript] = []
    truncated = False

    def emit(path: list[int]) -> None:
        seq = g.nodes[path[0]].seq + "".join(g.nodes[x].seq[k1:] for x in path[1:])
        ab = min(g.nodes[x].abundance for x in path)
        out.append(Transcript(seq=seq, abundance=ab))

    for comp in g.components():
        comp_set = set(comp)
        sources = [v for v in comp if not g.nodes[v].inc]
        budget = config.max_paths_per_component
        emitted = 0

        def dfs(v: int, path: list[int], on_path: set[int]) -> None:
            nonlocal emitted, truncated
            if emitted >= budget:
                truncated = True
                return
            nxt = [w for w in g.nodes[v].out if w not in on_path]
            if not nxt:
                emit(path)
                emitted += 1
                return
            for w in sorted(nxt):
                path.append(w)
                on_path.add(w)
                dfs(w, path, on_path)
                path.pop()
                on_path.remove(w)

        if sources:
            for s in sorted(sources):
                dfs(s, [s], {s})
        else:
            # source-free component (cycle): enter at lowest id, walk once
            s = min(comp)
            dfs(s, [s], {s})
        del comp_set
    return out, truncated


def dedupe_and_filter(
    transcripts: list[Transcript], config: AssemblyConfig
) -> list[Transcript]:
    best: dict[str, Transcript] = {}
    min_ab = np.float32(config.min_output_abundance)
    for t in transcripts:
        if len(t.seq) < config.min_transcript_length:
            continue
        if np.float32(t.abundance) < min_ab:
            continue
        key = t.canonical()
        prev = best.get(key)
        if prev is None or t.abundance > prev.abundance:
            best[key] = Transcript(seq=key, abundance=t.abundance)
    return [best[k] for k in sorted(best)]


def assemble_oracle(
    reads: list[str],
    config: AssemblyConfig | None = None,
) -> AssemblyResult:
    """Assemble transcripts from reads, exactly per the oracle spec."""
    config = config or AssemblyConfig()
    read_codes = [encode_seq(s) for s in reads]

    counts = count_kmers(read_codes, config.k, config.strand_specific)
    alive = correct_kmers(counts, config)
    alive = clip_tips(alive, config)
    cgraph = build_contigs(alive, config)
    paths, weights = thread_reads(read_codes, cgraph, config)
    g = NodeGraph.from_contig_graph(cgraph, paths, weights)
    n_mb = multibridge(g, config)
    n_sf = sparse_flow(g, config)
    transcripts, truncated = enumerate_transcripts(g, config)
    final = dedupe_and_filter(transcripts, config)
    stats = {
        "n_reads": len(reads),
        "n_kmers": len(counts),
        "n_kmers_alive": len(alive),
        "n_contigs": cgraph.n,
        "n_components": len(cgraph.components()),
        "n_mb_splits": n_mb,
        "n_sf_splits": n_sf,
        "n_raw_transcripts": len(transcripts),
        "n_transcripts": len(final),
        "truncated": truncated,
    }
    return AssemblyResult(transcripts=final, stats=stats)
