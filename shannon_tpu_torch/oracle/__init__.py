# Copied from shannon_tpu/oracle/__init__.py; equal to it apart from this line and the package name in imports.
"""Pure-Python reference-semantics oracle (SURVEY.md §5.1, §8 M0).

This package is the executable specification of the assembler: a slow,
exact, CPU-only implementation of every pipeline stage with the same
observable behavior the reference pipeline has (k-mer spectrum ->
abundance/extension correction -> condensed dBG contigs -> components ->
multibridging -> sparse flow -> transcripts).  The TPU pipeline is tested
stage-by-stage against it (k-mer spectrum equality, contig-set equality,
transcript-set equality up to reverse complement — the judge metric in
BASELINE.json).

It stands in for the reference implementation itself (the reference mount
is unavailable; SURVEY.md §0) and doubles as the host-side baseline
denominator for throughput benchmarks (BASELINE.md measurement plan).
"""

from shannon_tpu_torch.oracle.counting import count_kmers, kmer_to_str, str_to_kmer  # noqa: F401
from shannon_tpu_torch.oracle.correction import clip_tips, correct_kmers  # noqa: F401
from shannon_tpu_torch.oracle.graph import build_contigs, Contig, ContigGraph  # noqa: F401
from shannon_tpu_torch.oracle.assemble import assemble_oracle  # noqa: F401
