# Copied from shannon_tpu/eval.py; equal to it apart from this line and the package name in imports.
"""Assembly quality evaluation: assembled transcripts vs a ground-truth
set (the paper's validation is alignment against annotated references —
SURVEY.md §5; this is the simulation-world equivalent).

Metrics:
  * full recovery: truth transcripts exactly assembled (up to RC);
  * partial recovery: truth transcripts with >= `min_fraction` of their
    k-mers present in some assembled transcript (splits/fragments);
  * precision: assembled transcripts matching some truth (exact or by
    k-mer containment);
  * per-class counts + totals, JSON-friendly.

Usage:
  python -m shannon_tpu.eval truth.fasta assembled.fasta [-k 24]
"""

from __future__ import annotations

import argparse
import json

from shannon_tpu_torch.io.dna import revcomp_str


def _kmers(seq: str, k: int) -> set[str]:
    out = set()
    for i in range(len(seq) - k + 1):
        s = seq[i : i + k]
        r = revcomp_str(s)
        out.add(s if s <= r else r)
    return out


def evaluate(
    truth: list[str],
    assembled: list[str],
    k: int = 24,
    min_fraction: float = 0.95,
) -> dict:
    truth_canon = {min(t, revcomp_str(t)) for t in truth}
    asm_canon = {min(a, revcomp_str(a)) for a in assembled}

    exact = truth_canon & asm_canon
    asm_kmers: set[str] = set()
    for a in assembled:
        asm_kmers |= _kmers(a, k)

    partial = set()
    for t in truth_canon:
        if t in exact:
            continue
        tk = _kmers(t, k)
        if tk and len(tk & asm_kmers) >= min_fraction * len(tk):
            partial.add(t)

    truth_kmers: set[str] = set()
    for t in truth:
        truth_kmers |= _kmers(t, k)
    matched_asm = 0
    for a in asm_canon:
        if a in truth_canon:
            matched_asm += 1
            continue
        ak = _kmers(a, k)
        if ak and len(ak & truth_kmers) >= min_fraction * len(ak):
            matched_asm += 1

    n_truth = len(truth_canon)
    n_asm = len(asm_canon)
    return {
        "n_truth": n_truth,
        "n_assembled": n_asm,
        "exact_recovered": len(exact),
        "partial_recovered": len(partial),
        "recall_exact": round(len(exact) / n_truth, 4) if n_truth else 0.0,
        "recall_partial": round(
            (len(exact) + len(partial)) / n_truth, 4
        ) if n_truth else 0.0,
        "precision": round(matched_asm / n_asm, 4) if n_asm else 0.0,
        "k": k,
        "min_fraction": min_fraction,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="shannon-tpu-eval")
    p.add_argument("truth")
    p.add_argument("assembled")
    p.add_argument("-k", type=int, default=24)
    p.add_argument("--min-fraction", type=float, default=0.95)
    args = p.parse_args(argv)
    from shannon_tpu_torch.io.fastx import read_fastx

    truth = [s for _, s in read_fastx(args.truth)]
    assembled = [s for _, s in read_fastx(args.assembled)]
    print(json.dumps(evaluate(truth, assembled, args.k, args.min_fraction)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
