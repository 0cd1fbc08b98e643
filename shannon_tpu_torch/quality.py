"""Quality gates of the port: the four sections of the reference's
``scripts/quality.py`` (pinned midscale, paired-end bridging, splicing and
the coverage x cutoff sweep), on the port's ``assemble``.

    python -m shannon_tpu_torch.quality [--device cuda|cpu] [--out FILE]
    python -m shannon_tpu_torch.quality --paired-bridging
    python -m shannon_tpu_torch.quality --splicing
    python -m shannon_tpu_torch.quality --sweep
    python -m shannon_tpu_torch.quality --backend oracle

The same datasets (seeds, sizes, error rates), the same
``AssemblyConfig(kmer_capacity=1 << 20)`` and the same per-section JSON as
the reference, with the metrics of the port's ``eval.evaluate``.  Each
section also gives ``sha256``: the first 16 hex digits of the SHA-256 of its
assemblies' transcript sets (transcript_sha256), so two runs can be held
equal beyond their metrics; section_sha256 hashes the rest of a section.
Each section function takes its dataset's sizes and the count table's
capacity as arguments, defaulting to the reference's constants, so tests
can shrink them.

This module writes only ``--out`` and standard output.  The committed
``quality.json`` and ``QUALITY.md`` are the reference's, from the oracle
backend of an older tree; hold the port against a fresh run of the
reference's section functions, not against them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from dataclasses import replace

import numpy as np

from shannon_tpu_torch.config import AssemblyConfig
from shannon_tpu_torch.eval import evaluate
from shannon_tpu_torch.io.dna import revcomp_str
from shannon_tpu_torch.pipeline import assemble
from shannon_tpu_torch.sim import (
    sample_paired_reads,
    sample_reads,
    simulate_gene_isoforms,
    simulate_repeat_transcripts,
    simulate_transcripts,
)

# The reference's constants (scripts/quality.py).
SEED = 1234
N_TRANSCRIPTS = 100
T_LEN = 1500
COVERAGE = 20.0
READ_LEN = 100
ERROR_RATE = 0.01

PB_SEED = 4321
PB_N_PAIRS = 10
PB_REPEAT = 180
PB_FLANK = 400
PB_INSERT = 300

SG_SEED = 99
SG_GENES = 30
SG_COVERAGE = 20.0
SG_INSERT = 350

SWEEP_COVERAGES = (5.0, 10.0, 20.0)
SWEEP_CUTOFFS = (0.0, 1.0, 1.5)

# The reference's AssemblyConfig(kmer_capacity=1 << 20).  The capacity sizes
# the count's table and does not change a result (an overflow raises), so
# tests may shrink it with the datasets.
KMER_CAPACITY = 1 << 20


def transcript_sha256(assemblies: list[list[str]]) -> str:
    """First 16 hex digits of the SHA-256 of each assembly's canonical
    transcript set (min of a sequence and its reverse complement), sorted,
    one per line, each set closed by a line '#', in the order given."""
    h = hashlib.sha256()
    for seqs in assemblies:
        canon = sorted({min(s, revcomp_str(s)) for s in seqs})
        h.update(("\n".join(canon) + "\n#\n").encode())
    return h.hexdigest()[:16]


def strip_section(section):
    """A section without what differs between two equal runs: wall times,
    backend labels, and its hash."""
    if isinstance(section, dict):
        return {k: strip_section(v) for k, v in section.items()
                if k not in ("wall_s", "backend", "sha256")}
    if isinstance(section, list):
        return [strip_section(v) for v in section]
    return section


def section_sha256(section: dict) -> str:
    """First 16 hex digits of the SHA-256 of strip_section(section) as
    sorted-key JSON: every metric, dataset field and assembly statistic."""
    text = json.dumps(strip_section(section), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _pinned_dataset(coverage: float, n_transcripts: int, length: int):
    rng = np.random.default_rng(SEED)
    abund = np.exp(rng.normal(0, 1, n_transcripts))
    abund = (abund / abund.mean()).tolist()
    truth = simulate_transcripts(rng, n=n_transcripts, length=length)
    reads = sample_reads(
        rng, truth, abundances=abund, coverage=coverage,
        read_length=READ_LEN, error_rate=ERROR_RATE,
    )
    return truth, reads


def run_pinned(backend: str = "device", device="cuda", *, n_transcripts: int = N_TRANSCRIPTS,
               length: int = T_LEN, coverage: float = COVERAGE,
               kmer_capacity: int = KMER_CAPACITY) -> dict:
    """Random transcripts at log-normal abundances, single-end reads."""
    truth, reads = _pinned_dataset(coverage, n_transcripts, length)
    cfg = AssemblyConfig(kmer_capacity=kmer_capacity)
    t0 = time.perf_counter()
    res = assemble(reads, cfg, backend=backend, device=device)
    wall = time.perf_counter() - t0
    seqs = [t.seq for t in res.transcripts]
    return {
        "dataset": {
            "seed": SEED,
            "n_transcripts": n_transcripts,
            "transcript_length": length,
            "coverage_mean": coverage,
            "read_length": READ_LEN,
            "error_rate": ERROR_RATE,
            "n_reads": len(reads),
            "abundances": "log-normal(0, 1), mean-normalized",
        },
        "backend": backend,
        "wall_s": round(wall, 1),
        "metrics": evaluate(truth, seqs, k=cfg.k),
        "assembly_stats": res.stats,
        "sha256": transcript_sha256([seqs]),
    }


def run_paired_bridging(backend: str = "device", device="cuda", *, n_pairs: int = PB_N_PAIRS,
                        coverage: float = COVERAGE,
                        kmer_capacity: int = KMER_CAPACITY) -> dict:
    """Transcript pairs sharing a repeat longer than a read and shorter than
    the insert, paired reads, assembled with pairs off and on."""
    rng = np.random.default_rng(PB_SEED)
    truth = simulate_repeat_transcripts(
        rng, n_pairs=n_pairs, repeat_length=PB_REPEAT, flank_length=PB_FLANK,
    )
    reads = sample_paired_reads(
        rng, truth, coverage=coverage, read_length=READ_LEN,
        insert_size=PB_INSERT, error_rate=ERROR_RATE,
    )
    cfg = AssemblyConfig(kmer_capacity=kmer_capacity)
    out: dict = {
        "dataset": {
            "seed": PB_SEED,
            "n_repeat_pairs": n_pairs,
            "repeat_length": PB_REPEAT,
            "flank_length": PB_FLANK,
            "insert_size": PB_INSERT,
            "read_length": READ_LEN,
            "coverage": coverage,
            "error_rate": ERROR_RATE,
            "n_reads": len(reads),
            "shape": "t_2i = A_i+R_i+B_i, t_2i+1 = C_i+R_i+D_i; "
                     "equal abundance (SF flow-degenerate at each repeat)",
        },
        "backend": backend,
    }
    sets = []
    for use_pairs in (False, True):
        t0 = time.perf_counter()
        res = assemble(reads, replace(cfg, use_pairs=use_pairs), backend=backend,
                       device=device, paired=True)
        seqs = [t.seq for t in res.transcripts]
        sets.append(seqs)
        m = evaluate(truth, seqs, k=cfg.k)
        m["wall_s"] = round(time.perf_counter() - t0, 1)
        out["pairs_on" if use_pairs else "pairs_off"] = m
    out["sha256"] = transcript_sha256(sets)
    return out


def run_splicing(backend: str = "device", device="cuda", *, n_genes: int = SG_GENES,
                 coverage: float = SG_COVERAGE, kmer_capacity: int = KMER_CAPACITY) -> dict:
    """Genes as exon chains, isoforms as exon subsets: single-end with exact
    recall per abundance decile, then a paired variant of the same
    transcriptome."""
    rng = np.random.default_rng(SG_SEED)
    truth, _gene_of = simulate_gene_isoforms(rng, n_genes=n_genes)
    abund = np.exp(rng.normal(0, 1, len(truth)))
    abund = (abund / abund.mean()).tolist()
    reads = sample_reads(
        rng, truth, abundances=abund, coverage=coverage,
        read_length=READ_LEN, error_rate=ERROR_RATE,
    )
    cfg = AssemblyConfig(kmer_capacity=kmer_capacity)
    t0 = time.perf_counter()
    res = assemble(reads, cfg, backend=backend, device=device)
    wall = time.perf_counter() - t0
    seqs = [t.seq for t in res.transcripts]
    m = evaluate(truth, seqs, k=cfg.k)

    asm_canon = {min(s, revcomp_str(s)) for s in seqs}
    order = np.argsort(abund)
    deciles = []
    for d in range(10):
        sel = order[d * len(truth) // 10 : (d + 1) * len(truth) // 10]
        if not len(sel):
            continue
        hit = sum(1 for i in sel if min(truth[i], revcomp_str(truth[i])) in asm_canon)
        deciles.append({
            "decile": d,
            "abundance_range": [round(float(abund[sel[0]]), 3), round(float(abund[sel[-1]]), 3)],
            "n": int(len(sel)),
            "exact": hit,
        })
    rng_p = np.random.default_rng(SG_SEED + 1)
    preads = sample_paired_reads(
        rng_p, truth, abundances=abund, coverage=coverage,
        read_length=READ_LEN, insert_size=SG_INSERT, error_rate=ERROR_RATE,
    )
    res_p = assemble(preads, cfg, backend=backend, device=device, paired=True)
    pseqs = [t.seq for t in res_p.transcripts]
    m_p = evaluate(truth, pseqs, k=cfg.k)
    m_p["n_isoforms_below_insert"] = sum(1 for t in truth if len(t) < SG_INSERT)
    return {
        "dataset": {
            "seed": SG_SEED,
            "n_genes": n_genes,
            "n_isoforms": len(truth),
            "coverage_mean": coverage,
            "read_length": READ_LEN,
            "error_rate": ERROR_RATE,
            "n_reads": len(reads),
            "abundances": "log-normal(0, 1) per isoform, mean-normalized",
            "shape": "genes = exon chains; isoforms = order-preserving "
            "exon subsets anchored at terminal exons (shared-exon "
            "structure -> SF flow decomposition is exercised)",
        },
        "backend": backend,
        "wall_s": round(wall, 1),
        "metrics": m,
        "metrics_paired": m_p,
        "paired_insert_size": SG_INSERT,
        "per_abundance_decile": deciles,
        "assembly_stats": res.stats,
        "assembly_stats_paired": {
            k: res_p.stats[k] for k in ("n_mb_splits", "n_sf_splits", "n_transcripts")
        },
        "sha256": transcript_sha256([seqs, pseqs]),
    }


def run_sweep(backend: str = "device", device="cuda", *,
              coverages: tuple[float, ...] = SWEEP_COVERAGES,
              cutoffs: tuple[float, ...] = SWEEP_CUTOFFS, n_transcripts: int = N_TRANSCRIPTS,
              length: int = T_LEN, kmer_capacity: int = KMER_CAPACITY) -> dict:
    """The pinned dataset resampled at each coverage, assembled once at
    cutoff 0; each higher cutoff re-applies the output filter (float32
    abundance >= cutoff), which equals assembling at that cutoff."""
    rows, sets = [], []
    for cov in coverages:
        truth, reads = _pinned_dataset(cov, n_transcripts, length)
        cfg = AssemblyConfig(kmer_capacity=kmer_capacity, min_output_abundance=0.0)
        res = assemble(reads, cfg, backend=backend, device=device)
        sets.append([t.seq for t in res.transcripts])
        for cut in cutoffs:
            seqs = [t.seq for t in res.transcripts
                    if np.float32(t.abundance) >= np.float32(cut)]
            m = evaluate(truth, seqs, k=cfg.k)
            rows.append({"coverage": cov, "min_output_abundance": cut,
                         "n_reads": len(reads), **m})
            print(json.dumps(rows[-1]), flush=True)
    return {"backend": backend, "rows": rows, "sha256": transcript_sha256(sets)}


def headline(name: str, section: dict) -> dict:
    """A section's headline numbers, for a one-line report."""
    if name == "paired_bridging":
        return {side: {k: section[side][k] for k in ("recall_exact", "recall_partial",
                                                     "precision", "n_assembled")}
                for side in ("pairs_off", "pairs_on")}
    if name == "sweep":
        return {"rows": [(r["coverage"], r["min_output_abundance"], r["recall_exact"],
                          r["precision"], r["n_assembled"]) for r in section["rows"]]}
    m = section["metrics"]
    out = {k: m[k] for k in ("recall_exact", "recall_partial", "precision", "n_assembled")}
    out["n_reads"] = section["dataset"]["n_reads"]
    return out


SECTIONS = {"pinned": run_pinned, "paired_bridging": run_paired_bridging,
            "splicing": run_splicing, "sweep": run_sweep}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--paired-bridging", action="store_true")
    which.add_argument("--splicing", action="store_true")
    which.add_argument("--sweep", action="store_true")
    ap.add_argument("--backend", default="device", choices=["device", "oracle"])
    ap.add_argument("--device", default="cuda", help="torch device of the device backend")
    ap.add_argument("--out", default=None, help="write the section's JSON here")
    args = ap.parse_args(argv)
    name = ("paired_bridging" if args.paired_bridging else "splicing" if args.splicing
            else "sweep" if args.sweep else "pinned")
    text = json.dumps({name: SECTIONS[name](args.backend, args.device)}, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
