# Copied from shannon_tpu/config.py; equal to it apart from this line and the package name in imports.
"""Assembly configuration.

Mirrors the reference CLI surface (SURVEY.md §3.1 `shannon.py`: `-o` outdir,
`-p` nprocs, `-K` k-mer size default 24, `--single` / `--left`+`--right`,
strand-specific flag, abundance cutoffs, min transcript length) as a single
dataclass.  The reference keeps these as argparse defaults + in-file constants
(SURVEY.md §6 "Config/flag system"); here they are one typed object threaded
through every stage so device code sees only static Python values (safe to
close over under `jit`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class AssemblyConfig:
    # --- core k-mer parameters -------------------------------------------
    k: int = 24
    """k-mer size.  Reference default K=24 (SURVEY.md §3.1).  Must be <= 32
    so a k-mer packs into a (hi, lo) uint32 pair (2 bits/base, 64 bits max);
    TPUs have no int64 lanes so all device code is two-word (SURVEY.md §8)."""

    min_abundance: int = 0
    """Drop k-mers with count < min_abundance before graph construction
    (the Jellyfish-table abundance filter, SURVEY.md §3.1
    extension_correction).  0 (default) = auto: coverage-aware
    threshold from the k-mer count histogram
    (oracle.correction.choose_min_abundance — recall-guarded ladder
    that only engages when the error band dominates AND coverage is
    deep; shallow or error-free data resolves to 1, i.e. no filter).
    An explicit value >= 1 pins the cutoff."""

    strand_specific: bool = False
    """If True, do not canonicalize k-mers (reads are from a stranded
    protocol); if False, count canonical (min of forward / reverse
    complement) k-mers, mirroring the reference's double-stranded default."""

    # --- error correction -------------------------------------------------
    sibling_ratio: float = 0.1
    """Extension-correction threshold: at each branch of the dBG, an
    alternative whose count is < sibling_ratio * (max sibling count) is
    treated as a sequencing-error branch and pruned.  Plays the role of the
    reference's iterative weak-extension trimming (SURVEY.md §4.2)."""

    correction_rounds: int = 8
    """Max pruning rounds (fixpoint usually reached in 2-3)."""

    error_rate: float = 0.01
    """Expected per-base sequencing error rate (typical Illumina ~1%).
    Drives the ABSOLUTE error cap on every domination prune (sibling
    pruning, tip/bubble clipping): a branch is removed only when it is
    ratio-dominated AND its count is consistent with sequencing error —
    count <= lam + 4*sqrt(lam) + 1 (floored at 3) where
    lam = error_rate/3 * competing flow, the expected count of one
    specific substitution branch.  Rationale (round-5 splicing-gate
    finding): a purely RELATIVE threshold deletes every minor isoform
    below sibling_ratio of its sibling's expression no matter how deep
    the coverage — a 6-count exon junction against a 135-count major
    path is 22x below it but 13x ABOVE the error expectation (lam
    0.45), i.e. unambiguously structural.  0 disables the cap (pure
    ratio behavior)."""

    tip_klen: int = 0
    """Tip clipping: a dead-end contig of <= tip_klen member k-mers whose
    abundance is dominated (by sibling_ratio) at its attachment junction
    is removed; an isolated contig of <= tip_klen k-mers shorter than
    min_transcript_length is removed.  0 = auto (3*k); negative disables.
    Removes the dangling remainder of sequencing-error paths after branch
    pruning (the reference's dead-end trimming — SURVEY.md §3.1)."""

    @property
    def tip_klen_effective(self) -> int:
        return 3 * self.k if self.tip_klen == 0 else self.tip_klen

    error_branch_ratio: float = 0.5
    """Stricter domination ratio for k-mer-scale branches: a bubble or
    dead-end tip of <= k+2 member k-mers (the exact graph footprint of
    one substitution error — a mid-read error makes a k-k-mer parallel
    bubble, an end-of-read error a shorter tip) is pruned when its
    abundance < error_branch_ratio * the competing branch's.  Longer
    branches (alternative exons, real transcript ends) keep the lax
    sibling_ratio, preserving low-expression isoforms — the lax ratio
    alone leaks error branches wherever coverage < 1/sibling_ratio
    (count-1 error vs count-4 sibling survives 0.1 but not 0.5,
    measured: 1517 error-path transcripts on the 20x pinned quality
    dataset).  For BUBBLES the strict ratio additionally applies only
    against competitors of error-comparable length (<= k+2 k-mers): an
    exon-skip junction has the same short footprint as a substitution
    bubble but competes against the whole skipped exon — holding it to
    0.5 deleted every minor isoform below half the major's expression
    (round-5 splicing-gate finding; the substitution bubble's true twin
    spans ~k k-mers between the same junctions, so error pruning is
    unaffected).  0 disables (falls back to sibling_ratio
    everywhere)."""

    @property
    def error_klen_effective(self) -> int:
        return self.k + 2

    # --- assembly ---------------------------------------------------------
    min_transcript_length: int = 200
    """Final transcripts shorter than this are dropped (reference
    filter_trans behavior, SURVEY.md §3.1; 200bp is the standard
    transcriptome threshold)."""

    min_output_abundance: float = 1.0
    """Final transcripts whose abundance estimate (min node abundance
    along the path) is below this are dropped: paths supported by a
    single read are error-island junk, not expression.  float32
    comparison.  0 disables.  Default re-chosen with the QUALITY.md
    sensitivity sweep: with error_branch_ratio cleaning single-error
    branches, 1.0 keeps exact recall at 100% on the pinned 20x dataset
    (86% precision) where 1.5 trades 5pp of recall for the last 14pp of
    precision — the wrong trade for an assembler whose claim is
    recovering every recoverable transcript (BASELINE north star)."""

    use_pairs: bool = True
    """Use paired-end mates + insert-size constraints in multibridging."""

    insert_size: int = 0
    """Mean fragment (insert) length of the paired-end library.  0 =
    estimate from the data (median implied fragment of pairs whose
    facing anchors land in the same contig).  Bounds which mate joins
    are geometrically possible (SURVEY.md §3.1 'with insert-size
    constraints', §6 'long context')."""

    insert_size_std: float = 0.0
    """Fragment length standard deviation.  0 = estimate (1.4826*MAD
    of the same sample, or 10% of insert_size when that is given)."""

    insert_cap_sigmas: float = 4.0
    """A mate join whose implied fragment exceeds mean + this*sigma is
    rejected; a multi-node gap join must land within +-this*sigma."""

    pair_gap_nodes: int = 3
    """Max intermediate contigs searched for an insert-licensed gap
    join between mate paths (repeats longer than a read but shorter
    than the insert are bridged through these)."""

    mb_noise_floor: float = 2.0
    """Multibridging evidence noise floor: at an X-node with total
    bridging evidence T >= 2*floor, pairings carrying weight <
    max(floor, T/8) are ignored — both for the fully-bridged test and
    for split-copy creation.  Why: error-carrying reads thread into
    surviving error branches and deposit weight-1 CROSS pairings at
    repeat nodes; counting them makes the node look fully bridged and
    splits it per observed pair, deleting the unobserved true pairing's
    continuation (measured on the paired repeat dataset: nodes with
    {true: 6-9, cross: 1} evidence split three ways and lost one of the
    two phasings — the 50% paired-recall stall).  Dropping noise either
    leaves the node unsplit (all in x out paths stay enumerable —
    recall-safe) or splits it on real pairings only.  Small totals
    (< 2*floor) keep every pairing, so low-coverage datasets are
    unaffected.  0 disables."""

    rescue_reads: bool = True
    """Read rescue (reference stage 3, SURVEY.md §3.1): use EVERY
    consistent run of a read's k-mers as bridging evidence, not only the
    longest — reads broken by a sequencing error or spanning a corrected
    region still contribute their fragments.  False = longest run only."""

    sf_restarts: int = 4
    """Randomized restarts for degenerate sparse-flow ties (paper §;
    SURVEY.md §4.3)."""

    sf_use_read_flows: bool = False
    """Experimental: use read-crossing counts per edge as sparse-flow
    margins instead of neighbor-abundance splits.  Measured on 100
    log-normal transcripts at 20x coverage: hurts (recall 92%->89%,
    precision 98%->95%) — crossing counts are high-variance at
    realistic coverage while contig abundances average over the whole
    contig.  Kept for high-coverage datasets where direct junction
    evidence may win."""

    sf_block_tol: float = 0.02
    """Sparse-flow exact-sparsest refinement: margins are partitioned
    into the maximum number of balanced blocks (per-block row/col sum
    imbalance <= this fraction of the node total) before the greedy
    max-min decomposition runs per block — min #nonzeros over the
    transport polytope is exactly m + n - max#blocks, which plain
    greedy can overshoot (oracle/sparseflow.block_decompose).  0
    disables (whole-node greedy, the pre-refinement behavior)."""

    sf_min_flow_frac: float = 0.02
    """Sparse-flow pairings carrying less than this fraction of the node's
    total flow are discarded as noise (the paper trims near-zero flows)."""

    max_paths_per_component: int = 10000
    """Safety cap on enumerated transcripts per component (pathological
    unresolved graphs); truncation is reported, never silent."""

    seed: int = 0
    """Seed for every randomized step (sparse-flow restarts); pinned for
    reproducibility so parity runs are deterministic (SURVEY.md §8 hard
    part 4)."""

    # --- device/layout parameters (TPU-side only; no effect on output) ---
    read_pad_length: int = 0
    """Device read-batch width in bases.  0 (default) = auto: sized to
    the dataset's longest read on the 32-base grid (96, 128, 160, ...)
    — never truncates, and the coarse grid keeps compiled shapes
    dataset-independent.  The supported envelope is any read length
    with batch_reads x windows packing into a 32-bit threading key
    (up to ~32k bases at the default batch_reads; 150bp Illumina
    libraries land on the 160 pad).  An explicit value pins the shape
    (required for multi-host byte-range ingest, where every host must
    agree) and TRUNCATES longer reads — documented, not silent."""

    kmer_capacity: int = 1 << 22
    """Fixed capacity of the on-device k-mer spectrum table (padded,
    sorted).  Must exceed the number of distinct k-mers in the dataset
    shard; the pipeline validates and reports overflow."""

    batch_reads: int = 1 << 16
    """Reads per device batch for the counting kernel."""

    # --- orchestration ----------------------------------------------------
    out_dir: str = "shannon_out"
    n_devices: int = 0
    """0 = use all visible devices."""

    resume: bool = True
    """Skip stages whose serialized outputs already exist in out_dir
    (the reference's files-as-checkpoints contract, SURVEY.md §6)."""

    multihost_backhalf: str = "ownership"
    """Multi-process assembly strategy (no effect single-process):
    'ownership' — each host assembles only the components it owns
    (owner = component label mod H); evidence routes to owners with one
    all_to_all and transcripts are union-gathered before the final
    dedupe.  Communication and back-half compute scale with 1/H of the
    graph instead of replicating everything (docs/SCALING.md item 3).
    'replicate' — all-gather all evidence, every host assembles
    redundantly (simple fallback; identical output)."""

    def __post_init__(self) -> None:
        if not (1 <= self.k <= 32):
            raise ValueError(f"k must be in [1, 32], got {self.k}")
        if self.min_abundance < 0:
            raise ValueError("min_abundance must be >= 0 (0 = auto)")
        if not (0.0 <= self.sibling_ratio < 1.0):
            raise ValueError("sibling_ratio must be in [0, 1)")
        if not (0.0 <= self.error_branch_ratio < 1.0):
            raise ValueError("error_branch_ratio must be in [0, 1)")
        if self.multihost_backhalf not in ("ownership", "replicate"):
            raise ValueError(
                "multihost_backhalf must be 'ownership' or 'replicate'"
            )

    # --- (de)serialization for stage checkpoints -------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "AssemblyConfig":
        return cls(**json.loads(text))

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> "AssemblyConfig":
        return cls.from_json(Path(path).read_text())
