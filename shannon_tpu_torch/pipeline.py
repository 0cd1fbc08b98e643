"""The port's entry points: assembly in memory and from files.

Counterparts of ``shannon_tpu.pipeline.assemble`` (in memory, single-end
or paired) and of ``shannon_tpu.pipeline.run_pipeline`` (files in, stage
checkpoints in an out-dir, resume), with the reference's two backends:

  ingest -> count -> auto abundance cut -> correction -> tip clip +
  condensation -> components -> threading -> multibridging -> sparse flow
  -> enumeration -> dedupe -> transcripts.

backend="device" (the default) runs that chain on a torch device;
backend="oracle" runs the reference's pure-Python oracle branches on the
port's copies of ``oracle/*``, on the host, with no device: it is the
caller's explicit choice, never a fallback of the device backend.

On the device backend, every tensor lives on the ``device`` passed in (the
first CUDA card by default); on a CUDA device the hand-written kernels run (K1-K3 k-mers,
K7-K10 correction, K4-K5 threading, K6 sparse flow), on the CPU their
plain versions.  With ``config.n_devices`` resolving to more than one shard
(``parallel.mesh.make_mesh``: 0 = every visible card), counting runs
sharded (``parallel.distributed``, K1, K2, K25 and K17), and the stages
after it run on ``device``.  In a process group of more than one rank
(``parallel.multihost``, torchrun), each rank ingests its own slice of the
input, counts it as one shard of the group's count, continues on the
replicated spectrum, and the back half either gathers every rank's evidence
('replicate') or routes each path to the rank that owns its component
('ownership', K26 and K27); rank 0 writes the shared artifacts.  The host
stages (clip rounds, materialization, components, pair joining, MB, SF
bookkeeping, enumeration) are copies of the reference's code.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from shannon_tpu_torch.components import assemble_components, device_components
from shannon_tpu_torch.config import AssemblyConfig
from shannon_tpu_torch.ingest import (
    ingest_paired_files,
    ingest_paired_files_range,
    normalize_mate2,
)
from shannon_tpu_torch.io.fastx import read_fastx, write_fasta
from shannon_tpu_torch.io.pack import ReadBatch, pack_reads
from shannon_tpu_torch.native import pack_file, pack_file_range
from shannon_tpu_torch.ops.condense import ContigArrays, build_contig_arrays, to_contig_graph
from shannon_tpu_torch.ops.correction import auto_min_abundance, correct_spectrum
from shannon_tpu_torch.ops.count import (
    Spectrum,
    count_reads_spectrum,
    shrink_spectrum,
    spectrum_from_arrays,
    upload_words,
)
from shannon_tpu_torch.ops.kmers import check_k
from shannon_tpu_torch.ops.sparseflow import make_solver
from shannon_tpu_torch.ops.thread import (
    compact_thread_outputs,
    paths_to_lists,
    rect,
    runs_to_flat_paths,
    thread_reads_device_packed,
)
from shannon_tpu_torch.ops.tipclip import clip_tips_graph
from shannon_tpu_torch.parallel import multihost
from shannon_tpu_torch.parallel.distributed import count_reads_spectrum_sharded
from shannon_tpu_torch.parallel.mesh import make_mesh
from shannon_tpu_torch.io.dna import encode_seq
from shannon_tpu_torch.oracle.assemble import (
    AssemblyResult,
    Transcript,
    dedupe_and_filter,
    enumerate_transcripts,
)
from shannon_tpu_torch.oracle.correction import clip_tips, correct_kmers
from shannon_tpu_torch.oracle.counting import count_kmers
from shannon_tpu_torch.oracle.graph import build_contigs
from shannon_tpu_torch.oracle.multibridge import expand_paths, multibridge, thread_reads
from shannon_tpu_torch.oracle.nodegraph import NodeGraph, _lists_to_flat
from shannon_tpu_torch.oracle.sparseflow import sparse_flow
from shannon_tpu_torch.utils.timing import StageTimer


def _sync(device: torch.device) -> None:
    """Wait for the device so a stage's wall time holds its own work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_config(config: AssemblyConfig, device) -> torch.device:
    """Refuse what the port does not run, and name the device to use.  A
    CUDA device without a card raises: there is no CPU fallback."""
    check_k(config.k)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but torch sees no CUDA device")
    return device


def spectrum_device(
    batch: ReadBatch,
    config: AssemblyConfig,
    device="cuda",
    timer: StageTimer | None = None,
    clip: bool = True,
) -> tuple[Spectrum, ContigArrays | None]:
    """Count + correct (+ tip-clip unless clip=False).  Returns (corrected
    spectrum, post-clip ContigArrays or None) — None when clip=False or a
    merge closed a cycle, and the caller must condense the spectrum itself
    (pipeline.py:41 _spectrum_device).  In a process group of more than
    one rank, `batch` is this rank's slice, and the count is the group's."""
    device = _check_config(config, device)
    timer = timer or StageTimer(echo=False)
    canonical = not config.strand_specific
    t0 = time.perf_counter()
    if multihost.world()[1] > 1:
        # one shard a rank; every rank continues on the replicated spectrum
        # (the graph stages are deterministic, so every rank builds the same
        # graph; evidence meets again in the back half)
        spec, overflowed = multihost.count_reads_spectrum_multihost(
            batch,
            k=config.k,
            capacity=config.kmer_capacity,
            canonical=canonical,
            batch_reads=config.batch_reads,
            device=device,
        )
        spec = multihost.localize_spectrum(spec, device)
        overflowed = overflowed or spec.overflowed()
    elif len(mesh := make_mesh(config.n_devices, device)) > 1:
        spec, overflowed = count_reads_spectrum_sharded(
            batch,
            k=config.k,
            capacity=config.kmer_capacity,
            mesh=mesh,
            canonical=canonical,
            batch_reads=config.batch_reads,
        )
        overflowed = overflowed or spec.overflowed()
    else:
        spec = count_reads_spectrum(
            batch,
            k=config.k,
            capacity=config.kmer_capacity,
            canonical=canonical,
            batch_reads=config.batch_reads,
            device=device,
        )
        overflowed = spec.overflowed()
    if overflowed:
        raise RuntimeError(
            f"kmer_capacity={config.kmer_capacity} overflowed; raise "
            "AssemblyConfig.kmer_capacity"
        )
    spec = shrink_spectrum(spec)
    _sync(device)
    t1 = time.perf_counter()
    timer.note("spectrum+graph", count_s=round(t1 - t0, 3), n_kmers_counted=spec.n)
    min_ab = config.min_abundance
    if min_ab == 0:
        min_ab = auto_min_abundance(spec)
        timer.note("spectrum+graph", auto_min_abundance=min_ab)
    spec = correct_spectrum(
        spec,
        config.k,
        min_ab,
        config.sibling_ratio,
        config.correction_rounds,
        canonical=canonical,
        error_rate=config.error_rate,
    )
    spec = shrink_spectrum(spec)
    _sync(device)
    t2 = time.perf_counter()
    timer.note("spectrum+graph", correct_s=round(t2 - t1, 3), n_kmers_corrected=spec.n)
    if not clip:
        return spec, None
    notes: dict = {}
    spec, ca = clip_tips_graph(spec, config, canonical=canonical, notes=notes)
    spec = shrink_spectrum(spec)
    _sync(device)
    timer.note(
        "spectrum+graph", tipclip_s=round(time.perf_counter() - t2, 3), **notes
    )
    return spec, ca


def _graph_device(batch: ReadBatch, config: AssemblyConfig, device, timer: StageTimer):
    """Spectrum + condensation; returns (host ContigGraph, #alive k-mers,
    ContigArrays) (pipeline.py:193 _graph_device)."""
    spec, ca = spectrum_device(batch, config, device, timer=timer)
    t0 = time.perf_counter()
    if ca is None:  # a merge closed a cycle
        ca = build_contig_arrays(spec, config.k, canonical=not config.strand_specific)
    _sync(device)
    t1 = time.perf_counter()
    g = to_contig_graph(ca, config.k, config)
    timer.note(
        "spectrum+graph",
        condense_s=round(t1 - t0, 3),
        materialize_s=round(time.perf_counter() - t1, 3),
    )
    return g, spec.n, ca


def _thread_device(
    batch: ReadBatch, ca: ContigArrays, cgraph, config: AssemblyConfig, device,
    timer: StageTimer,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read threading -> flat evidence (flat node ids, row offsets,
    weights) for NodeGraph.set_paths_flat (pipeline.py:225 _thread_device).
    Each batch runs K1, K3, K4 and K5 on the device, so only real events
    and runs cross to the host.  Single-end evidence is then built
    vectorized (runs_to_flat_paths); the paired path row-dedups (pairs as
    units) and runs the Python pair joining over unique rows only.

    The reference first shrinks the node table to its real nodes
    (slice_nodes_for_threading) because its sort join costs the table's
    lanes; K3 is a binary search, which costs only log(lanes), so the port
    threads the table as it is."""
    t0 = time.perf_counter()
    paired = batch.paired and config.use_pairs
    parts: list[dict] = []
    for s in range(0, batch.n_reads, config.batch_reads):
        e = min(s + config.batch_reads, batch.n_reads)
        m = batch.mask_rows(s, e)
        outs = thread_reads_device_packed(
            upload_words(batch.words[s:e], device),
            torch.from_numpy(batch.lengths[s:e]).to(device),
            ca,
            config.k,
            length=batch.pad_length,
            mask=None if m is None else upload_words(m, device),
        )
        c_cid, c_run, c_p0, c_p1, c_o0, c_o1, n_ev, n_runs = (
            x.cpu().numpy() for x in compact_thread_outputs(*outs)
        )
        w, r = int(n_ev.max(initial=0)), int(n_runs.max(initial=0))
        d = {
            "ev_cid": rect(c_cid, n_ev, w), "ev_run": rect(c_run, n_ev, w),
            "n_events": n_ev,
            "run_p0": rect(c_p0, n_runs, r), "run_p1": rect(c_p1, n_runs, r),
        }
        if paired:
            d.update(run_o0=rect(c_o0, n_runs, r), run_o1=rect(c_o1, n_runs, r),
                     lengths=batch.lengths[s:e])
        parts.append(d)
    if not parts:
        return np.empty(0, np.int64), np.zeros(1, np.int64), np.empty(0, np.int64)
    t1 = time.perf_counter()
    if paired:
        return _paired_evidence(parts, cgraph, config, timer, kernel_s=t1 - t0)

    rc = None if config.strand_specific else np.asarray(cgraph.rc_pair, np.int64)
    flats, offs_l, weights_l = [], [], []
    base = 0
    for d in parts:
        fl, of, wt = runs_to_flat_paths(
            d["ev_cid"], d["ev_run"], d["n_events"], d["run_p0"], d["run_p1"],
            rc, rescue=config.rescue_reads,
        )
        flats.append(fl)
        offs_l.append(of[1:] + base)
        weights_l.append(wt)
        base += of[-1]
    weights = np.concatenate(weights_l)
    timer.note(
        "threading",
        kernel_s=round(t1 - t0, 3),
        build_s=round(time.perf_counter() - t1, 3),
        n_evidence_paths=len(weights),
    )
    return (
        np.concatenate(flats),
        np.concatenate([np.zeros(1, np.int64), *offs_l]),
        weights,
    )


# copied from shannon_tpu/pipeline.py:358-420 (paired branch of _thread_device)
def _paired_evidence(parts: list[dict], cgraph, config: AssemblyConfig, timer: StageTimer,
                     kernel_s: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paired evidence: dedup the threading rows with mate pairs as units,
    turn the unique rows into Run lists (paths_to_lists), join the facing
    mates under the insert-size constraint and add RC twins
    (expand_paths)."""
    t1 = time.perf_counter()
    W = max(d["ev_cid"].shape[1] for d in parts)
    R = max(d["run_p0"].shape[1] for d in parts)

    def wide(a: np.ndarray, target: int) -> np.ndarray:
        if target > a.shape[1]:
            return np.pad(a, ((0, 0), (0, target - a.shape[1])), constant_values=-1)
        return a

    rows_all = np.vstack([
        np.hstack([
            wide(d["ev_cid"], W), wide(d["ev_run"], W), d["n_events"][:, None],
            wide(d["run_p0"], R), wide(d["run_p1"], R),
            wide(d["run_o0"], R), wide(d["run_o1"], R), d["lengths"][:, None],
        ])
        for d in parts
    ])
    ncol = rows_all.shape[1]
    group = 2 if rows_all.shape[0] % 2 == 0 else 1
    grouped = rows_all.reshape(-1, group * ncol)
    uniq, first, counts = np.unique(grouped, axis=0, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")  # keep first-occurrence order
    uniq, counts = uniq[order], counts[order]
    urows = uniq.reshape(-1, ncol)
    c = 2 * W + 1
    raw = paths_to_lists(
        urows[:, :W],                     # ev_cid
        urows[:, W : 2 * W],              # ev_run
        urows[:, 2 * W],                  # n_events
        urows[:, c : c + R],              # run_p0
        urows[:, c + R : c + 2 * R],      # run_p1
        urows[:, c + 2 * R : c + 3 * R],  # run_o0
        urows[:, c + 3 * R : c + 4 * R],  # run_o1
        rescue=config.rescue_reads,
    )
    pw = np.repeat(counts, group).astype(int).tolist()
    read_lengths = urows[:, c + 4 * R].astype(int).tolist()
    t2 = time.perf_counter()
    paths, path_weights = expand_paths(
        raw, cgraph, config, paired=True, weights=pw, read_lengths=read_lengths
    )
    flat, offs = _lists_to_flat(paths)
    timer.note(
        "threading",
        kernel_s=round(kernel_s, 3),
        dedup_s=round(t2 - t1, 3),
        expand_s=round(time.perf_counter() - t2, 3),
        unique_rows=len(urows),
    )
    return flat, offs, np.asarray(path_weights, np.int64)


def _assemble_backhalf(cgraph, comps, evidence, config: AssemblyConfig, device, timer: StageTimer):
    """Evidence distribution (multi-process), NodeGraph build,
    bucket-scheduled MB + SF + enumeration, the union over ranks, dedupe
    (pipeline.py:459 _assemble_device_backhalf).

    In a process group of H > 1 ranks (config.multihost_backhalf):
      * 'ownership': component c belongs to rank c[0] mod H; each path goes
        to its component's owner (route_evidence_ownership: K26, one
        all_to_all_single, K27), each rank assembles the components it
        owns, and the raw transcripts are gathered before the dedupe, which
        does not depend on their order;
      * 'replicate': every rank gathers all evidence and assembles every
        component."""
    rank, n_ranks = multihost.world()
    ownership = n_ranks > 1 and config.multihost_backhalf == "ownership"
    my_comps = comps
    if ownership:
        owner = np.zeros(cgraph.n, np.int64)
        for comp in comps:
            owner[comp] = comp[0] % n_ranks
        vol: dict = {}
        evidence = multihost.route_evidence_ownership(*evidence, owner, device, volumes=vol)
        my_comps = [c for c in comps if c[0] % n_ranks == rank]
        timer.note("assembly", owned_components=len(my_comps), **vol)
    elif n_ranks > 1:
        evidence = multihost.gather_evidence(*evidence)
        timer.note("assembly", gathered_paths=len(evidence[2]))
    t0 = time.perf_counter()
    g = NodeGraph.from_contig_graph(cgraph)
    t1 = time.perf_counter()
    g.set_paths_flat(*evidence)
    timer.note(
        "assembly",
        graph_build_s=round(t1 - t0, 3),
        evidence_s=round(time.perf_counter() - t1, 3),
    )
    transcripts, n_mb, n_sf, truncated, phase_s = assemble_components(
        g, my_comps, config, solver=make_solver(device)
    )
    for name, secs in phase_s.items():
        timer.note(name, wall_s=round(secs, 3))
    if ownership:
        transcripts = multihost.gather_transcripts(transcripts)
        n_mb, n_sf, any_truncated = multihost.allreduce_stats(n_mb, n_sf, int(truncated))
        truncated = bool(any_truncated)
    with timer.stage("dedupe"):
        final = dedupe_and_filter(transcripts, config)
    return final, n_mb, n_sf, truncated


BACKENDS = ("device", "oracle")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def _spectrum_oracle(reads: list[str], config: AssemblyConfig) -> dict[int, int]:
    """The oracle's counted, corrected and clipped spectrum (pipeline.py:423
    _spectrum_oracle, then clip_tips)."""
    counts = count_kmers(reads, config.k, config.strand_specific)
    return clip_tips(correct_kmers(counts, config), config)


def _thread_oracle(reads: list[str], cgraph, config: AssemblyConfig, paired: bool):
    """The oracle's evidence: (paths, path weights) of every read."""
    return thread_reads([encode_seq(s) for s in reads], cgraph, config, paired=paired)


def _backhalf_oracle(cgraph, paths, path_weights, config: AssemblyConfig, timer: StageTimer):
    """The oracle's back half on the whole graph, each step a stage of
    `timer`: MB, SF with the host solver, enumeration, dedupe
    (pipeline.py:686-697)."""
    g = NodeGraph.from_contig_graph(cgraph, paths, path_weights)
    with timer.stage("multibridge"):
        n_mb = multibridge(g, config)
    with timer.stage("sparseflow"):
        n_sf = sparse_flow(g, config, solver=None)
    with timer.stage("enumerate"):
        transcripts, truncated = enumerate_transcripts(g, config)
    with timer.stage("dedupe"):
        final = dedupe_and_filter(transcripts, config)
    return final, n_mb, n_sf, truncated


def assemble(
    reads: list[str],
    config: AssemblyConfig | None = None,
    *,
    backend: str = "device",
    device="cuda",
    timer: StageTimer | None = None,
    paired: bool = False,
) -> AssemblyResult:
    """In-memory end-to-end assembly (pipeline.py:635 assemble).  backend:
    "device" runs on `device` (a torch.device or its name; the first CUDA
    card unless the caller asks for "cpu"), "oracle" the pure-Python oracle
    on the host (`device` unused); any other raises ValueError.  paired:
    reads are interleaved [L0, R0, L1, R1, ...] with mate 2 as sequenced
    (it is orientation-normalized here).  Same stages, stage names and
    output as shannon_tpu.pipeline.assemble(reads, config, backend) on one
    device."""
    config = config or AssemblyConfig()
    _check_backend(backend)
    timer = timer or StageTimer(echo=False)
    if paired:
        reads = normalize_mate2(reads)

    if backend == "oracle":
        with timer.stage("spectrum", n_reads=len(reads)):
            alive = _spectrum_oracle(reads, config)
            n_alive = len(alive)
        with timer.stage("graph"):
            cgraph = build_contigs(alive, config)
            comps = cgraph.components()
        with timer.stage("threading"):
            paths, path_weights = _thread_oracle(reads, cgraph, config, paired)
        with timer.stage("assembly"):
            final, n_mb, n_sf, truncated = _backhalf_oracle(
                cgraph, paths, path_weights, config, timer
            )
        label = backend
    else:
        device = _check_config(config, device)
        with timer.stage("spectrum+graph", n_reads=len(reads)):
            t0 = time.perf_counter()
            batch = pack_reads(reads, pad_length=config.read_pad_length, paired=paired)
            timer.note("spectrum+graph", ingest_s=round(time.perf_counter() - t0, 3))
            cgraph, n_alive, ca = _graph_device(batch, config, device, timer)
        with timer.stage("partition"):
            comps = device_components(ca)
        with timer.stage("threading"):
            evidence = _thread_device(batch, ca, cgraph, config, device, timer)
        del ca  # threading was the last consumer of the node tables
        with timer.stage("assembly"):
            final, n_mb, n_sf, truncated = _assemble_backhalf(
                cgraph, comps, evidence, config, device, timer
            )
        label = f"torch:{device.type}"
    stats = {
        "n_reads": len(reads),
        "n_kmers_final": n_alive,
        "n_contigs": cgraph.n,
        "n_components": len(comps),
        "n_mb_splits": n_mb,
        "n_sf_splits": n_sf,
        "n_transcripts": len(final),
        "truncated": truncated,
        "backend": label,
    }
    timer.note("assembly", **{k: v for k, v in stats.items() if k != "backend"})
    return AssemblyResult(transcripts=final, stats=stats)


# ---------------------------------------------------------------------
# File-based pipeline with stage checkpoints (the reference CLI contract)
# ---------------------------------------------------------------------


def _ingest(single: str | None, left: str | None, right: str | None, pad_length: int,
            multi: bool) -> ReadBatch:
    """The reads of this process: all of them, or in a process group this
    rank's share (pipeline.py:756-830): a byte range of a single-end file
    (pack_file_range; an explicit pad, so every rank packs one shape), a
    pair-aligned record range of two mate files (ingest_paired_files_range),
    or, for gzip and for paired files without an explicit pad, a contiguous
    pair-aligned record slice of the whole input."""
    if single is not None:
        if multi and not str(single).endswith(".gz"):
            if pad_length == 0:
                raise ValueError(
                    "multi-process byte-range ingest needs an explicit read_pad_length "
                    "(auto sizing would let ranks disagree on shapes)"
                )
            lo, hi = multihost.host_byte_range(single)
            return pack_file_range(single, lo, hi, pad_length=pad_length)
        batch = pack_file(single, pad_length=pad_length)
    elif left is not None and right is not None:
        if multi and pad_length:
            return ingest_paired_files_range(left, right, pad_length)
        batch = ingest_paired_files(left, right, pad_length=pad_length)
    else:
        raise ValueError("provide --single or --left/--right")
    return batch.rows(multihost.host_read_slice(batch.n_reads)) if multi else batch


def _load_reads(path: Path) -> ReadBatch:
    data = np.load(path)
    return ReadBatch(
        words=data["words"],
        lengths=data["lengths"],
        paired=bool(data["paired"]),
        pad_length=int(data["pad_length"]),
        mask=data["mask"] if "mask" in data.files else None,
    )


def _spectrum_arrays(spec: Spectrum) -> tuple[np.ndarray, np.ndarray]:
    """The checkpoint format: sorted uint64 keys and int64 counts."""
    n = spec.n
    return (
        spec.key[:n].cpu().numpy().astype(np.uint64),
        spec.count[:n].cpu().numpy().astype(np.int64),
    )


def _write_result(fasta: Path, final, rank: int, n_reads: int, n_kmers: int, cgraph, comps,
                  n_mb: int, n_sf: int, truncated: bool, backend: str) -> AssemblyResult:
    """transcripts.fasta (rank 0 writes it) and the run's AssemblyResult."""
    if rank == 0:
        write_fasta(
            fasta,
            [(f"shannon_tpu_{i} abundance={t.abundance:.4f}", t.seq)
             for i, t in enumerate(final)],
        )
    return AssemblyResult(
        transcripts=final,
        stats={
            "n_reads": n_reads,
            "n_kmers_final": n_kmers,
            "n_contigs": cgraph.n,
            "n_components": len(comps),
            "n_mb_splits": n_mb,
            "n_sf_splits": n_sf,
            "n_transcripts": len(final),
            "truncated": truncated,
            "backend": backend,
        },
    )


def run_pipeline(
    config: AssemblyConfig,
    single: str | None = None,
    left: str | None = None,
    right: str | None = None,
    *,
    backend: str = "device",
    device="cuda",
) -> AssemblyResult:
    """File in -> out-dir artifacts -> transcripts.fasta
    (pipeline.py:719 run_pipeline), on `device` with backend="device", on
    the host with backend="oracle" (`device` unused); any other backend
    raises ValueError.

    Stage artifacts, each skipped on re-run when present and
    config.resume, and the same in both packages for the same backend, so
    either can resume from the other's out-dir:
      reads.npz               ingested, packed reads
      spectrum_corrected.npz  counted + corrected spectrum (before tip
                              clip; the device backend only)
      spectrum.npz            final spectrum (kmers uint64, counts int64)
      transcripts.fasta       the output
    plus config.json, timing.log and stats.json.

    In a process group of more than one rank, each rank keeps its own reads
    checkpoint, reads.p{rank}.npz; every other artifact rank 0 alone
    writes.  On the device backend those are the same on every rank; the
    oracle backend, as the reference's, assembles each rank's own reads and
    rank 0 writes its own."""
    _check_backend(backend)
    oracle = backend == "oracle"
    if not oracle:
        device = _check_config(config, device)
    rank, n_ranks = multihost.world()
    multi = n_ranks > 1
    out = Path(config.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if rank == 0:
        (out / "config.json").write_text(config.to_json())
    timer = StageTimer(out_dir=out if rank == 0 else None)
    if multi:
        timer.note("distributed", backend=multihost.backend(), world_size=n_ranks)
    canonical = not config.strand_specific

    reads_npz = out / (f"reads.p{rank}.npz" if multi else "reads.npz")
    if config.resume and reads_npz.exists():
        batch = _load_reads(reads_npz)
        timer.note("ingest", skipped=True, n_reads=batch.n_reads)
    else:
        with timer.stage("ingest"):
            batch = _ingest(single, left, right, config.read_pad_length, multi)
            np.savez_compressed(
                reads_npz,
                words=batch.words,
                lengths=batch.lengths,
                paired=batch.paired,
                pad_length=batch.pad_length,
                **({"mask": batch.mask} if batch.mask is not None else {}),
            )
        timer.note("ingest", n_reads=batch.n_reads, total_bases=batch.total_bases)

    spectrum_npz = out / "spectrum.npz"
    ca_live = None  # post-clip ContigArrays when the clip ran in-process
    alive = None  # the oracle's spectrum when it ran in-process
    if config.resume and spectrum_npz.exists():
        data = np.load(spectrum_npz)
        keys, vals = data["kmers"], data["counts"]
        timer.note("spectrum", skipped=True, n_kmers=len(keys))
    elif oracle:
        with timer.stage("spectrum", n_reads=batch.n_reads):
            alive = _spectrum_oracle(batch.sequences(), config)
            keys = np.fromiter(alive.keys(), dtype=np.uint64, count=len(alive))
            vals = np.fromiter(alive.values(), dtype=np.int64, count=len(alive))
            order = np.argsort(keys)
            keys, vals = keys[order], vals[order]
        if rank == 0:
            np.savez_compressed(spectrum_npz, kmers=keys, counts=vals)
        timer.note("spectrum", n_kmers=len(keys))
    else:
        with timer.stage("spectrum", n_reads=batch.n_reads):
            # checkpoint between counting + correction and tip clipping, so
            # a later failure does not redo the count
            corrected_npz = out / "spectrum_corrected.npz"
            if config.resume and corrected_npz.exists():
                d = np.load(corrected_npz)
                spec = spectrum_from_arrays(d["kmers"], d["counts"], device=device)
            else:
                spec, _ = spectrum_device(batch, config, device, clip=False, timer=timer)
                if rank == 0:
                    kmers, counts = _spectrum_arrays(spec)
                    np.savez_compressed(corrected_npz, kmers=kmers, counts=counts)
            spec, ca_live = clip_tips_graph(spec, config, canonical=canonical)
            keys, vals = _spectrum_arrays(spec)
        if rank == 0:
            np.savez_compressed(spectrum_npz, kmers=keys, counts=vals)
        timer.note("spectrum", n_kmers=len(keys))

    fasta = out / "transcripts.fasta"
    if config.resume and fasta.exists():
        transcripts = [
            Transcript(seq=seq, abundance=float(h.split("abundance=")[1]))
            for h, seq in read_fastx(fasta)
        ]
        result = AssemblyResult(transcripts=transcripts, stats={"resumed": True})
        timer.note("assembly", skipped=True, n_transcripts=len(transcripts))
    elif oracle:
        with timer.stage("graph"):
            if alive is None:
                alive = {int(k): int(c) for k, c in zip(keys, vals)}
            cgraph = build_contigs(alive, config)
            comps = cgraph.components()
        with timer.stage("threading"):
            paths, path_weights = _thread_oracle(batch.sequences(), cgraph, config, batch.paired)
        with timer.stage("assembly"):
            # the reference times the back half as one stage here
            final, n_mb, n_sf, truncated = _backhalf_oracle(
                cgraph, paths, path_weights, config, StageTimer(echo=False)
            )
        result = _write_result(fasta, final, rank, batch.n_reads, len(keys), cgraph, comps,
                               n_mb, n_sf, truncated, backend)
        timer.note("assembly", n_transcripts=len(final))
    else:
        with timer.stage("graph"):
            if ca_live is not None:  # the clip already condensed it
                ca = ca_live
            else:
                ca = build_contig_arrays(
                    spectrum_from_arrays(keys, vals, device=device), config.k,
                    canonical=canonical,
                )
            cgraph = to_contig_graph(ca, config.k, config)
        with timer.stage("partition"):
            comps = device_components(ca)
        with timer.stage("threading"):
            evidence = _thread_device(batch, ca, cgraph, config, device, timer)
        del ca, ca_live  # threading was the last consumer of the node tables
        with timer.stage("assembly"):
            final, n_mb, n_sf, truncated = _assemble_backhalf(
                cgraph, comps, evidence, config, device, timer
            )
        result = _write_result(fasta, final, rank, batch.n_reads, len(keys), cgraph, comps,
                               n_mb, n_sf, truncated, f"torch:{device.type}")
        timer.note("assembly", n_transcripts=len(final))
    timer.flush_stats(extra={"result": result.stats})
    return result
