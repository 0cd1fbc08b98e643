"""In-memory assembly on one device: the port's main path.

Counterpart of ``shannon_tpu.pipeline.assemble(reads, config,
backend="device")`` (single-end, single device):

  ingest -> count -> auto abundance cut -> correction -> tip clip +
  condensation -> components -> threading -> multibridging -> sparse flow
  -> enumeration -> dedupe -> transcripts.

Every tensor lives on the ``device`` passed to :func:`assemble`; on a CUDA
device the k-mer kernels K1-K3 run, on the CPU their plain versions.  The
host stages (clip rounds, materialization, components, MB, SF bookkeeping,
enumeration) are the reference's own code or copies of it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import ReadBatch, pack_reads
from shannon_tpu.oracle.assemble import AssemblyResult, dedupe_and_filter
from shannon_tpu.oracle.nodegraph import NodeGraph
from shannon_tpu.utils.timing import StageTimer
from shannon_tpu_torch.components import assemble_components, device_components
from shannon_tpu_torch.ops.condense import ContigArrays, build_contig_arrays, to_contig_graph
from shannon_tpu_torch.ops.correction import auto_min_abundance, correct_spectrum
from shannon_tpu_torch.ops.count import (
    Spectrum,
    count_reads_spectrum,
    shrink_spectrum,
    upload_words,
)
from shannon_tpu_torch.ops.kmers import check_k
from shannon_tpu_torch.ops.sparseflow import make_solver
from shannon_tpu_torch.ops.thread import (
    compact_thread_outputs,
    rect,
    runs_to_flat_paths,
    thread_reads_device_packed,
)
from shannon_tpu_torch.ops.tipclip import clip_tips_graph


def _sync(device: torch.device) -> None:
    """Wait for the device so a stage's wall time holds its own work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def spectrum_device(
    batch: ReadBatch,
    config: AssemblyConfig,
    device,
    timer: StageTimer | None = None,
) -> tuple[Spectrum, ContigArrays | None]:
    """Count + correct + tip-clip.  Returns (corrected spectrum, post-clip
    ContigArrays or None) — None when a merge closed a cycle and the caller
    must condense the spectrum itself (pipeline.py:41 _spectrum_device)."""
    device = torch.device(device)
    timer = timer or StageTimer(echo=False)
    canonical = not config.strand_specific
    t0 = time.perf_counter()
    spec = count_reads_spectrum(
        batch,
        k=config.k,
        capacity=config.kmer_capacity,
        canonical=canonical,
        batch_reads=config.batch_reads,
        device=device,
    )
    if spec.overflowed():
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
    """Single-end read threading -> flat evidence (flat node ids, row
    offsets, weights) for NodeGraph.set_paths_flat (single-end branch of
    pipeline.py:225 _thread_device).  Each batch's events and runs are
    compacted across reads on the device, so only real evidence crosses
    to the host."""
    t0 = time.perf_counter()
    rc = None if config.strand_specific else np.asarray(cgraph.rc_pair, np.int64)
    flats, offs_l, weights_l = [], [], []
    base = 0
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
        c_cid, c_run, c_p0, c_p1, _o0, _o1, n_ev, n_runs = (
            x.cpu().numpy() for x in compact_thread_outputs(*outs)
        )
        w, r = int(n_ev.max(initial=0)), int(n_runs.max(initial=0))
        fl, of, wt = runs_to_flat_paths(
            rect(c_cid, n_ev, w), rect(c_run, n_ev, w), n_ev,
            rect(c_p0, n_runs, r), rect(c_p1, n_runs, r),
            rc, rescue=config.rescue_reads,
        )
        flats.append(fl)
        offs_l.append(of[1:] + base)
        weights_l.append(wt)
        base += of[-1]
    t1 = time.perf_counter()
    if not flats:
        return np.empty(0, np.int64), np.zeros(1, np.int64), np.empty(0, np.int64)
    weights = np.concatenate(weights_l)
    timer.note("threading", kernel_s=round(t1 - t0, 3), n_evidence_paths=len(weights))
    return (
        np.concatenate(flats),
        np.concatenate([np.zeros(1, np.int64), *offs_l]),
        weights,
    )


def _assemble_backhalf(cgraph, comps, evidence, config: AssemblyConfig, device, timer: StageTimer):
    """NodeGraph build, bucket-scheduled MB + SF + enumeration, dedupe
    (single-process branch of pipeline.py:459 _assemble_device_backhalf)."""
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
        g, comps, config, solver=make_solver(device)
    )
    for name, secs in phase_s.items():
        timer.note(name, wall_s=round(secs, 3))
    with timer.stage("dedupe"):
        final = dedupe_and_filter(transcripts, config)
    return final, n_mb, n_sf, truncated


def assemble(
    reads: list[str],
    config: AssemblyConfig | None = None,
    *,
    device,
    timer: StageTimer | None = None,
    paired: bool = False,
) -> AssemblyResult:
    """In-memory end-to-end single-end assembly on `device` (a
    torch.device or its name).  Same stages, stage names and output as
    shannon_tpu.pipeline.assemble(reads, config, backend="device") on one
    device."""
    config = config or AssemblyConfig()
    if paired:
        raise NotImplementedError(
            "paired-end assembly is not ported yet (ROADMAP Queue 1, item 12)"
        )
    if config.n_devices > 1:
        raise NotImplementedError(
            "multi-device counting is not ported yet (ROADMAP Queue 1, item 14)"
        )
    check_k(config.k)
    device = torch.device(device)
    timer = timer or StageTimer(echo=False)

    with timer.stage("spectrum+graph", n_reads=len(reads)):
        t0 = time.perf_counter()
        batch = pack_reads(reads, pad_length=config.read_pad_length)
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
    stats = {
        "n_reads": len(reads),
        "n_kmers_final": n_alive,
        "n_contigs": cgraph.n,
        "n_components": len(comps),
        "n_mb_splits": n_mb,
        "n_sf_splits": n_sf,
        "n_transcripts": len(final),
        "truncated": truncated,
        "backend": f"torch:{device.type}",
    }
    timer.note("assembly", **{k: v for k, v in stats.items() if k != "backend"})
    return AssemblyResult(transcripts=final, stats=stats)
