"""Port parity: read threading (K1 or K24 forward keys + K3 node lookup, run
scan, row compaction), the across-read compaction and the single-end evidence
driver, against shannon_tpu.ops.thread and the single-end branch of
shannon_tpu.pipeline._thread_device on JAX-CPU.  Both packages thread
through the same ContigArrays (via convert).

Tolerance: exact — every output array equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops import thread as jth
from shannon_tpu.ops.condense import build_contig_arrays, to_contig_graph
from shannon_tpu.ops.correction import correct_spectrum
from shannon_tpu.ops.count import count_spectrum_packed
from shannon_tpu.pipeline import _thread_device as ref_thread_device
from shannon_tpu.sim import sample_reads, simulate_isoforms, simulate_transcripts
from shannon_tpu.utils.timing import StageTimer
from shannon_tpu_torch import convert
from shannon_tpu_torch.ops import thread as tth
from shannon_tpu_torch.ops.condense import to_contig_graph as port_contig_graph
from shannon_tpu_torch.pipeline import _thread_device


def _setup(k: int, seed: int, strand_specific: bool = False, with_n: bool = False):
    rng = np.random.default_rng(seed)
    ts = simulate_transcripts(rng, n=2, length=300) + simulate_isoforms(rng, exon_length=120)
    reads = sample_reads(rng, ts, coverage=15, read_length=70, error_rate=0.01)
    if with_n:
        reads = [r[:30] + "N" + r[31:] if i % 7 == 0 else r for i, r in enumerate(reads)]
    cfg = AssemblyConfig(k=k, strand_specific=strand_specific, batch_reads=256)
    b = pack_reads(reads, pad_length=96)
    canonical = not strand_specific
    spec = count_spectrum_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), k, 1 << 15, canonical, b.pad_length,
        None if b.mask is None else jnp.asarray(b.mask),
    )
    spec = correct_spectrum(spec, k, 1, 0.1, 8, canonical, error_rate=0.01)
    ref_ca = build_contig_arrays(spec, k, canonical)
    port_ca = convert.contig_arrays_from_numpy(*(np.asarray(x) for x in ref_ca.tree_flatten()[0]))
    return cfg, b, ref_ca, port_ca


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("with_n", [False, True])
def test_thread_reads_matches_reference(k, with_n):
    cfg, b, ref_ca, port_ca = _setup(k, seed=k, with_n=with_n)
    mask = b.mask
    ref = jth.thread_reads_device_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), ref_ca, k, b.pad_length,
        None if mask is None else jnp.asarray(mask),
    )
    port = tth.thread_reads_device_packed(
        torch.from_numpy(b.words.view(np.int32)), torch.from_numpy(b.lengths), port_ca, k,
        b.pad_length, None if mask is None else torch.from_numpy(mask.view(np.int32)),
    )
    names = "ev_cid ev_run n_events run_p0 run_p1 run_o0 run_o1".split()
    for name, p, r in zip(names, port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)

    # across-read compaction: the reference's flat arrays up to its totals
    r_comp = jth.compact_thread_outputs(*ref)
    tot_e, tot_r = (int(x) for x in np.asarray(r_comp[-1]))
    p_comp = tth.compact_thread_outputs(*port)
    for j, p in enumerate(p_comp[:6]):
        tot = tot_e if j < 2 else tot_r
        np.testing.assert_array_equal(p.numpy(), np.asarray(r_comp[j])[:tot])
    np.testing.assert_array_equal(p_comp[6].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(p_comp[7].numpy(), np.asarray(r_comp[6]))


@pytest.mark.parametrize("k", [15, 24, 31])
@pytest.mark.parametrize("with_n", [False, True])
def test_thread_reads_from_codes_matches_reference(k, with_n):
    """The uint8 route (K24, K3, K4) == ops/thread.py:40
    thread_reads_device, and == the packed route on the same reads."""
    cfg, b, ref_ca, port_ca = _setup(k, seed=k + 1, with_n=with_n)
    codes = b.codes
    ref = jth.thread_reads_device(jnp.asarray(codes), jnp.asarray(b.lengths), ref_ca, k)
    lengths = torch.from_numpy(b.lengths)
    port = tth.thread_reads_device(torch.from_numpy(codes), lengths, port_ca, k)
    packed = tth.thread_reads_device_packed(
        torch.from_numpy(b.words.view(np.int32)), lengths, port_ca, k, b.pad_length,
        None if b.mask is None else torch.from_numpy(b.mask.view(np.int32)),
    )
    names = "ev_cid ev_run n_events run_p0 run_p1 run_o0 run_o1".split()
    for name, p, r, q in zip(names, port, ref, packed):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)
        assert torch.equal(p, q), name
    assert int(port[2].sum()) > 0


@pytest.mark.parametrize("strand_specific", [False, True])
@pytest.mark.parametrize("rescue", [True, False])
def test_single_end_evidence_matches_reference(strand_specific, rescue):
    cfg, b, ref_ca, port_ca = _setup(21, seed=3, strand_specific=strand_specific)
    cfg = AssemblyConfig(
        k=21, strand_specific=strand_specific, batch_reads=256, rescue_reads=rescue
    )
    ref_g = to_contig_graph(ref_ca, 21, cfg)
    port_g = port_contig_graph(port_ca, 21, cfg)
    ref_ev = ref_thread_device(b, ref_ca, ref_g, cfg)
    port_ev = _thread_device(b, port_ca, port_g, cfg, torch.device("cpu"), StageTimer(echo=False))
    for p, r in zip(port_ev, ref_ev):
        np.testing.assert_array_equal(p, r)
    assert len(port_ev[2]) > 0


def test_rect_rebuilds_rows():
    flat = np.array([5, 6, 7, 8, 9])
    out = tth.rect(flat, np.array([2, 0, 3]), 4)
    assert out.tolist() == [[5, 6, -1, -1], [-1, -1, -1, -1], [7, 8, 9, -1]]


def _window_rows(seed: int, N: int = 64, W: int = 9):
    """Random lookups of N rows of W windows over a 40-lane node table:
    about half the windows hit, a sixth are invalid, and a quarter of the
    lanes are at contig offset 0; row 0 alternates hit and miss (the most
    runs a row can hold), row 1 hits everywhere, row 2 nowhere."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, 40, (N, W)))
    hit = torch.from_numpy(rng.random((N, W)) < 0.5)
    valid = torch.from_numpy(rng.random((N, W)) < 5 / 6)
    hit[0], valid[0] = torch.arange(W) % 2 == 0, True
    hit[1], valid[1] = True, True
    hit[2] = False
    node_cid = torch.from_numpy(rng.integers(0, 12, 40))
    node_off = torch.from_numpy(np.where(rng.random(40) < 0.25, 0, rng.integers(1, 30, 40)))
    return idx, hit, valid, node_cid, node_off


def _thread_rows_loop(idx, hit, valid, node_cid, node_off):
    """The spec as one loop per row (oracle.multibridge.thread_read_runs on
    lookups): events at run starts and offset-0 windows, runs (p0, p1, o0,
    o1), every row -1-padded."""
    N, W = idx.shape
    R = tth.max_runs(W)
    out = [np.full((N, W), -1), np.full((N, W), -1), np.zeros(N, np.int64)] + [
        np.full((N, R), -1) for _ in range(4)
    ]
    ev_cid, ev_run, n_events, p0, p1, o0, o1 = out
    for r in range(N):
        h = [bool(hit[r, j] and valid[r, j]) for j in range(W)]
        runs = -1
        for j in range(W):
            if not h[j]:
                continue
            cid, off = int(node_cid[idx[r, j]]), int(node_off[idx[r, j]])
            start = j == 0 or not h[j - 1]
            if start:
                runs += 1
                p0[r, runs], o0[r, runs] = j, off
            if start or off == 0:
                ev_cid[r, n_events[r]], ev_run[r, n_events[r]] = cid, runs
                n_events[r] += 1
            if j == W - 1 or not h[j + 1]:
                p1[r, runs], o1[r, runs] = j, off
    return out


@pytest.mark.parametrize("W", [1, 2, 9, 105])
def test_thread_windows_plain_matches_the_row_loop(W):
    """K4's plain twin (the kernel's reference on the card) against the
    per-row loop, including a row with the most runs R - 1."""
    args = _window_rows(W, W=W)
    got = tth.thread_windows(*args)
    for g, w in zip(got, _thread_rows_loop(*args)):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)
    assert int((got[3][0] >= 0).sum()) == (W + 1) // 2


@pytest.mark.parametrize("N", [0, 1, 7])
def test_compact_thread_outputs_edge_rows_match_reference(N):
    """Empty batches and rows without events (K5's plain twin against the
    reference's sort compaction)."""
    rows = tth.thread_windows(*(a[:N] if a.dim() == 2 else a for a in _window_rows(5, W=9)))
    if N:
        for t in rows:
            t[N // 2] = -1 if t.dim() == 2 else 0  # one row without events or runs
    ref = jth.compact_thread_outputs(*(jnp.asarray(t.numpy()) for t in rows))
    tot_e, tot_r = (int(x) for x in np.asarray(ref[-1]))
    got = tth.compact_thread_outputs(*rows)
    for j, p in enumerate(got[:6]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(ref[j])[: tot_e if j < 2 else tot_r])
    np.testing.assert_array_equal(got[6].numpy(), rows[2].numpy())
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(ref[6]))


# ---- K5's one-pass design, transcribed ---------------------------------------

K5_RUN_BITS = 31


def _k4_rows(N: int, W: int, pattern: str, seed: int):
    """K4's rows (its plain twin, the layout the kernel writes) for N reads
    of W windows over a 50-lane node table: "random" (70% hits, 5% invalid,
    a fifth of the offsets 0), "none" (no hit), "events" (every window hit
    at offset 0: a full event row) or "alternate" (R - 1 runs a row)."""
    rng = np.random.default_rng(seed)
    hit = {"random": rng.random((N, W)) < 0.7, "none": np.zeros((N, W), bool),
           "events": np.ones((N, W), bool),
           "alternate": np.tile(np.arange(W) % 2 == 0, (N, 1))}[pattern]
    valid = rng.random((N, W)) < 0.95 if pattern == "random" else np.ones((N, W), bool)
    idx = rng.integers(0, 50, (N, W))
    off = np.where(rng.random(50) < 0.2, 0, rng.integers(1, 60, 50))
    if pattern == "events":
        off[:] = 0
    return tth.thread_windows_plain(*(torch.from_numpy(x) for x in (
        idx, hit, valid, rng.integers(0, 1000, 50), off)))


def _k5_runs(run_p0: np.ndarray, r: int) -> int:
    """A warp's count of row r's runs: ballots over 32 lanes of run_p0 at a
    time, going on only while a chunk is all real."""
    R, runs = run_p0.shape[1], 0
    for j0 in range(0, R, 32):
        chunk = [j0 + lane < R and run_p0[r, j0 + lane] >= 0 for lane in range(32)]
        runs += sum(chunk)
        if not all(chunk):
            break
    return runs


def _k5_stretch_copy(ex: np.ndarray, total: int, row0: int, width: int, srcs, dsts, base: int):
    """A warp's copy of its stretch: entry k goes to lane k % 32, which finds
    its row by a binary search of the 32 lanes' exclusive counts (lanes
    past the warp's rows hold the total) and copies that row's lane."""
    for k in range(total):
        q = 0
        for step in (16, 8, 4, 2, 1):
            if ex[q + step] <= k:
                q += step
        for dst, src in zip(dsts, srcs):
            dst[base + k] = src[row0 + q, k - ex[q]]


def _k5_transcription(rows, tile_rows: int, rows_per_warp: int):
    """csrc/thread.cu compact_rows_kernel in numpy: tiles of tile_rows rows,
    warps of rows_per_warp rows (lane q row q); each lane's events << 31 |
    runs; the block's exclusive scan in thread order; the tile's prefix, the
    aggregates of the tiles before it (what the look-back of scan.cuh adds
    up); then each warp's stretch copy.  The flat outputs are poisoned at
    capacity and sliced to the total, the last tile's inclusive value."""
    ev_cid, ev_run, n_events, p0, p1, o0, o1 = (t.numpy() for t in rows)
    N, W = ev_cid.shape
    R = p0.shape[1]
    warps, mask = tile_rows // rows_per_warp, (1 << K5_RUN_BITS) - 1
    tiles = -(-N // tile_rows)
    # lane values of every tile, thread order; row -1 where a lane holds none
    row = np.full((tiles, warps, 32), -1)
    row[:, :, :rows_per_warp] = np.arange(tiles * tile_rows).reshape(tiles, warps, rows_per_warp)
    row[row >= N] = -1
    value = np.array([0 if r < 0 else (int(n_events[r]) << K5_RUN_BITS) | _k5_runs(p0, r)
                      for r in row.reshape(-1)], dtype=np.int64).reshape(tiles, warps * 32)
    aggregate = value.sum(1)
    at = (np.cumsum(aggregate) - aggregate)[:, None] + np.cumsum(value, 1) - value
    flat_e = [np.full(N * W, -7) for _ in range(2)]
    flat_r = [np.full(N * R, -7) for _ in range(4)]
    n_runs = np.full(N, -7)
    for r, v in zip(row.reshape(-1), value.reshape(-1)):
        if r >= 0:
            n_runs[r] = int(v) & mask
    for t in range(tiles):
        for w in range(warps):
            v = value[t, 32 * w:32 * (w + 1)]
            ex = np.cumsum(v) - v
            a = int(at[t, 32 * w])
            row0 = t * tile_rows + w * rows_per_warp
            _k5_stretch_copy(ex >> K5_RUN_BITS, int(v.sum()) >> K5_RUN_BITS, row0, W,
                             (ev_cid, ev_run), flat_e, a >> K5_RUN_BITS)
            _k5_stretch_copy(ex & mask, int(v.sum()) & mask, row0, R, (p0, p1, o0, o1), flat_r,
                             a & mask)
    total = int(aggregate.sum())
    tot_e, tot_r = total >> K5_RUN_BITS, total & mask
    return [t[:tot_e] for t in flat_e] + [t[:tot_r] for t in flat_r] + [n_runs]


@pytest.mark.parametrize("N,W,pattern", [
    (0, 9, "random"), (1, 9, "random"), (1, 105, "alternate"), (7, 33, "none"),
    (9, 64, "events"), (64, 105, "random"), (65, 105, "random"), (130, 9, "random"),
    (130, 105, "alternate"), (200, 64, "events"), (129, 31, "none"), (600, 33, "random"),
])
@pytest.mark.parametrize("tile_rows,rows_per_warp", [(256, 32), (8, 4)])
def test_k5_one_pass_transcription_matches_reference(N, W, pattern, tile_rows, rows_per_warp):
    """K5's design (a warp's ballot count of each row's runs, one 64-bit
    scan value of events and runs, tile offsets by look-back, each warp's
    stretch copied 32 entries at a time) against the reference's sort compaction, at row
    counts that fill no tile, one, and part of the next, with rows without
    a hit, full event rows and rows of R - 1 runs (more than 32)."""
    rows = _k4_rows(N, W, pattern, seed=N * 1000 + W)
    ref = jth.compact_thread_outputs(*(jnp.asarray(t.numpy()) for t in rows))
    tot_e, tot_r = (int(x) for x in np.asarray(ref[-1]))
    got = _k5_transcription(rows, tile_rows, rows_per_warp)
    for j, g in enumerate(got[:6]):
        np.testing.assert_array_equal(g, np.asarray(ref[j])[: tot_e if j < 2 else tot_r])
    np.testing.assert_array_equal(got[6], np.asarray(ref[6]))
    if pattern == "alternate":
        assert int(np.asarray(ref[6]).max()) == tth.max_runs(W) - 1
    if pattern == "none":
        assert tot_e == tot_r == 0
