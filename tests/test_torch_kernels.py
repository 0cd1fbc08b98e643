"""The hand-written CUDA kernels K1-K29 against their plain PyTorch
versions, correction, condensation, the flagship count-and-correct step,
the sharded count and dryrun_multichip, and the port's assembly (single-end,
paired and sharded) on CUDA against the CPU run.
Marked
`cuda`: these need an NVIDIA GPU and nvcc and skip without them.  Run on
the card with

    python -m pytest tests/test_torch_kernels.py -m cuda

Tolerance: exact — integer outputs equal elementwise, the same
transcripts."""

import numpy as np
import pytest
import torch

from shannon_tpu_torch import kernels
from shannon_tpu_torch.config import AssemblyConfig
from shannon_tpu_torch.io.dna import revcomp_str
from shannon_tpu_torch.io.pack import pack_reads
from shannon_tpu_torch.ops import condense as tcd
from shannon_tpu_torch.ops import correction as tcor
from shannon_tpu_torch.ops import tipclip as ttc
from shannon_tpu_torch.ops.count import (
    Spectrum, count_reads_spectrum, empty_spectrum, merge_at, merge_at_plain, spectrum_from_arrays,
    tight_capacity,
)
from shannon_tpu_torch.sim import (
    random_seq, sample_paired_reads, sample_reads, simulate_gene_isoforms,
)
from shannon_tpu_torch.utils.timing import StageTimer
from shannon_tpu_torch.ops import sparseflow as tsf
from shannon_tpu_torch.ops import spectrum as tsp
from shannon_tpu_torch.ops import thread as tth
from shannon_tpu_torch.ops.count import reduce_sorted, reduce_sorted_plain
from shannon_tpu_torch.ops.kmers import (
    PAD, canonical_key, extract_kmers_packed, extract_kmers_packed_plain,
)
from shannon_tpu_torch.ops.spectrum import lookup_sorted, lookup_sorted_plain
from shannon_tpu_torch.pipeline import assemble, spectrum_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _batch(seed: int, n: int = 3000):
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, size=int(rng.integers(10, 128))))
        if rng.random() < 0.1:
            p = int(rng.integers(0, len(s)))
            s = s[:p] + "N" + s[p + 1 :]
        reads.append(s)
    return pack_reads(reads, pad_length=128)


@pytest.mark.parametrize("k", [1, 5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_extract_kmers_kernel_matches_plain(cuda, k, canonical, with_mask):
    b = _batch(k)
    words = torch.from_numpy(b.words.view(np.int32))
    lengths = torch.from_numpy(b.lengths)
    mask = torch.from_numpy(b.mask.view(np.int32)) if with_mask else None
    want = extract_kmers_packed_plain(words, lengths, k, canonical, 128, mask)
    got = extract_kmers_packed(
        words.to(cuda), lengths.to(cuda), k, canonical, 128,
        None if mask is None else mask.to(cuda),
    )
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def extract_case(pad: int, k: int, n: int = 777, seed: int = 0):
    """Packed reads for K1's shapes, as numpy arrays made from a seed: n rows
    at `pad` bases (lengths 0..pad, some shorter than k), an N mask word a
    row with bits at bases 31, 32, 63 and 64 where the pad has them and a
    few at random, and the pad length K1 is asked for (the pad itself; W =
    pad - k + 1 is not a multiple of 32 for most pads)."""
    from shannon_tpu_torch.io.pack import pack_words

    rng = np.random.default_rng(seed + pad + 100 * k)
    codes = rng.integers(0, 4, (n, pad)).astype(np.uint8)
    lengths = rng.integers(0, pad + 1, n).astype(np.int32)
    lengths[: n // 4] = pad
    lengths[n // 4 : n // 3] = rng.integers(0, k, n // 3 - n // 4)  # shorter than k
    bad = np.zeros((n, pad), bool)
    for i, p in enumerate(b for b in (31, 32, 63, 64) if b < pad):
        bad[i::5, p] = True
    bad[rng.random((n, pad)) < 0.002] = True
    wm = -(-pad // 32)
    bits = np.zeros((n, 32 * wm), np.uint32)
    bits[:, :pad] = bad
    shifts = np.arange(32 * wm, dtype=np.uint32) % 32
    mask = (bits << shifts).reshape(n, wm, 32).sum(axis=2, dtype=np.uint32)
    return pack_words(codes), lengths, mask, pad


@pytest.mark.parametrize("pad", [64, 100, 150, 256])
@pytest.mark.parametrize("k", [1, 16, 24, 31])
@pytest.mark.parametrize("with_mask", [True, False])
def test_extract_kmers_kernel_shapes(cuda, pad, k, with_mask):
    """K1 at pad lengths 64-256 (rows of 4-16 words, W not a multiple of
    32), reads shorter than k, mask bits on either side of the 32-base mask
    words' edges, both canonical modes: keys and valid equal the plain
    version's."""
    words, lengths, mask, length = extract_case(pad, k)
    args = [torch.from_numpy(words.view(np.int32)), torch.from_numpy(lengths)]
    m = torch.from_numpy(mask.view(np.int32)) if with_mask else None
    for canonical in (True, False):
        want = extract_kmers_packed_plain(*args, k, canonical, length, m)
        got = extract_kmers_packed(*(x.to(cuda) for x in args), k, canonical, length,
                                   None if m is None else m.to(cuda))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _equal(g.cpu(), w, "keys and valid")


def test_extract_kmers_kernel_long_rows(cuda):
    """Rows too long for a block to stage (12,500 words and 6,250 mask words
    a row) are read in place: still equal to the plain version."""
    words, lengths, mask, length = extract_case(200_000, 31, n=3)
    args = [torch.from_numpy(words.view(np.int32)), torch.from_numpy(lengths)]
    m = torch.from_numpy(mask.view(np.int32))
    for mm in (m, None):
        want = extract_kmers_packed_plain(*args, 31, True, length, mm)
        got = extract_kmers_packed(*(x.to(cuda) for x in args), 31, True, length,
                                   None if mm is None else mm.to(cuda))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _equal(g.cpu(), w, "keys and valid")


@pytest.mark.parametrize("capacity", [1, 1000, 1 << 16])
@pytest.mark.parametrize("merge", [False, True])
def test_reduce_sorted_kernel_matches_plain(cuda, capacity, merge):
    rng = np.random.default_rng(capacity)
    keys = np.sort(rng.integers(0, 5000, size=20000)).astype(np.int64)
    keys = torch.from_numpy(np.concatenate([keys, np.full(777, PAD, np.int64)]))
    counts = None
    if merge:
        counts = torch.from_numpy(rng.integers(1, 9, size=keys.shape[0]).astype(np.int32))
        counts[keys == PAD] = 0
    want = reduce_sorted_plain(keys, counts, capacity)
    got = reduce_sorted(keys.to(cuda), None if counts is None else counts.to(cuda), capacity)
    torch.cuda.synchronize()
    n = want[3]
    assert got[3] == n
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    c = min(n, capacity)
    assert torch.equal(got[2][:c].cpu(), want[2][:c])


@pytest.mark.parametrize("keys", [[], [PAD] * 5, [7] * 9])
def test_reduce_sorted_kernel_edge_cases(cuda, keys):
    t = torch.tensor(keys, dtype=torch.int64)
    want = reduce_sorted_plain(t, None, 4)
    got = reduce_sorted(t.to(cuda), None, 4)
    assert got[3] == want[3]
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


# Lanes a tile of K2's and K10's single-pass scan takes, and the sizes that
# pin its edges: empty, one lane, a tile less one, one tile, one tile and
# one lane, three tiles and one lane.
TILE = kernels.SCAN_TILE
EDGE_SIZES = [0, 1, TILE - 1, TILE, TILE + 1, 3 * TILE + 1]
RUN_SHAPES = ["all_pad", "one_key_three_tiles", "run_ends_on_tile_edge",
              "overflow_inside_tile"]


def run_case(shape: str, m: int = 0, seed: int = 0):
    """Sorted int64 keys (PAD last), int32 counts (0 on PAD lanes) and an
    output capacity, as numpy arrays made from a seed.  "random": m keys in
    runs of a few lanes with a PAD tail, capacity m + 3; "all_pad": 3 tiles
    and a lane of PAD; "one_key_three_tiles": one key over lanes [5, 3 TILE
    + 40), counts near 2^20 so its sum needs more than a tile's worth;
    "run_ends_on_tile_edge": one key over tile 0 exactly, then runs of 64
    lanes, the last ending on tile 2's edge; "overflow_inside_tile": runs of
    two lanes over 3 tiles and a lane, capacity inside tile 2's slots, so n
    > capacity."""
    rng = np.random.default_rng(seed + m + len(shape))
    if shape == "random":
        keys = np.sort(rng.integers(0, max(m // 3, 1), size=m)).astype(np.int64)
        keys[m - m // 7:] = PAD
        cap = m + 3
    elif shape == "all_pad":
        keys, cap = np.full(3 * TILE + 1, PAD, np.int64), 100
    elif shape == "one_key_three_tiles":
        keys = np.concatenate([np.arange(5), np.full(3 * TILE + 35, 77),
                               100 + np.arange(TILE // 2), np.full(100, PAD)]).astype(np.int64)
        cap = TILE
    elif shape == "run_ends_on_tile_edge":
        keys = np.concatenate([np.full(TILE, 7), 8 + np.arange(2 * TILE) // 64,
                               np.full(77, PAD)]).astype(np.int64)
        cap = 3 * TILE
    elif shape == "overflow_inside_tile":
        keys = (np.arange(3 * TILE + 1) // 2).astype(np.int64)
        cap = 2 * (TILE // 2) + 1000
    else:
        raise ValueError(shape)
    big = shape == "one_key_three_tiles"
    counts = rng.integers((1 << 20) - 9 if big else 1, (1 << 20) if big else 10,
                          size=keys.shape[0]).astype(np.int32)
    counts[keys == PAD] = 0
    return keys, counts, cap


def _reduce_both(cuda, keys, counts, cap):
    """K2 on the card against its plain version on the same CUDA inputs:
    keys, counts and n over the whole capacity, starts below min(n, cap)."""
    lib = kernels.library()
    before = lib.launches["reduce_sorted"]
    got = reduce_sorted(keys, counts, cap)
    assert lib.launches["reduce_sorted"] == before + 1
    want = reduce_sorted_plain(keys, counts, cap)
    torch.cuda.synchronize()
    assert got[3] == want[3]
    _equal(got[0], want[0], "key")
    _equal(got[1], want[1], "count")
    c = min(want[3], cap)
    _equal(got[2][:c], want[2][:c], "start")
    return want[3]


@pytest.mark.parametrize("m", EDGE_SIZES)
@pytest.mark.parametrize("merge", [False, True])
def test_reduce_sorted_kernel_at_tile_edges(cuda, m, merge):
    keys, counts, cap = run_case("random", m)
    _reduce_both(cuda, torch.from_numpy(keys).to(cuda),
                 torch.from_numpy(counts).to(cuda) if merge else None, cap)


@pytest.mark.parametrize("shape", RUN_SHAPES)
@pytest.mark.parametrize("merge", [False, True])
def test_reduce_sorted_kernel_run_shapes(cuda, shape, merge):
    """Runs over tile edges (a run longer than two tiles, a run ending on an
    edge), all PAD, and n > capacity with the capacity inside a tile."""
    keys, counts, cap = run_case(shape)
    n = _reduce_both(cuda, torch.from_numpy(keys).to(cuda),
                     torch.from_numpy(counts).to(cuda) if merge else None, cap)
    assert (shape == "overflow_inside_tile") == (n > cap)


def _stress_inputs(cuda, lanes: int = 1 << 24):
    rng = np.random.default_rng(24)
    keys = torch.sort(torch.from_numpy(rng.integers(0, lanes // 3, size=lanes)).to(cuda)).values
    keys[-lanes // 9:] = PAD
    counts = torch.from_numpy(rng.integers(1, 50, size=lanes).astype(np.int32)).to(cuda)
    counts[keys == PAD] = 0
    keep = torch.from_numpy(rng.random(lanes) < 0.3).to(cuda)
    return keys, counts, keep


def test_scan_kernels_stress(cuda):
    """50 calls each of K2 (unit and merge) and K10 at 2^24 lanes, each held
    to the plain version: a race in the look-back shows as one call that
    differs."""
    keys, counts, keep = _stress_inputs(cuda)
    cap = keys.shape[0]
    spec = Spectrum(key=keys, count=counts, n=cap)
    wants = [reduce_sorted_plain(keys, None, cap), reduce_sorted_plain(keys, counts, cap)]
    want_c = tcor.compact_plain(spec, keep)
    for _ in range(50):
        for c, want in zip((None, counts), wants):
            got = reduce_sorted(keys, c, cap)
            assert got[3] == want[3]
            _equal(got[0], want[0], "key")
            _equal(got[1], want[1], "count")
            _equal(got[2][:want[3]], want[2][:want[3]], "start")
        got_c = tcor.compact(spec, keep)
        assert got_c.n == want_c.n
        _equal(got_c.key, want_c.key, "compacted key")
        _equal(got_c.count, want_c.count, "compacted count")


def test_lookup_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    table = np.unique(rng.integers(0, 1 << 48, size=100_000, dtype=np.int64))
    table = torch.from_numpy(np.concatenate([table, np.full(1000, PAD, np.int64)]))
    query = torch.from_numpy(
        np.concatenate([rng.choice(table.numpy(), 50_000), rng.integers(0, 1 << 48, 50_000)])
    ).reshape(100, 1000)
    want = lookup_sorted_plain(table, query)
    got = lookup_sorted(table.to(cuda), query.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_kernel_wrappers_validate_inputs(cuda):
    words = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    lengths = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        extract_kmers_packed(words, lengths, 21)
    with pytest.raises(ValueError, match="int64"):
        lookup_sorted(torch.zeros(4, dtype=torch.int64, device=cuda), torch.zeros(3, device=cuda))


def _threading_rows(cuda, k: int, with_n: bool):
    """A batch's node lookups on the card: reads of simulated isoforms,
    their own corrected graph (K1-K3), then K1 forward keys and K3."""
    rng = np.random.default_rng(k)
    ts, _ = simulate_gene_isoforms(rng, n_genes=2)
    reads = sample_reads(rng, ts, coverage=15, read_length=100, error_rate=0.01)
    if with_n:
        reads = [r[:40] + "N" + r[41:] if i % 5 == 0 else r for i, r in enumerate(reads)]
    b = pack_reads(reads, pad_length=128)
    cfg = AssemblyConfig(k=k, kmer_capacity=1 << 16)
    _, ca = spectrum_device(b, cfg, cuda)
    assert ca is not None
    words = torch.from_numpy(b.words.view(np.int32)).to(cuda)
    mask = torch.from_numpy(b.mask.view(np.int32)).to(cuda) if b.mask is not None else None
    assert (mask is not None) == with_n
    keys, valid = extract_kmers_packed(words, torch.from_numpy(b.lengths).to(cuda), k, False, 128, mask)
    idx, hit = lookup_sorted(ca.node_key, keys)
    return idx, hit, valid, ca.node_cid, ca.node_off


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("with_n", [False, True])
def test_thread_kernels_match_plain(cuda, k, with_n):
    """K4 (per-row run scan) and K5 (across-read compaction)."""
    args = _threading_rows(cuda, k, with_n)
    got = tth.thread_windows(*args)
    want = tth.thread_windows_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(want[2].sum()) > 0
    got_c = tth.compact_thread_outputs(*want)
    want_c = tth.compact_thread_outputs_plain(*want)
    torch.cuda.synchronize()
    for g, w in zip(got_c, want_c):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_thread_kernels_edge_shapes(cuda):
    """No rows, one window per row, and rows with no hit."""
    for N, W in ((0, 9), (5, 1), (4, 9)):
        idx = torch.zeros((N, W), dtype=torch.int64, device=cuda)
        hit = torch.zeros((N, W), dtype=torch.bool, device=cuda)
        hit[: N // 2] = True
        valid = torch.ones_like(hit)
        table = torch.zeros(1, dtype=torch.int64, device=cuda)
        args = (idx, hit, valid, table, table)
        want = tth.thread_windows_plain(*args)
        for g, w in zip(tth.thread_windows(*args), want):
            assert torch.equal(g, w)
        for g, w in zip(tth.compact_thread_outputs(*want), tth.compact_thread_outputs_plain(*want)):
            assert torch.equal(g, w)


def _thread_case(N: int, W: int, pattern: str, seed: int):
    """[N, W] window rows of one hit pattern against a random 50-lane node
    table (a fifth of its offsets 0): "random" (70% hits, 5% invalid),
    "none", "all" (runs broken only by offset 0) or "alternate" (R - 1 runs
    a row).  Returns (idx, hit, valid, node_cid, node_off) and the clamped
    idx the plain version gathers: the kernel's idx is out of range wherever
    the window misses, where the lookup's contract makes it meaningless."""
    rng = np.random.default_rng(seed)
    if pattern == "random":
        hit = rng.random((N, W)) < 0.7
    elif pattern == "none":
        hit = np.zeros((N, W), bool)
    elif pattern == "all":
        hit = np.ones((N, W), bool)
    else:
        hit = np.zeros((N, W), bool)
        hit[:, 0::2] = True
    valid = rng.random((N, W)) < 0.95 if pattern == "random" else np.ones((N, W), bool)
    lanes = rng.integers(0, 50, (N, W))
    idx = np.where(hit, lanes, rng.integers(1 << 40, 1 << 41, (N, W)))
    cid = rng.integers(0, 1000, 50)
    off = np.where(rng.random(50) < 0.2, 0, rng.integers(1, 60, 50))
    return [torch.from_numpy(x) for x in (idx, hit, valid, cid, off, np.where(hit, lanes, 0))]


@pytest.mark.parametrize("W", [1, 2, 31, 32, 33, 64, 105, 160])
@pytest.mark.parametrize("N", [0, 1, 7, 9])
@pytest.mark.parametrize("pattern", ["random", "none", "all", "alternate"])
def test_thread_rows_kernel_shapes(cuda, W, N, pattern):
    """K4 (a warp a row, chunks of 32 windows) at widths on both sides of
    the chunk edges, row counts that leave a block's warps idle, and rows
    with no hit, every hit, and R - 1 runs."""
    idx, hit, valid, cid, off, clamped = _thread_case(N, W, pattern, 1000 * W + N)
    want = tth.thread_windows_plain(clamped, hit, valid, cid, off)
    got = tth.thread_windows(*(x.to(cuda) for x in (idx, hit, valid, cid, off)))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    if pattern == "alternate" and N:
        assert int((want[3] >= 0).sum(1).max()) == tth.max_runs(W) - 1


def _sf_jobs(seed: int, B: int) -> np.ndarray:
    """Random 1-8 x 1-8 margins; every fourth job all ties, every fourth
    zero margins (nothing to pair), the rest real-valued or small integers."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((B, 2 * tsf.MAXD + 1), np.int32)
    f = buf[:, : 2 * tsf.MAXD].view(np.float32)
    for r in range(B):
        M, N = int(rng.integers(1, 9)), int(rng.integers(1, 9))
        kind = r % 4
        if kind == 0:
            a, b = np.full(M, 2.0, np.float32), np.full(N, np.float32(2.0 * M / N))
        elif kind == 1:
            continue
        elif kind == 2:
            a = rng.integers(1, 4, M).astype(np.float32)
            b = rng.integers(1, 4, N).astype(np.float32)
        else:
            a = rng.uniform(0.1, 50, M).astype(np.float32)
            b = rng.uniform(0.1, 50, N).astype(np.float32)
        f[r, :M] = a
        f[r, tsf.MAXD : tsf.MAXD + N] = b
    buf[:, 2 * tsf.MAXD] = rng.integers(0, 1 << 32, B, dtype=np.int64).astype(np.uint32).view(np.int32)
    return buf


@pytest.mark.parametrize("restarts", [0, 1, 4])
def test_sf_greedy_kernel_matches_plain(cuda, restarts):
    """K6: flow tensors bit-equal, picks equal."""
    buf = torch.from_numpy(_sf_jobs(restarts, 4096)).to(cuda)
    got = tsf.batched_greedy_packed(buf, restarts)
    want = tsf.batched_greedy_packed_plain(buf, restarts)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int64 and got[0].dtype == torch.float32


def _greedy_jobs(kind: str, B: int = 2048, M: int = tsf.MAXD, N: int = tsf.MAXD):
    """K29's inputs: random real margins, degenerate ties (all equal small
    integers) or near-zero margins beside a large one; a seed each, hashed
    ties on every other job."""
    rng = np.random.default_rng(len(kind) * 100 + M * 10 + N)
    if kind == "random":
        a = rng.uniform(0.1, 50, (B, M)).astype(np.float32)
        b = rng.uniform(0.1, 50, (B, N)).astype(np.float32)
    elif kind == "ties":
        a = np.full((B, M), 2.0, np.float32)
        b = np.full((B, N), np.float32(2.0 * M / N), np.float32)
    else:
        a = np.full((B, M), 1e-7, np.float32)
        a[:, 0] = 3.0
        b = np.full((B, N), np.float32(1e-8), np.float32)
        b[:, -1] = np.float32(3.0 + 1e-7 * (M - 1))
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, B, dtype=np.int64))
    return torch.from_numpy(a), torch.from_numpy(b), seeds, torch.arange(B) % 2 == 1


@pytest.mark.parametrize("kind", ["random", "ties", "tiny"])
@pytest.mark.parametrize("shape", [(8, 8), (3, 5), (1, 8)])
@pytest.mark.parametrize("max_steps", [16, 4])
def test_sf_jobs_kernel_matches_plain(cuda, kind, shape, max_steps):
    """K29: flow tensors bit-equal to the plain version's."""
    args = _greedy_jobs(kind, M=shape[0], N=shape[1])
    got = tsf.batched_greedy(*(x.to(cuda) for x in args), max_steps)
    want = tsf.batched_greedy_plain(*args, max_steps)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2048, *shape)
    assert torch.equal(got.view(torch.int32).cpu(), want.view(torch.int32))
    assert (want > 0).any()


def test_sf_jobs_winning_rows_equal_k6(cuda):
    """K29 on each job's K = 5 restart rows (restart_rows), the winner
    chosen by best_restart, equals K6's flow tensors."""
    buf = torch.from_numpy(_sf_jobs(4, 4096)).to(cuda)
    F = tsf.batched_greedy(*tsf.restart_rows(buf, 4)).reshape(4096, 5, tsf.MAXD, tsf.MAXD)
    want, _picks = tsf.batched_greedy_packed(buf, 4)
    got = F[torch.arange(4096, device=cuda), tsf.best_restart(F)]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_sf_jobs_kernel_validates_inputs(cuda):
    a, b, seeds, use_hash = (x.to(cuda) for x in _greedy_jobs("random", B=4))
    wide = torch.ones((4, tsf.MAXD + 1), device=cuda)
    for bad in ((wide, b, seeds, use_hash, 16), (a, wide, seeds, use_hash, 16),
                (a, b, seeds, use_hash, 0), (a, b, seeds, use_hash, 2 * tsf.MAXD + 1),
                (a, b, seeds[:3], use_hash, 16)):
        with pytest.raises(ValueError):
            tsf.batched_greedy(*bad)
    with pytest.raises(TypeError, match="float32"):
        tsf.batched_greedy(a.double(), b, seeds, use_hash)


def test_sf_greedy_kernel_validates_inputs(cuda):
    with pytest.raises(TypeError, match="int32"):
        tsf.batched_greedy_packed(torch.zeros((4, 17), dtype=torch.int64, device=cuda), 4)
    with pytest.raises(ValueError, match=r"\[B, 17\]"):
        tsf.batched_greedy_packed(torch.zeros((4, 16), dtype=torch.int32, device=cuda), 4)


# Kernels assembly never launches: those of the flagship step alone
# (shannon_tpu_torch.entry), K24, whose uint8 codes only dryrun_multichip
# counts and threads, and K28 and K29, which the reference runs in its tests
# only.
NOT_IN_ASSEMBLY = ("lookup_counts", "sibling_maxes", "prune_keep", "extract_codes",
                   "neighbor_counts", "sf_jobs")
# Kernels that run only in a multi-process run in 'ownership' mode (K26, K27);
# these assemblies run in one process.
MULTIHOST_ONLY = ("ownership_pack", "ownership_unpack")


def _assert_all_launched(launches: dict, timer: StageTimer, sharded: bool = False) -> None:
    """Every kernel of assembly launched; K8 (rescue) only runs when the
    auto cut is above 1, K13's cycle_round only when the labels found a
    cycle, K25 only when the count is sharded, K26 and K27 (MULTIHOST_ONLY)
    only in a multi-process run.  These datasets' clips doom
    contigs and close no cycle, so K18 and K19 must run (the clip's notes
    say so: tc_drop_s and tc_remap_s)."""
    notes = timer.stages["spectrum+graph"]
    assert "tc_drop_s" in notes and "tc_remap_s" in notes, notes
    cut = notes["auto_min_abundance"]
    missing = [
        n for n, c in launches.items()
        if c == 0 and not (n == "rescue_rounds" and cut == 1) and n != "cycle_round"
        and n not in NOT_IN_ASSEMBLY and not (n == "owner_buckets" and not sharded)
        and n not in MULTIHOST_ONLY
    ]
    assert not missing, launches


def _spectrum(k: int, canonical: bool = True, seed: int = 0) -> Spectrum:
    """A counted spectrum of simulated isoform reads, on the CPU."""
    rng = np.random.default_rng(seed + k)
    ts, _ = simulate_gene_isoforms(rng, n_genes=2)
    reads = sample_reads(rng, ts, coverage=15, read_length=100, error_rate=0.01)
    b = pack_reads(reads, pad_length=128)
    return count_reads_spectrum(b, k=k, capacity=1 << 16, canonical=canonical, device="cpu")


def _to(spec: Spectrum, dev) -> Spectrum:
    return Spectrum(key=spec.key.to(dev), count=spec.count.to(dev), n=spec.n)


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("side", ["sib", "ext"])
@pytest.mark.parametrize("canonical", [True, False])
def test_probe_lookup_kernel_matches_plain(cuda, k, side, canonical):
    """K7 equals its plain version on all 8 x C lanes, pad lanes included."""
    spec = _to(_spectrum(k, canonical), cuda)
    got = tcor.probe_resolve(spec, k, canonical, side)
    want = tcor.probe_resolve_plain(spec, k, canonical, side)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("cut", [1, 2, 3])
@pytest.mark.parametrize("error_rate", [0.0, 0.01])
def test_round_kernels_match_plain(cuda, k, cut, error_rate):
    """K8 (the whole rescue loop, k + 2 rounds) and K9 (every round of the
    prune loop) as correct_spectrum runs them, from the cut counts; and K10
    on the final keep mask."""
    spec = _to(_spectrum(k), cuda)
    sib = tcor.probe_resolve_plain(spec, k, True, "sib")
    ext = tcor.probe_resolve_plain(spec, k, True, "ext")
    raw, counts = tcor.cut_counts(spec, cut)
    got = tcor.rescue_rounds(counts, raw, *sib, *ext, k + 2)
    want = tcor.rescue_rounds_plain(counts, raw, *sib, *ext, k + 2)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    counts = want[0]
    ratio, eps3 = tcor.prune_constants(0.1, error_rate)
    for _ in range(8):
        got = tcor.prune_round(counts, *sib, ratio, eps3, error_rate > 0)
        want = tcor.prune_round_plain(counts, *sib, ratio, eps3, error_rate > 0)
        assert torch.equal(got[0], want[0]) and got[1] == want[1]
        if not want[1]:
            break
        counts = want[0]
    got, want = tcor.compact(spec, counts > 0), tcor.compact_plain(spec, counts > 0)
    assert got.n == want.n
    assert torch.equal(got.key, want.key) and torch.equal(got.count, want.count)


def prune_grid(max_c: int = 255, max_m: int = 4095):
    """K9's float grid: every count 1..max_c against every sibling maximum
    1..max_m, on the right side and on the left.  Lanes [0, max_m) hold the
    sibling counts 1..max_m and probe nothing; each later lane has count c,
    one hit row of its side pointing at the lane of count m and one at a
    lane of count m // 2 (the max must pick m).  Returns the numpy (counts,
    idx, hit) of K9's inputs and the (c, m) of the grid lanes."""
    c, m = np.meshgrid(np.arange(1, max_c + 1), np.arange(1, max_m + 1), indexing="ij")
    c, m = np.tile(c.ravel(), 2), np.tile(m.ravel(), 2)
    side = np.repeat([0, 1], c.size // 2)
    lanes = max_m + np.arange(c.size)
    counts = np.concatenate([np.arange(1, max_m + 1), c]).astype(np.int32)
    idx = np.zeros((8, max_m + c.size), np.int64)
    hit = np.zeros(idx.shape, bool)
    idx[side, lanes], hit[side, lanes] = m - 1, True
    idx[side + 4, lanes], hit[side + 4, lanes] = np.maximum(m // 2, 1) - 1, True
    return counts, idx, hit, c, m


@pytest.mark.parametrize("error_rate", [0.0, 0.01, 0.02])
def test_prune_round_kernel_float_grid(cuda, error_rate):
    """K9 bit-exact with its plain version where an FMA or a square root
    that is not correctly rounded would show: every count 1..255 against
    every sibling maximum 1..4095."""
    counts, idx, hit = (torch.from_numpy(a).to(cuda) for a in prune_grid()[:3])
    ratio, eps3 = tcor.prune_constants(0.1, error_rate)
    got = tcor.prune_round(counts, idx, hit, ratio, eps3, error_rate > 0)
    want = tcor.prune_round_plain(counts, idx, hit, ratio, eps3, error_rate > 0)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert want[1]  # the grid prunes some lanes


@pytest.mark.parametrize("keep", ["none", "all", "random"])
def test_compact_kernel_edge_masks(cuda, keep):
    spec = _to(_spectrum(24), cuda)
    mask = {
        "none": torch.zeros(spec.capacity, dtype=torch.bool, device=cuda),
        "all": torch.ones(spec.capacity, dtype=torch.bool, device=cuda),
        "random": torch.from_numpy(np.random.default_rng(1).random(spec.capacity) < 0.3).to(cuda),
    }[keep]
    got, want = tcor.compact(spec, mask), tcor.compact_plain(spec, mask)
    assert got.n == want.n
    assert torch.equal(got.key, want.key) and torch.equal(got.count, want.count)


def keep_case(C: int, keep: str, seed: int = 0):
    """A sorted table of C lanes (int64 keys, int32 counts) and a keep mask,
    as numpy arrays made from a seed: "all" keeps every lane of a table with
    no PAD; "none" and "random" (30% of the real lanes) run on a table whose
    last C // 5 lanes are PAD."""
    rng = np.random.default_rng(seed + C + len(keep))
    n_real = C if keep == "all" else C - C // 5
    keys = np.full(C, PAD, np.int64)
    keys[:n_real] = np.sort(rng.choice(1 << 40, size=n_real, replace=False))
    counts = np.where(keys == PAD, 0, rng.integers(1, 100, size=C)).astype(np.int32)
    mask = {"all": np.ones(C, bool), "none": np.zeros(C, bool),
            "random": (rng.random(C) < 0.3) & (keys != PAD)}[keep]
    return keys, counts, mask


@pytest.mark.parametrize("C", EDGE_SIZES)
@pytest.mark.parametrize("keep", ["all", "none", "random"])
def test_compact_kernel_at_tile_edges(cuda, C, keep):
    """K10 at the tile-edge sizes, every lane kept, none or 30%."""
    keys, counts, mask = keep_case(C, keep)
    spec = Spectrum(key=torch.from_numpy(keys).to(cuda),
                    count=torch.from_numpy(counts).to(cuda), n=C)
    mask = torch.from_numpy(mask).to(cuda)
    lib = kernels.library()
    before = lib.launches["compact_keep"]
    got = tcor.compact(spec, mask)
    assert lib.launches["compact_keep"] == before + 1
    want = tcor.compact_plain(spec, mask)
    torch.cuda.synchronize()
    assert got.n == want.n
    _equal(got.key, want.key, "key")
    _equal(got.count, want.count, "count")


def test_scan_kernels_on_unaligned_views(cuda):
    """K10 and K2 on views that start one lane into their storage, where the
    kernels cannot take 16 bytes a load."""
    keys, counts, mask = keep_case(3 * TILE + 1, "random")
    k = torch.from_numpy(np.concatenate([[0], keys])).to(cuda)[1:]
    c = torch.from_numpy(np.concatenate([[0], counts]).astype(np.int32)).to(cuda)[1:]
    m = torch.from_numpy(np.concatenate([[False], mask])).to(cuda)[1:]
    spec = Spectrum(key=k, count=c, n=k.shape[0])
    got, want = tcor.compact(spec, m), tcor.compact_plain(spec, m)
    assert got.n == want.n
    _equal(got.key, want.key, "key")
    _equal(got.count, want.count, "count")
    keys, counts, cap = run_case("one_key_three_tiles")
    k = torch.from_numpy(np.concatenate([[0], keys])).to(cuda)[1:]
    c = torch.from_numpy(np.concatenate([[0], counts]).astype(np.int32)).to(cuda)[1:]
    _reduce_both(cuda, k, None, cap)
    _reduce_both(cuda, k, c, cap)


@pytest.mark.parametrize("extra", [-1, 1])
def test_scan_entry_points_refuse_missized_scratch(cuda, extra):
    """K10's and K2's entry points take a scratch of exactly tiles + 1 words
    and refuse any other, so a tile size that differs between the wrapper
    and scan.cuh raises instead of returning a wrong n."""
    C = 3 * TILE + 1
    key = torch.zeros(C, dtype=torch.int64, device=cuda)
    count = torch.zeros(C, dtype=torch.int32, device=cuda)
    keep = torch.ones(C, dtype=torch.bool, device=cuda)
    scratch = torch.zeros(4 + 1 + extra, dtype=torch.int64, device=cuda)
    out_key, start = torch.empty_like(key), torch.empty_like(key)
    out_count = torch.zeros_like(count)
    lib, p = kernels.library(), kernels.ptr
    with pytest.raises(RuntimeError, match="shannon_compact_keep failed"):
        lib.call("shannon_compact_keep", cuda, p(key), p(count), p(keep), C, p(scratch),
                 scratch.shape[0], p(out_key), p(out_count))
    with pytest.raises(RuntimeError, match="shannon_reduce_sorted failed"):
        lib.call("shannon_reduce_sorted", cuda, p(key), None, C, C, p(scratch),
                 scratch.shape[0], p(out_key), p(out_count), p(start))


# Table lengths that pin the edges of the 16-ary search index K3 and K7 walk
# (csrc/search.cuh): one lane, a leaf line less one, one line, a line and a
# lane, the span of a level-1 node and of a level-2 node either side, the
# largest table whose top is level 1 either side, and the smallest with two
# levels below the top.
SEARCH_SIZES = [1, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 65_535, 65_536, 65_537,
                1_048_577]
SEARCH_TABLES = ["random", "pad_tail", "all_pad", "edge_keys"]
PROBE_TABLES = ["dense", "palindromic", "edge_keys"]


def _revcomp_np(x: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of the low 2k bits of int64 keys (numpy)."""
    x = x.astype(np.int64)
    r = np.zeros_like(x)
    for i in range(k):
        r = (r << 2) | (3 - ((x >> (2 * i)) & 3))
    return r


def search_table(n: int, kind: str, k: int = 24, seed: int = 0) -> np.ndarray:
    """A sorted int64 table of n lanes, made from a seed: "random" distinct
    k-mer keys; "pad_tail" the same with its last third PAD; "all_pad";
    "edge_keys" keys 0 and 4^k - 1 (the largest real key) among random
    ones, with a PAD tail of a fifth."""
    rng = np.random.default_rng(seed + 31 * n + len(kind) + k)
    top = 1 << (2 * k)
    real = {"random": n, "pad_tail": n - n // 3, "all_pad": 0, "edge_keys": n - n // 5}[kind]
    keys = 1 + rng.choice(top - 2, size=real, replace=False)
    if kind == "edge_keys":
        keys[:2] = [0, top - 1][:real]
    return np.concatenate([np.sort(keys), np.full(n - real, PAD)]).astype(np.int64)


def search_queries(table: np.ndarray, k: int = 24, seed: int = 0) -> np.ndarray:
    """Queries for a table: its own keys, random k-mers, each key + 1 and
    - 1 (k-mers all: none below 0), 0, 4^k - 1 and PAD."""
    rng = np.random.default_rng(seed + len(table))
    own = table[rng.integers(0, len(table), 500)]
    near = np.concatenate([own[own != PAD] + 1, own[(own != PAD) & (own > 0)] - 1])
    return np.concatenate([own, rng.integers(0, 1 << (2 * k), 500), near,
                           [0, (1 << (2 * k)) - 1, PAD, PAD]]).astype(np.int64)


def probe_table(kind: str, k: int, canonical: bool, C: int = 3000, seed: int = 0) -> np.ndarray:
    """A spectrum-like table of C lanes (distinct keys, canonical when
    `canonical`, PAD last), made from a seed, on which K7's probes hit:
    "dense" every k-mer of a few random sequences and its last base
    changed; "palindromic" keys whose second half is the reverse
    complement of the first (palindromes at even k, one middle base free at
    odd k) with their right and left siblings; "edge_keys" search_table's."""
    rng = np.random.default_rng(seed + k + 7 * canonical + len(kind))
    mask = (1 << (2 * k)) - 1
    if kind == "edge_keys":
        keys = search_table(C, "edge_keys", k, seed)
        keys = keys[keys != PAD]
    elif kind == "dense":
        codes = rng.integers(0, 4, (C // 40, 60))
        win = np.lib.stride_tricks.sliding_window_view(codes, k, axis=1).reshape(-1, k)
        v = np.zeros(len(win), np.int64)
        for j in range(k):
            v = (v << 2) | win[:, j]
        keys = np.concatenate([v, v ^ 1, v ^ (2 << (2 * (k - 1)))])
    else:
        h = k // 2
        first = rng.integers(0, 1 << (2 * h), C // 10)
        v = (first << (2 * (k - h))) | _revcomp_np(first, h)
        if k % 2:
            v |= rng.integers(0, 4, len(v)) << (2 * h)
        b = np.arange(4)[:, None]
        keys = np.concatenate([v, ((v & ~3) | b).ravel(),
                               ((v & (mask >> 2)) | (b << (2 * (k - 1)))).ravel()])
    if canonical:
        keys = np.minimum(keys, _revcomp_np(keys, k))
    keys = np.unique(keys)[:C]
    return np.concatenate([keys, np.full(C - len(keys), PAD)]).astype(np.int64)


def _lookup_both(cuda, table: torch.Tensor, query: torch.Tensor) -> None:
    """K3 on the card against its plain version on the same CUDA inputs:
    idx (the clamped lower bound, misses included) and hit."""
    got, want = lookup_sorted(table, query), lookup_sorted_plain(table, query)
    torch.cuda.synchronize()
    _equal(got[0], want[0], "idx")
    _equal(got[1], want[1], "hit")


@pytest.mark.parametrize("n", SEARCH_SIZES)
@pytest.mark.parametrize("kind", SEARCH_TABLES)
def test_lookup_kernel_on_edge_tables(cuda, n, kind):
    """K3 == its plain version on every edge of the index, and on the same
    table as a view that starts one lane into its storage (odd lane, no
    16-byte alignment)."""
    table = search_table(n, kind)
    query = torch.from_numpy(search_queries(table)).to(cuda)
    _lookup_both(cuda, torch.from_numpy(table).to(cuda), query)
    view = torch.from_numpy(np.concatenate([[0], table]).astype(np.int64)).to(cuda)[1:]
    assert view.data_ptr() % 16 == 8
    _lookup_both(cuda, view, query)


@pytest.mark.parametrize("kind", PROBE_TABLES)
@pytest.mark.parametrize("k", [15, 24, 31])
@pytest.mark.parametrize("side", ["sib", "ext"])
@pytest.mark.parametrize("canonical", [True, False])
def test_probe_lookup_kernel_on_edge_tables(cuda, kind, k, side, canonical):
    """K7 == its plain version, idx on misses included, where its PAD and
    probe-group shortcuts meet the table's edges: dense sibling groups,
    (near-)palindromes, keys 0 and 4^k - 1, the first PAD lane; and on a
    view of the table one lane into its storage."""
    table = probe_table(kind, k, canonical)
    for key in (torch.from_numpy(table).to(cuda),
                torch.from_numpy(np.concatenate([[0], table]).astype(np.int64)).to(cuda)[1:]):
        spec = Spectrum(key=key, count=torch.ones(len(table), dtype=torch.int32, device=cuda),
                        n=int((table != PAD).sum()))
        got = tcor.probe_resolve(spec, k, canonical, side)
        want = tcor.probe_resolve_plain(spec, k, canonical, side)
        torch.cuda.synchronize()
        _equal(got[0], want[0], "idx")
        _equal(got[1], want[1], "hit")


@pytest.mark.parametrize("side", ["sib", "ext"])
@pytest.mark.parametrize("canonical", [True, False])
def test_probe_lookup_kernel_on_a_dense_table_with_index_levels(cuda, side, canonical):
    """K7 == its plain version on a dense spectrum of 2^21 lanes, where two
    index levels lie below the top and most probes hit."""
    C = 1 << 21
    assert len(tsp.search_layout(C).sizes) == 3
    table = probe_table("dense", 24, canonical, C=C)
    spec = Spectrum(key=torch.from_numpy(table).to(cuda),
                    count=torch.ones(C, dtype=torch.int32, device=cuda), n=C)
    got = tcor.probe_resolve(spec, 24, canonical, side)
    want = tcor.probe_resolve_plain(spec, 24, canonical, side)
    torch.cuda.synchronize()
    _equal(got[0], want[0], "idx")
    _equal(got[1], want[1], "hit")
    assert want[1].float().mean() > 0.1


@pytest.mark.parametrize("n", [1, 16, 17, 4097, 12_582_912])
@pytest.mark.parametrize("side", ["sib", "ext"])
def test_probe_lookup_kernel_on_pad_tables(cuda, n, side):
    """K7 on tables with no real key and with one: every lane takes the
    block's PAD answers, or all but one."""
    table = np.full(n, PAD, np.int64)
    for real in (0, 1):
        table[:real] = 12345
        spec = Spectrum(key=torch.from_numpy(table).to(cuda),
                        count=torch.ones(n, dtype=torch.int32, device=cuda), n=real)
        got = tcor.probe_resolve(spec, 24, True, side)
        want = tcor.probe_resolve_plain(spec, 24, True, side)
        torch.cuda.synchronize()
        _equal(got[0], want[0], "idx")
        _equal(got[1], want[1], "hit")


def test_search_kernels_on_a_table_above_2_24_lanes(cuda):
    """K3 and K7 on 2^24 + 2^20 lanes, where four index levels stay in
    global memory below the shared-memory ones."""
    C = (1 << 24) + (1 << 20)
    assert len(tsp.search_layout(C).sizes) - 1 == 3
    rng = np.random.default_rng(24)
    real = C - C // 7
    table = np.full(C, PAD, np.int64)
    table[:real] = np.sort(rng.choice(1 << 48, size=real, replace=False))
    key = torch.from_numpy(table).to(cuda)
    query = torch.from_numpy(np.concatenate([
        table[rng.integers(0, C, 1 << 20)], rng.integers(0, 1 << 48, 1 << 20),
        table[:4096] + 1, [PAD, 0]])).to(cuda)
    _lookup_both(cuda, key, query)
    spec = Spectrum(key=key, count=torch.ones(C, dtype=torch.int32, device=cuda), n=real)
    got = tcor.probe_resolve(spec, 24, True, "sib")
    want = tcor.probe_resolve_plain(spec, 24, True, "sib")
    torch.cuda.synchronize()
    _equal(got[0], want[0], "idx")
    _equal(got[1], want[1], "hit")


@pytest.mark.parametrize("n", SEARCH_SIZES + [(1 << 24) + 3])
def test_search_index_matches_plain(cuda, n):
    """The index the K3 entry point builds into the caller's scratch ==
    search_index_plain, level by level."""
    table = torch.from_numpy(search_table(n, "pad_tail")).to(cuda)
    scratch, layout = tsp.search_args(n, cuda)
    query = table[:1].clone()
    idx = torch.empty(1, dtype=torch.int64, device=cuda)
    hit = torch.empty(1, dtype=torch.bool, device=cuda)
    p = kernels.ptr
    kernels.library().call("shannon_lookup_sorted", cuda, p(table), n, p(query), 1, p(scratch),
                           scratch.shape[0], layout, p(idx), p(hit))
    torch.cuda.synchronize()
    _equal(scratch, tsp.search_index_plain(table), "index")


@pytest.mark.parametrize("fault", ["short", "long", "levels", "size", "offset"])
def test_search_entry_points_refuse_wrong_layouts(cuda, fault):
    """K3's and K7's entry points check the layout and the scratch they are
    given against the table's length and refuse any other, so a layout rule
    that differs between ops/spectrum.py and search.cuh raises."""
    C = 70_000
    key = torch.from_numpy(search_table(C, "random")).to(cuda)
    scratch, layout = tsp.search_args(C, cuda)
    words = scratch.shape[0]
    if fault == "short":
        words -= 1
    elif fault == "long":
        scratch, words = torch.empty(words + 1, dtype=torch.int64, device=cuda), words + 1
    elif fault == "levels":
        layout[0] -= 1
    elif fault == "size":
        layout[1] += 1
    else:
        layout[1 + tsp.SEARCH_MAX_LEVELS] += tsp.SEARCH_FANOUT
    idx = torch.empty((8, C), dtype=torch.int64, device=cuda)
    hit = torch.empty((8, C), dtype=torch.bool, device=cuda)
    lib, p = kernels.library(), kernels.ptr
    with pytest.raises(RuntimeError, match="shannon_lookup_sorted failed"):
        lib.call("shannon_lookup_sorted", cuda, p(key), C, p(key), C, p(scratch), words, layout,
                 p(idx), p(hit))
    with pytest.raises(RuntimeError, match="shannon_probe_lookup failed"):
        lib.call("shannon_probe_lookup", cuda, p(key), C, 24, 0, 1, p(scratch), words, layout,
                 p(idx), p(hit))


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("min_abundance", [0, 1, 2])
@pytest.mark.parametrize("canonical", [True, False])
def test_correct_spectrum_on_cuda_matches_cpu(cuda, k, min_abundance, canonical):
    """The whole stage on K7-K10 equals the CPU run (the plain versions)."""
    spec = _spectrum(k, canonical)
    args = (k, min_abundance, 0.1, 8, canonical, 0.01)
    lib = kernels.library()
    lib.reset_counts()
    got = tcor.correct_spectrum(_to(spec, cuda), *args)
    assert lib.launches["probe_lookup"] > 0 and lib.launches["prune_round"] > 0
    assert lib.launches["compact_keep"] == 1
    want = tcor.correct_spectrum(spec, *args)
    assert got.n == want.n
    assert torch.equal(got.key.cpu(), want.key) and torch.equal(got.count.cpu(), want.count)


def _rescue_case(k: int, case: str, cuda):
    """K8's inputs on the card: a counted spectrum cut to C = n + 77 lanes
    (not a multiple of the block) or a chain of 40 cut k-mers running off
    10 alive ones (which needs 40 rounds), its plain probe tables and
    (raw, counts): the cut at 2 or 3, no lane cut ("none_cut", so round 1
    has no cut lane), every lane cut ("all_cut"), or every lane but each
    97th cut ("sparse_alive": long rescue chains from the seeds)."""
    canonical = case != "strand"
    if case == "chain":
        rng = np.random.default_rng(k)
        seq = rng.integers(0, 4, 50 + k - 1)
        keys = [sum(int(b) << 2 * (k - 1 - j) for j, b in enumerate(seq[i : i + k]))
                for i in range(50)]
        keys = canonical_key(torch.tensor(keys), k)
        assert len(set(keys.tolist())) == 50
        counts = torch.tensor([5] * 10 + [1] * 40, dtype=torch.int32)
        order = torch.argsort(keys)
        key = torch.full((128,), PAD, dtype=torch.int64)
        count = torch.zeros(128, dtype=torch.int32)
        key[:50], count[:50] = keys[order], counts[order]
        spec = Spectrum(key=key, count=count, n=50)
    else:
        full = _spectrum(k, canonical)
        C = full.n + 77
        spec = Spectrum(key=full.key[:C].clone(), count=full.count[:C].clone(), n=full.n)
    spec = _to(spec, cuda)
    sib = tcor.probe_resolve_plain(spec, k, canonical, "sib")
    ext = tcor.probe_resolve_plain(spec, k, canonical, "ext")
    cut = {"cut3": 3, "none_cut": 1, "all_cut": 1 << 30}.get(case, 2)
    raw, counts = tcor.cut_counts(spec, cut)
    if case == "sparse_alive":
        lane = torch.arange(spec.capacity, device=cuda)
        counts = torch.where(lane % 97 == 0, raw, 0).to(torch.int32)
    return counts, raw, sib, ext


RESCUE_CASES = ["cut2", "cut3", "strand", "none_cut", "all_cut", "sparse_alive", "chain"]


@pytest.mark.parametrize(
    "k, case",  # k = 5 has too few distinct k-mers for the chain
    [(k, c) for k in (5, 16, 24, 31) for c in RESCUE_CASES if (k, c) != (5, "chain")],
)
@pytest.mark.parametrize("rounds", ["1", "3", "k+2"])
def test_rescue_rounds_kernel_matches_plain(cuda, k, case, rounds):
    """K8 (every round enqueued at once, frontier lists after round 1) ==
    its plain loop: counts, the last round's flag and each round's rescues."""
    counts, raw, sib, ext = _rescue_case(k, case, cuda)
    r = k + 2 if rounds == "k+2" else int(rounds)
    before = counts.clone()
    got_info, want_info = {}, {}
    got = tcor.rescue_rounds(counts, raw, *sib, *ext, r, got_info)
    want = tcor.rescue_rounds_plain(counts, raw, *sib, *ext, r, want_info)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert got_info["rescued"] == want_info["rescued"]
    assert len(got_info["frontier"]) == got_info["rounds_run"]
    assert torch.equal(counts, before)
    if case == "chain":
        assert got[1] == (r < 40)


def test_rescue_rounds_kernel_repeats(cuda):
    """50 calls of K8 on long rescue chains (frontier lists built with
    atomics, in an order that changes from call to call) give one answer."""
    counts, raw, sib, ext = _rescue_case(24, "sparse_alive", cuda)
    want = tcor.rescue_rounds_plain(counts, raw, *sib, *ext, 26)
    assert int((want[0] != counts).sum()) > 0
    for _ in range(50):
        info = {}
        got = tcor.rescue_rounds(counts, raw, *sib, *ext, 26, info)
        assert torch.equal(got[0], want[0]) and got[1] == want[1]
        assert info["rounds_run"] > 1


def test_correction_wrappers_validate_inputs(cuda):
    counts = torch.zeros(4, dtype=torch.int32, device=cuda)
    idx = torch.zeros((8, 4), dtype=torch.int64, device=cuda)
    hit = torch.zeros((8, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match=r"\[8, 4\]"):
        tcor.prune_round(counts, idx[:, :3].contiguous(), hit[:, :3].contiguous(), 0.1, 0.0, False)
    with pytest.raises(TypeError, match="int32"):
        tcor.rescue_rounds(counts.long(), counts, idx, hit, idx, hit, 3)
    with pytest.raises(ValueError, match="side"):
        tcor.probe_resolve(Spectrum(key=idx[0], count=counts, n=0), 21, True, "up")


def _condense_spectrum(case: str, k: int, canonical: bool) -> Spectrum:
    """A counted spectrum on the CPU: isoforms (branches), isolated cycles
    of three lengths plus a homopolymer beside a chain, a palindromic
    junction (palindromic k-mers at even k), or nothing."""
    if case == "empty":
        return empty_spectrum(1 << 10, "cpu")
    rng = np.random.default_rng(k)
    if case == "isoforms":
        ts = simulate_gene_isoforms(rng, n_genes=2)[0]
    elif case == "cycles":
        ts = [random_seq(rng, n) * 4 for n in (37, 52, 71)] + [random_seq(rng, 300), "A" * 120]
    else:
        h = random_seq(rng, 40)
        ts = [random_seq(rng, 80) + h + revcomp_str(h) + random_seq(rng, 80)]
    reads = sample_reads(rng, ts, coverage=15, read_length=60)
    b = pack_reads(reads, pad_length=64)
    return count_reads_spectrum(b, k=k, capacity=1 << 14, canonical=canonical, device="cpu")


def _equal(got, want, what: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), what


@pytest.mark.parametrize("case", ["isoforms", "cycles", "palindrome", "empty"])
@pytest.mark.parametrize("k", [15, 24])
@pytest.mark.parametrize("canonical", [True, False])
def test_condense_kernels_match_plain(cuda, case, k, canonical):
    """K11-K15 stage by stage, each kernel against its plain version on the
    same CUDA inputs (the kernel's output feeds the next stage), then the
    whole build_contig_arrays on CUDA against the CPU run."""
    spec = _to(_condense_spectrum(case, k, canonical), cuda)
    lib = kernels.library()
    lib.reset_counts()
    nodes = tcd.nodes_stage(spec, k, canonical)
    if canonical:
        want = tcd.nodes_stage_plain(spec, k, canonical)
        _equal(nodes[0], want[0], "node_key")
        _equal(nodes[1], want[1], "node_count")
        assert nodes[2] == want[2]
    node_key, node_count, n_nodes = nodes
    links = tcd.links_stage(node_key, k)
    for g, w, name in zip(links, tcd.links_stage_plain(node_key, k),
                          ("prev_link", "rec_lane", "first_p", "p_cnt")):
        _equal(g, w, name)
    prev, rec_lane, first_p, p_cnt = links
    ptr, dist, has_cycle = tcd.label_stage(prev)
    want = tcd.label_stage_plain(prev)
    _equal(ptr, want[0], "ptr")
    _equal(dist, want[1], "dist")
    assert has_cycle == want[2]
    assert has_cycle == (case == "cycles")
    if has_cycle:
        cut = tcd.cycle_fix(prev)
        _equal(cut, tcd.cycle_fix_plain(prev), "cut")
        prev = cut
        ptr, dist, again = tcd.label_stage(prev)
        assert not again
    args = (node_key, node_count, n_nodes, prev, ptr, dist, rec_lane, first_p, p_cnt, k, canonical)
    ca, want = tcd.reduce_stage(*args), tcd.reduce_stage_plain(*args)
    for f in ("node_cid", "node_off", "klen", "abundance", "count_sum", "head_lane",
              "tail_lane", "out_edges", "rc_pair"):
        _equal(getattr(ca, f), getattr(want, f), f)
    assert (ca.n_nodes, ca.n_contigs) == (want.n_nodes, want.n_contigs)
    for g, w, name in zip(tcd.contig_base_streams(ca, k), tcd.contig_base_streams_plain(ca, k),
                          ("tails", "heads")):
        _equal(g, w, name)
    torch.cuda.synchronize()
    launched = {n for n in ("node_strands", "group_links", "label_round", "cycle_round",
                            "contig_reduce", "base_streams") if lib.launches[n]}
    assert launched == {"group_links", "label_round", "contig_reduce", "base_streams"} | (
        {"node_strands"} if canonical else set()) | ({"cycle_round"} if has_cycle else set())

    whole = tcd.build_contig_arrays(spec, k, canonical)
    cpu = tcd.build_contig_arrays(_to(spec, "cpu"), k, canonical)
    for f in ("node_key", "node_count", "node_cid", "node_off", "klen", "abundance",
              "count_sum", "head_lane", "tail_lane", "out_edges", "rc_pair"):
        _equal(getattr(whole, f).cpu(), getattr(cpu, f), f)
    assert (whole.n_nodes, whole.n_contigs) == (cpu.n_nodes, cpu.n_contigs)


def test_condense_wrappers_validate_inputs(cuda):
    key = torch.zeros(8, dtype=torch.int64, device=cuda)
    count = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        tcd.nodes_stage(Spectrum(key=key, count=key, n=0), 21, True)
    with pytest.raises(TypeError, match="int64"):
        tcd.links_stage(count, 21)
    with pytest.raises(ValueError, match="dims"):
        tcd.label_stage(key.reshape(2, 4))
    with pytest.raises(TypeError, match="int64"):
        tcd.cycle_fix(key.float())
    rec = torch.zeros(16, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        tcd.reduce_stage(key, count, 0, key.cpu(), key, key, rec, key, key, 21, True)
    ca = tcd.build_contig_arrays(Spectrum(key=key[:4] + tcd.PAD, count=count[:4], n=0), 21)
    ca.node_cid = ca.node_cid.int()
    with pytest.raises(TypeError, match="int64"):
        tcd.contig_base_streams(ca, 21)


def test_paired_assemble_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(6)
    ts, _ = simulate_gene_isoforms(rng, n_genes=3)
    reads = sample_paired_reads(rng, ts, coverage=20, read_length=80, insert_size=250,
                                error_rate=0.01)
    cfg = AssemblyConfig(k=24, kmer_capacity=1 << 16, batch_reads=2048, n_devices=1)
    lib = kernels.library()
    lib.reset_counts()
    timer = StageTimer(echo=False)
    gpu = assemble(reads, cfg, device=cuda, paired=True, timer=timer)
    _assert_all_launched(lib.launches, timer)
    cpu = assemble(reads, cfg, device="cpu", paired=True)
    assert [(t.seq, t.abundance) for t in gpu.transcripts] == [
        (t.seq, t.abundance) for t in cpu.transcripts
    ]
    assert gpu.stats == {**cpu.stats, "backend": "torch:cuda"}


def test_assemble_on_cuda_matches_cpu_and_counts_launches(cuda):
    rng = np.random.default_rng(5)
    ts, _ = simulate_gene_isoforms(rng, n_genes=3)
    reads = sample_reads(rng, ts, coverage=20, read_length=80, error_rate=0.01)
    cfg = AssemblyConfig(k=24, kmer_capacity=1 << 16, batch_reads=2048, n_devices=1)
    lib = kernels.library()
    lib.reset_counts()
    timer = StageTimer(echo=False)
    gpu = assemble(reads, cfg, device=cuda, timer=timer)
    _assert_all_launched(lib.launches, timer)
    cpu = assemble(reads, cfg, device="cpu")
    assert [t.seq for t in gpu.transcripts] == [t.seq for t in cpu.transcripts]
    assert [t.abundance for t in gpu.transcripts] == [t.abundance for t in cpu.transcripts]
    assert gpu.stats == {**cpu.stats, "backend": "torch:cuda"}


# ---- K16-K19: count histogram, count merge, tip clip's drop and remap ------


def _histogram_spectrum(case: str) -> Spectrum:
    """A table on the CPU: counted reads; all pads; no lanes; or 2^20 lanes
    of which nine in ten hold count 1 and the rest counts from -3 to 20,000
    (some in bin 0, some past every max_count, a few pads among them), or
    to 100,000 for the case "wide"."""
    if case == "counted":
        return _spectrum(24)
    if case == "all_pad":
        return empty_spectrum(4096, "cpu")
    if case == "no_lanes":
        return empty_spectrum(0, "cpu")
    rng = np.random.default_rng(2)
    C = 1 << 20
    top = 100_000 if case == "wide" else 20_000
    count = np.where(rng.random(C) < 0.9, 1, rng.integers(-3, top, C)).astype(np.int32)
    key = np.sort(rng.integers(0, 1 << 48, C))
    key[rng.random(C) < 0.01] = PAD
    return Spectrum(key=torch.from_numpy(key), count=torch.from_numpy(count), n=C)


@pytest.mark.parametrize("case", ["counted", "all_pad", "no_lanes", "count1_heavy"])
@pytest.mark.parametrize("max_count", [0, 64, 1024, tcor.HISTOGRAM_MAX_COUNT])
def test_count_histogram_kernel_matches_plain(cuda, case, max_count):
    """K16: bin for bin, h[0] = 0."""
    spec = _to(_histogram_spectrum(case), cuda)
    lib = kernels.library()
    before = lib.launches["count_histogram"]
    got = tcor.count_histogram(spec, max_count)
    assert lib.launches["count_histogram"] == before + 1
    want = tcor.count_histogram_plain(spec, max_count)
    torch.cuda.synchronize()
    _equal(got, want, "histogram")
    assert int(got[0]) == 0


@pytest.mark.parametrize("max_count", [tcor.HISTOGRAM_MAX_COUNT, tcor.HISTOGRAM_MAX_COUNT + 1, 65_536])
def test_count_histogram_kernel_at_any_max_count(cuda, max_count):
    """K16's shared variant up to HISTOGRAM_MAX_COUNT, its global variant
    above, on counts drawn up to 100,000."""
    spec = _to(_histogram_spectrum("wide"), cuda)
    got = tcor.count_histogram(spec, max_count)
    want = tcor.count_histogram_plain(spec, max_count)
    torch.cuda.synchronize()
    assert got.shape == (max_count + 1,)
    _equal(got, want, "histogram")
    assert int(got[0]) == 0 and int(got[max_count]) > 0


# K17's merge cases beyond the first six: merged real lengths around one
# and two scan tiles, an equal pair split across tile 0's last diagonal,
# tables that repeat keys (a run longer than a tile among them), counts
# whose sums wrap past 2^31 and 2^32, an output capacity inside tile 1's
# slots, b all PAD under a table of three tiles, and capacities that are not
# multiples of 16.
MERGE_TILE_CASES = ["real_4095", "real_4096", "real_4097", "real_8191", "real_8193",
                    "tie_on_diagonal", "repeated", "wrap", "below_union", "b_all_pad",
                    "odd_capacities"]
# Cases whose union of distinct keys exceeds the output capacity.
MERGE_OVERFLOW_CASES = ("overflow", "below_union")


def merge_case(case: str):
    """Two sorted tables of one merge case from numpy arrays made from a
    seed, (keys, counts, capacity) each, and the merge's output capacity:
    capacities that differ (half of b's keys in a as well), a table merged
    with itself, interleaved disjoint tables, one empty table, a union past
    the output capacity, two all-pad tables, and MERGE_TILE_CASES."""
    rng = np.random.default_rng(len(case))
    pool = np.unique(rng.integers(0, 1 << 48, size=20_000, dtype=np.int64)).astype(np.uint64)

    def table(keys, cap, counts=None):
        if counts is None:
            counts = rng.integers(1, 60, size=keys.shape[0]).astype(np.int32)
        order = np.argsort(keys, kind="stable")
        return keys[order], counts[order], cap

    def split(keys):
        """keys dealt at random between a and b."""
        to_a = rng.random(keys.shape[0]) < 0.5
        return keys[to_a], keys[~to_a]

    def real(n):  # disjoint tables of n real lanes in all, with PAD tails
        a, b = split(pool[:n])
        return table(a, a.shape[0] + 100), table(b, b.shape[0] + 37), n + 5

    def tie_on_diagonal():  # key pool[4095] at merged lanes 4095 (a) and 4096 (b)
        a, b = split(pool[:4095])
        c, d = split(pool[4096:6000])
        x = pool[4095:4096]
        return (table(np.concatenate([a, x, c]), 3000), table(np.concatenate([b, x, d]), 3200),
                6100)

    def repeated():  # runs of 1-8 lanes in each table, one key on 5,000 + 3,000 lanes
        a = np.concatenate([np.repeat(pool[:300], rng.integers(1, 9, 300)),
                            np.full(5000, pool[150])])
        b = np.concatenate([np.repeat(pool[100:400], rng.integers(1, 9, 300)),
                            np.full(3000, pool[150])])
        return table(a, a.shape[0] + 50), table(b, b.shape[0] + 3), 4500

    def wrap():  # each key 3 lanes in a and 2 in b, counts near 2^30
        keys = pool[:1500]
        a, b = np.repeat(keys, 3), np.repeat(keys, 2)

        def big(n):
            return rng.integers((1 << 30) - 1000, (1 << 30) + 1000, n).astype(np.int32)

        return table(a, 4600, big(a.shape[0])), table(b, 3001, big(b.shape[0])), 1500

    return {
        "unequal": lambda: (table(pool[:3000], 4096),
                            table(np.concatenate([pool[2500:3000], pool[5000:5500]]), 1536), 8192),
        "identical": lambda: (table(pool[:3000], 4096),) * 2 + (4096,),
        "disjoint": lambda: (table(pool[0:6000:2], 4096), table(pool[1:6000:2], 4096), 8192),
        "empty": lambda: (table(pool[:0], 1024), table(pool[:700], 1024), 1024),
        "overflow": lambda: (table(pool[:3000], 4096), table(pool[2000:5000], 4096), 3500),
        "all_pad": lambda: (table(pool[:0], 1024), table(pool[:0], 512), 1024),
        "real_4095": lambda: real(4095),
        "real_4096": lambda: real(4096),
        "real_4097": lambda: real(4097),
        "real_8191": lambda: real(8191),
        "real_8193": lambda: real(8193),
        "tie_on_diagonal": tie_on_diagonal,
        "repeated": repeated,
        "wrap": wrap,
        "below_union": lambda: (table(pool[:6000], 6001), table(pool[3000:9000], 6003), 5001),
        "b_all_pad": lambda: (table(pool[:12_300], 12_307), table(pool[:0], 2048), 12_400),
        "odd_capacities": lambda: (table(pool[:900], 1003), table(pool[500:5000], 4517), 5011),
    }[case]()


def _merge_tables(case: str):
    """merge_case's tables as spectra on the CPU, or two counted batch
    tables ("counted"), and the merge's output capacity."""
    if case == "counted":
        a, b = _spectrum(24, seed=1), _spectrum(24, seed=2)
        return a, b, a.capacity
    *tables, cap = merge_case(case)
    return tuple(spectrum_from_arrays(*t, device="cpu") for t in tables) + (cap,)


@pytest.mark.parametrize(
    "case",
    ["unequal", "identical", "disjoint", "empty", "overflow", "all_pad", "counted",
     *MERGE_TILE_CASES],
)
def test_merge_kernel_matches_plain(cuda, case):
    """K17, one pass: keys, counts and n, n past the capacity included; it
    launches no K2."""
    a, b, cap = _merge_tables(case)
    lib = kernels.library()
    before = dict(lib.launches)
    got = merge_at(_to(a, cuda), _to(b, cuda), cap)
    assert lib.launches["merge_spectra"] == before["merge_spectra"] + 1
    assert lib.launches["reduce_sorted"] == before["reduce_sorted"]
    want = merge_at_plain(a, b, cap)
    torch.cuda.synchronize()
    assert got.n == want.n
    assert (case in MERGE_OVERFLOW_CASES) == (want.n > cap)
    _equal(got.key.cpu(), want.key, "key")
    _equal(got.count.cpu(), want.count, "count")


def _clip_inputs(cuda, k: int = 24):
    """A counted spectrum on the card, its contig arrays (K11-K15) and one
    clip's host state (the port's host rounds)."""
    cfg = AssemblyConfig(k=k)
    spec = _to(_spectrum(k), cuda)
    ca = tcd.build_contig_arrays(spec, k)
    n = ca.n_contigs
    st = ttc._host_clip_rounds(
        ca.klen[:n].cpu().numpy(), ca.count_sum[:n].cpu().numpy(),
        ttc._adjacency_lists(ca.out_edges[:, :n].cpu().numpy(), n), cfg,
    )
    return spec, ca, st


@pytest.mark.parametrize("doom", ["clip", "none", "all", "random"])
def test_drop_contigs_kernel_matches_plain(cuda, doom):
    """K18 (then K10) against its plain version on the same CUDA inputs."""
    spec, ca, st = _clip_inputs(cuda)
    n, C2 = ca.n_contigs, ca.node_key.shape[0]
    doomed = torch.zeros(C2, dtype=torch.bool)
    if doom == "clip":
        assert st.doomed.any()
        doomed[:n] = torch.from_numpy(st.doomed)
    elif doom == "all":
        doomed[:] = True
    elif doom == "random":
        doomed[:n] = torch.from_numpy(np.random.default_rng(4).random(n) < 0.3)
    doomed = doomed.to(cuda)
    lib = kernels.library()
    before = lib.launches["drop_contigs"]
    got = ttc._drop_contigs(spec, ca, doomed)
    assert lib.launches["drop_contigs"] == before + 1
    want = ttc._drop_contigs_plain(spec, ca, doomed)
    torch.cuda.synchronize()
    assert got.n == want.n
    _equal(got.key, want.key, "key")
    _equal(got.count, want.count, "count")
    assert (want.n == 0) == (doom == "all") and (want.n == spec.n) == (doom == "none")


def remap_args_of_clip(ca, st, klen, n2: int) -> tuple:
    """The arguments the host half _remap_clipped hands to
    _device_clip_remap for one clip (st) of contig arrays ca."""
    captured = []
    real = ttc._device_clip_remap
    ttc._device_clip_remap = lambda *args: captured.append(args) or real(*args)
    try:
        ttc._remap_clipped(ca, st, klen, n2)
    finally:
        ttc._device_clip_remap = real
    return captured[0]


def _remap_args(cuda, doom: str):
    """_device_clip_remap's arguments: those one clip gives it (captured
    from _remap_clipped), or no contig doomed (every map the identity), or
    every contig doomed."""
    spec, ca, st = _clip_inputs(cuda)
    if doom == "clip":
        return remap_args_of_clip(ca, st, ca.klen[: ca.n_contigs].cpu().numpy(), spec.n)
    n, C2 = ca.n_contigs, ca.node_key.shape[0]
    npad = tight_capacity(n, minimum=1 << 15)
    new_cid = torch.full((npad,), -1, dtype=torch.int64)
    if doom == "none":
        new_cid[:n] = torch.arange(n)
    return (ca, new_cid.to(cuda), torch.zeros(npad, dtype=torch.int64, device=cuda),
            ca.head_lane, ca.tail_lane, ca.klen, ca.count_sum, ca.rc_pair, ca.out_edges, n, C2)


@pytest.mark.parametrize("doom", ["clip", "none", "all"])
@pytest.mark.parametrize("cap", ["given", "below_kept", "above_table"])
def test_clip_remap_kernel_matches_plain(cuda, doom, cap):
    """K19 against its plain version on the same CUDA inputs: every field
    over its full capacity, the float32 abundances bit for bit, n_nodes
    counting every kept node even past out_cap."""
    ca, *maps, n_new, out_cap = _remap_args(cuda, doom)
    C2 = ca.node_key.shape[0]
    if cap == "below_kept":
        out_cap = max(int((ca.node_cid >= 0).sum()) // 3, 1)
    elif cap == "above_table":
        out_cap = C2 + 1000
    args = (ca, *maps, n_new, out_cap)
    lib = kernels.library()
    before = lib.launches["clip_remap"]
    got = ttc._device_clip_remap(*args)
    assert lib.launches["clip_remap"] == before + 1
    want = ttc._device_clip_remap_plain(*args)
    torch.cuda.synchronize()
    for f in ("node_key", "node_count", "node_cid", "node_off", "klen", "count_sum",
              "head_lane", "tail_lane", "out_edges", "rc_pair"):
        _equal(getattr(got, f), getattr(want, f), f)
    _equal(got.abundance.view(torch.int32), want.abundance.view(torch.int32), "abundance")
    assert (got.n_nodes, got.n_contigs) == (want.n_nodes, want.n_contigs)
    if doom == "all":
        assert want.n_nodes == 0
    if doom == "none":
        assert want.n_nodes == ca.n_nodes
        if cap == "given":
            _equal(want.node_cid, ca.node_cid, "identity remap")


def test_clip_and_count_wrappers_validate_inputs(cuda):
    key = torch.zeros(8, dtype=torch.int64, device=cuda)
    count = torch.zeros(8, dtype=torch.int32, device=cuda)
    spec = Spectrum(key=key, count=count, n=0)
    with pytest.raises(ValueError, match="max_count"):
        tcor.count_histogram(spec, -1)
    with pytest.raises(TypeError, match="int32"):
        tcor.count_histogram(Spectrum(key=key, count=key, n=0), 64)
    with pytest.raises(TypeError, match="int64"):
        merge_at(spec, Spectrum(key=count, count=count, n=0), 16)
    with pytest.raises(ValueError, match="CUDA"):
        merge_at(spec, Spectrum(key=key.cpu(), count=count.cpu(), n=0), 16)
    _, ca, _ = _clip_inputs(cuda)
    C2 = ca.node_key.shape[0]
    with pytest.raises(ValueError, match="lanes"):
        ttc._drop_contigs(spec, ca, torch.zeros(C2 - 1, dtype=torch.bool, device=cuda))
    with pytest.raises(TypeError, match="bool"):
        ttc._drop_contigs(spec, ca, torch.zeros(C2, dtype=torch.int32, device=cuda))
    ca_, *maps, n_new, out_cap = _remap_args(cuda, "none")
    with pytest.raises(TypeError, match="int64"):
        ttc._device_clip_remap(ca_, maps[0].int(), *maps[1:], n_new, out_cap)
    with pytest.raises(ValueError, match="disagree"):
        ttc._device_clip_remap(ca_, maps[0], maps[1][:-1].contiguous(), *maps[2:], n_new, out_cap)
    with pytest.raises(ValueError, match="out_cap"):
        ttc._device_clip_remap(ca_, *maps, n_new, -1)


# ---- K20-K23: abundance cut, count lookup, sibling maxima, prune keep ------


@pytest.mark.parametrize("case", ["counted", "count1_heavy", "all_pad", "no_lanes"])
@pytest.mark.parametrize("outputs", [
    (True, True, True), (True, True, False), (True, False, True), (False, True, True),
    (True, False, False), (False, True, False), (False, False, True), (False, False, False),
])
@pytest.mark.parametrize("min_abundance", [-1, 0, 1, 3])
def test_abundance_cut_kernel_matches_plain(cuda, case, outputs, min_abundance):
    """K20 in every combination of its outputs; absent outputs stay None.
    count1_heavy holds real lanes of count 0 and below, which keep takes at
    min_abundance <= 0 and cut > 0 would not."""
    spec = _to(_histogram_spectrum(case), cuda)
    got = tcor.abundance_cut(spec, min_abundance, *outputs)
    want = tcor.abundance_cut_plain(spec, min_abundance, *outputs)
    torch.cuda.synchronize()
    for asked, g, w in zip(outputs, got, want):
        assert (g is None) == (w is None) == (not asked)
        if asked:
            _equal(g, w, "abundance cut")


def test_cut_counts_and_abundance_filter_launch_k20(cuda):
    spec = _to(_spectrum(24), cuda)
    lib = kernels.library()
    before = lib.launches["abundance_cut"]
    got = tcor.cut_counts(spec, 2)
    assert lib.launches["abundance_cut"] == before + 1
    for g, w in zip(got, tcor.cut_counts_plain(spec, 2)):
        _equal(g, w, "cut counts")
    got = tcor.abundance_filter(spec, 2)
    assert lib.launches["abundance_cut"] == before + 2
    want = tcor.abundance_filter(_to(spec, "cpu"), 2)
    assert got.n == want.n
    _equal(got.key.cpu(), want.key, "filtered keys")
    _equal(got.count.cpu(), want.count, "filtered counts")


@pytest.mark.parametrize("k", [5, 24, 31])
def test_lookup_counts_kernel_matches_plain(cuda, k):
    """K21 on [Q] queries (hits, misses, PAD) and on the [8, C] sibling
    probes of the whole table (at k = 5 the table is dense and every
    probe hits)."""
    spec = _to(_spectrum(k), cuda)
    rng = np.random.default_rng(k)
    real = spec.key[: spec.n].cpu().numpy()
    flat = np.concatenate([rng.choice(real, 5000), rng.integers(0, 1 << (2 * k), 5000), [PAD]])
    for query in (torch.from_numpy(flat).to(cuda), tsp.probe_keys(spec.key, k, "sib", True)):
        got = tsp.lookup_counts(spec, query)
        want = tsp.lookup_counts_plain(spec, query)
        torch.cuda.synchronize()
        assert got.shape == query.shape
        _equal(got, want, "counts")
        assert (got > 0).any()
    flat_counts = tsp.lookup_counts(spec, torch.from_numpy(flat).to(cuda))
    assert (flat_counts == 0).any() and int(flat_counts[-1]) == 0  # misses; the PAD query
    assert tsp.lookup_counts(spec, torch.empty((0, 3), dtype=torch.int64, device=cuda)).shape == (0, 3)


@pytest.mark.parametrize("k", [5, 16, 17, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_sibling_maxes_kernel_matches_plain(cuda, k, canonical):
    """K22 on every lane, pad lanes (0, 0) included."""
    spec = _to(_spectrum(k, canonical), cuda)
    got = tsp.sibling_maxes(spec, k, canonical)
    want = tsp.sibling_maxes_plain(spec, k, canonical)
    torch.cuda.synchronize()
    _equal(got[0], want[0], "right sibling maxima")
    _equal(got[1], want[1], "left sibling maxima")
    assert (got[0][spec.n:] == 0).all() and (got[1][spec.n:] == 0).all()


@pytest.mark.parametrize("k", [13, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_neighbor_counts_kernel_matches_plain(cuda, k, canonical):
    """K28 on every lane of all four outputs, pad lanes (zeros) included;
    13 puts the left probes' top base below bit 32, 24 and 31 above it."""
    spec = _to(_spectrum(k, canonical), cuda)
    got = tsp.neighbor_counts(spec, k, canonical)
    want = tsp.neighbor_counts_plain(spec, k, canonical)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("right ext", "left ext", "right sib max", "left sib max")):
        _equal(g, w, what)
    assert (got[0][:, : spec.n] > 0).any() and (got[0][:, spec.n:] == 0).all()
    assert (got[3][spec.n:] == 0).all()


def test_neighbor_counts_kernel_on_an_all_pad_table(cuda):
    spec = Spectrum(key=torch.full((1000,), PAD, dtype=torch.int64, device=cuda),
                    count=torch.zeros(1000, dtype=torch.int32, device=cuda), n=0)
    got = tsp.neighbor_counts(spec, 24)
    torch.cuda.synchronize()
    assert [tuple(x.shape) for x in got] == [(4, 1000), (4, 1000), (1000,), (1000,)]
    assert all((x == 0).all() for x in got)


@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.5])
def test_prune_keep_kernel_float_grid(cuda, ratio):
    """K23 bit-exact where an FMA would show: every count 0..255 against
    every sibling maximum 0..4095 on the right (the left maximum half of
    it), and the same with the sides swapped; a few PAD lanes."""
    c, m = np.meshgrid(np.arange(256), np.arange(4096), indexing="ij")
    c, m = np.tile(c.ravel(), 2), np.tile(m.ravel(), 2)
    half = c.size // 2
    rmax = np.concatenate([m[:half], m[half:] // 2]).astype(np.int32)
    lmax = np.concatenate([m[:half] // 2, m[half:]]).astype(np.int32)
    key = np.arange(c.size, dtype=np.int64)
    key[-7:] = PAD
    spec = Spectrum(key=torch.from_numpy(key).to(cuda),
                    count=torch.from_numpy(c.astype(np.int32)).to(cuda), n=c.size - 7)
    r, l = torch.from_numpy(rmax).to(cuda), torch.from_numpy(lmax).to(cuda)
    ratio32, _ = tcor.prune_constants(ratio, 0.0)
    got = tcor.prune_keep(spec, r, l, ratio32)
    want = tcor.prune_keep_plain(spec, r, l, ratio32)
    torch.cuda.synchronize()
    _equal(got, want, "keep")
    assert not got[-7:].any() and (~got).sum() > 7 and got.any()


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.5])
def test_sibling_prune_round_on_cuda_matches_cpu(cuda, k, canonical, ratio):
    """K22, K23 and K10 in one round equal the CPU run."""
    spec = _spectrum(k, canonical)
    lib = kernels.library()
    lib.reset_counts()
    got = tcor.sibling_prune_round(_to(spec, cuda), k, ratio, canonical)
    for name in ("sibling_maxes", "prune_keep", "compact_keep"):
        assert lib.launches[name] == 1, lib.launches
    want = tcor.sibling_prune_round(spec, k, ratio, canonical)
    assert got.n == want.n
    _equal(got.key.cpu(), want.key, "keys")
    _equal(got.count.cpu(), want.count, "counts")


@pytest.mark.parametrize("k", [24, 31])
def test_entry_step_on_cuda_matches_cpu(cuda, k):
    """The flagship step at 512 reads, capacity 2^15, correction capacity
    2^14: the CUDA run launches K1, K2, K20, K10, K22 and K23 and equals
    the CPU run."""
    from shannon_tpu_torch import entry as tentry
    from shannon_tpu_torch.ops.count import upload_words

    batch = tentry.example_batch(512, tentry.READ_LEN)
    step = tentry.make_step(k, 1 << 15, 1 << 14, tentry.READ_LEN)
    lib = kernels.library()
    lib.reset_counts()
    key, count, n = step(upload_words(batch.words, cuda), torch.from_numpy(batch.lengths).to(cuda))
    for name in ("extract_kmers", "reduce_sorted", "abundance_cut", "compact_keep",
                 "sibling_maxes", "prune_keep"):
        assert lib.launches[name] > 0, lib.launches
    c_key, c_count, c_n = step(upload_words(batch.words, "cpu"), torch.from_numpy(batch.lengths))
    assert n == c_n
    _equal(key.cpu(), c_key, "keys")
    _equal(count.cpu(), c_count, "counts")


def test_entry_kernel_wrappers_validate_inputs(cuda):
    key = torch.zeros(8, dtype=torch.int64, device=cuda)
    count = torch.zeros(8, dtype=torch.int32, device=cuda)
    spec = Spectrum(key=key, count=count, n=0)
    with pytest.raises(ValueError, match="int32"):
        tcor.abundance_cut(spec, 1 << 31)
    with pytest.raises(TypeError, match="int32"):
        tcor.abundance_cut(Spectrum(key=key, count=key, n=0), 1)
    with pytest.raises(ValueError, match="int64"):
        tsp.lookup_counts(spec, count)
    with pytest.raises(ValueError, match="disagree"):
        tsp.sibling_maxes(Spectrum(key=key, count=count[:4], n=0), 24)
    with pytest.raises(ValueError, match="rmax"):
        tcor.prune_keep(spec, count[:4], count, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tcor.prune_keep(spec, count.cpu(), count, 0.1)


# ---- K24-K25: uint8 extraction, owner bucketing; the sharded count ---------


def _codes_batch(seed: int, n: int = 3000) -> tuple[torch.Tensor, torch.Tensor]:
    """_batch's reads as uint8 codes, plus codes >= 4 that no encoder
    writes (5, 7, 255), which must invalidate as N does."""
    b = _batch(seed, n)
    codes = b.codes.copy()
    rng = np.random.default_rng(seed)
    hot = rng.random(codes.shape) < 0.002
    codes[hot] = rng.choice(np.array([4, 5, 7, 255], np.uint8), size=int(hot.sum()))
    return torch.from_numpy(codes), torch.from_numpy(b.lengths)


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_extract_codes_kernel_matches_plain(cuda, k, canonical):
    from shannon_tpu_torch.ops.kmers import extract_kmers, extract_kmers_plain

    codes, lengths = _codes_batch(k)
    want = extract_kmers_plain(codes, lengths, k, canonical)
    got = extract_kmers(codes.to(cuda), lengths.to(cuda), k, canonical)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def owner_table(seed: int, n: int = 5000, pad: int = 300):
    """A sorted table of about n distinct keys below 2^48, PAD-filled, with
    counts (PAD lanes 0), as numpy int64 and int32."""
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, 1 << 48, size=n, dtype=np.int64))
    key = np.concatenate([key, np.full(pad, PAD, np.int64)])
    count = np.where(key == PAD, 0, rng.integers(1, 100, size=key.shape[0])).astype(np.int32)
    return key, count


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8, 64, 1024])
@pytest.mark.parametrize("slack", ["roomy", "margin", "over"])
@pytest.mark.parametrize("n", [5000, (1 << 20) + 77])
def test_owner_buckets_kernel_matches_plain(cuda, n_dev, slack, n):
    from shannon_tpu_torch.parallel import distributed as td

    key, count = (torch.from_numpy(a) for a in owner_table(n_dev, n=n))
    widest = int(torch.bincount(td.owner_of(key[key != PAD], n_dev)).max())
    bucket_cap = {"roomy": 2 * widest, "margin": widest, "over": widest - 1}[slack]
    want = td.owner_buckets_plain(key, count, n_dev, bucket_cap)
    got = td.owner_buckets(key.to(cuda), count.to(cuda), n_dev, bucket_cap)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert bool(got[2]) == bool(want[2]) == (slack == "over")


@pytest.mark.parametrize("table", ["empty", "all_pad"])
def test_owner_buckets_kernel_edge_tables(cuda, table):
    from shannon_tpu_torch.parallel import distributed as td

    key = torch.full((0 if table == "empty" else 1000,), PAD, dtype=torch.int64)
    count = torch.zeros(key.shape[0], dtype=torch.int32)
    want = td.owner_buckets_plain(key, count, 8, 16)
    got = td.owner_buckets(key.to(cuda), count.to(cuda), 8, 16)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert not bool(got[2]) and not bool(want[2])


def test_sharded_wrappers_validate_inputs(cuda):
    from shannon_tpu_torch.ops.kmers import extract_kmers
    from shannon_tpu_torch.parallel import distributed as td

    key = torch.zeros(8, dtype=torch.int64, device=cuda)
    count = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1..1024"):
        td.owner_buckets(key, count, 1025, 4)
    with pytest.raises(ValueError, match="bucket_cap"):
        td.owner_buckets(key, count, 8, 0)
    with pytest.raises(TypeError, match="int32"):
        td.owner_buckets(key, key, 8, 4)
    with pytest.raises(TypeError, match="uint8"):
        extract_kmers(count.view(2, 4), count[:2], 3)


@pytest.mark.parametrize("n_dev, n_reads", [(1, 4800), (3, 4608), (8, 4800)])
def test_sharded_count_on_cuda_matches_cpu(cuda, n_dev, n_reads):
    """count_reads_spectrum_sharded on n_dev shards of the card (one card:
    they share it) == the CPU run: table, n and flag; K1, K2, K25 and K17
    launch.  4,800 reads end in a short batch (padded to 256 rows); 3
    shards take 4,608, three whole batches."""
    from shannon_tpu_torch.parallel.distributed import count_reads_spectrum_sharded
    from shannon_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(n_dev)
    ts, _ = simulate_gene_isoforms(rng, n_genes=3)
    reads = sample_reads(rng, ts, coverage=45, read_length=100, error_rate=0.01)[:n_reads]
    assert len(reads) == n_reads
    b = pack_reads(reads, pad_length=128)
    lib = kernels.library()
    lib.reset_counts()
    got, flag = count_reads_spectrum_sharded(b, 24, 1 << 16, make_mesh(n_dev, cuda),
                                             batch_reads=1536)
    torch.cuda.synchronize()
    for name in ("extract_kmers", "reduce_sorted", "owner_buckets", "merge_spectra"):
        assert lib.launches[name] > 0, lib.launches
    want, want_flag = count_reads_spectrum_sharded(b, 24, 1 << 16, make_mesh(n_dev, "cpu"),
                                                   batch_reads=1536)
    assert flag == want_flag is False and got.n == want.n
    assert torch.equal(got.key.cpu(), want.key) and torch.equal(got.count.cpu(), want.count)


def test_sharded_assemble_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    ts, _ = simulate_gene_isoforms(rng, n_genes=3)
    reads = sample_reads(rng, ts, coverage=20, read_length=80, error_rate=0.01)
    cfg = AssemblyConfig(k=24, kmer_capacity=1 << 16, batch_reads=2048, n_devices=8)
    lib = kernels.library()
    lib.reset_counts()
    timer = StageTimer(echo=False)
    gpu = assemble(reads, cfg, device=cuda, timer=timer)
    _assert_all_launched(lib.launches, timer, sharded=True)
    cpu = assemble(reads, cfg, device="cpu")
    assert [(t.seq, t.abundance) for t in gpu.transcripts] == [
        (t.seq, t.abundance) for t in cpu.transcripts
    ]


def test_dryrun_multichip_on_cuda_matches_cpu(cuda):
    from shannon_tpu_torch.entry import dryrun_multichip

    lib = kernels.library()
    lib.reset_counts()
    got = dryrun_multichip(8, device=cuda)
    assert lib.launches["extract_codes"] > 0 and lib.launches["owner_buckets"] > 0
    assert got == dryrun_multichip(8, device="cpu")


# ---- K26-K27: the evidence-ownership pack and unpack ------------------------


OWNERSHIP_CASES = [
    (n_ranks, case, n_paths)
    for n_ranks in (1, 2, 3, 4, 8)
    for case, n_paths in (("random", 700), ("random", 0), ("random", 1), ("single", 300),
                          ("skew", 400))
] + [(2, "random", 1_000_000), (8, "skew", 1_000_000), (512, "random", 100_000)]


@pytest.mark.parametrize("n_ranks, case, n_paths", OWNERSHIP_CASES)
def test_ownership_kernels_match_plain(cuda, n_ranks, case, n_paths):
    """K26's buffer and bucket lengths and K27's (flat, offs, weights) ==
    the plain versions' (test_torch_ownership holds those to the
    reference's pack and unpack): empty evidence, single-node paths, every
    path to one rank, about 1M paths."""
    from shannon_tpu_torch.parallel import multihost as tmh
    from test_torch_ownership import evidence

    ev = evidence(n_ranks + n_paths, n_paths, 4 * n_paths + 90, n_ranks, case)
    args = [torch.from_numpy(a.astype(np.int32)) for a in ev]
    want = tmh.ownership_pack_plain(*args, n_ranks)
    got = tmh.ownership_pack(*(a.to(cuda) for a in args), n_ranks)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    unpacked = tmh.ownership_unpack(got[0])
    torch.cuda.synchronize()
    for g, w in zip(unpacked, tmh.ownership_unpack_plain(want[0])):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_ownership_unpack_kernel_on_an_exchange(cuda, n_ranks):
    """K27 on what rank r receives: row r of every rank's buffer, at the
    widest bucket of all ranks (the agreed cap)."""
    from shannon_tpu_torch.parallel import multihost as tmh
    from test_torch_ownership import evidence

    evs = [[torch.from_numpy(a.astype(np.int32))
            for a in evidence(9 * r + n_ranks, 300 * (r + 1), 500, n_ranks, "random")]
           for r in range(n_ranks)]
    widest = max(int(tmh.ownership_pack_plain(*e, n_ranks)[1].max()) for e in evs)
    sends = [tmh.ownership_pack(*(a.to(cuda) for a in e), n_ranks, agree=lambda c: widest)[0]
             for e in evs]
    for r in range(n_ranks):
        recv = torch.stack([s[r] for s in sends])
        want = tmh.ownership_unpack_plain(recv.cpu())
        for g, w in zip(tmh.ownership_unpack(recv), want):
            assert torch.equal(g.cpu(), w)


def test_ownership_wrappers_validate_and_raise(cuda):
    from shannon_tpu_torch.parallel import multihost as tmh

    flat = torch.zeros(4, dtype=torch.int32, device=cuda)
    offs = torch.arange(5, dtype=torch.int32, device=cuda)
    weights = torch.ones(4, dtype=torch.int32, device=cuda)
    owner = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1..512"):
        tmh.ownership_pack(flat, offs, weights, owner, 513)
    with pytest.raises(TypeError, match="int32"):
        tmh.ownership_pack(flat.long(), offs, weights, owner, 2)
    with pytest.raises(ValueError, match="path count"):
        tmh.ownership_pack(flat, offs, weights[:3], owner, 2)
    with pytest.raises(TypeError, match="int32"):
        tmh.ownership_unpack(torch.zeros((2, 4), dtype=torch.int64, device=cuda))
    # a launch the kernel refuses raises, with the entry point's CUDA status
    counts = torch.zeros((513, 1), dtype=torch.int32, device=cuda)
    lib = kernels.library()
    with pytest.raises(RuntimeError, match="shannon_ownership_counts failed"):
        lib.call("shannon_ownership_counts", cuda, kernels.ptr(flat), kernels.ptr(offs), 4,
                 kernels.ptr(owner), 513, kernels.ptr(flat), kernels.ptr(counts),
                 kernels.ptr(counts))
