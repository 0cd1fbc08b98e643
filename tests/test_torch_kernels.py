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


def codes_case(L: int, k: int, n: int = 48, seed: int = 0):
    """K24's input, [n, L] uint8 codes and int32 lengths as numpy arrays
    made from a seed: lengths 0..L (a third of the rows full, a sixth
    shorter than k), N codes (4) at bases 15, 16, 31, 32, 63 and 64 of
    every seventh row (either side of the 2-bit words' and the mask words'
    edges), and codes >= 4 that no encoder writes (4, 5, 7, 255) at random,
    past a read's length too."""
    rng = np.random.default_rng(seed + 1000 * L + k)
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    lengths[: n // 3] = L
    lengths[n // 3 : n // 2] = rng.integers(0, k, n // 2 - n // 3)
    for i, p in enumerate(b for b in (15, 16, 31, 32, 63, 64) if b < L):
        codes[i::7, p] = 4
    hot = rng.random(codes.shape) < 0.01
    codes[hot] = rng.choice(np.array([4, 5, 7, 255], np.uint8), size=int(hot.sum()))
    return codes, lengths


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


@pytest.mark.parametrize("N", [0, 1, 31, 32, 33, 255, 256, 257, 1000, 4097])
@pytest.mark.parametrize("W", [1, 33, 105])
@pytest.mark.parametrize("pattern", ["random", "none", "events", "alternate"])
def test_compact_rows_kernel_tile_edges(cuda, N, W, pattern):
    """K5 (one pass on the look-back scan, 32 rows a warp, 256 a tile) at
    row counts on both sides of the warp and tile edges, with rows without
    a hit, full event rows (every window an event) and rows of R - 1 runs
    (over 32 at W = 105): one launch a call, outputs equal to the plain
    version's."""
    idx, hit, valid, cid, off, clamped = _thread_case(
        N, W, "all" if pattern == "events" else pattern, 7000 * W + N)
    if pattern == "events":
        off = torch.zeros_like(off)
    rows = [t.to(cuda) for t in tth.thread_windows_plain(clamped, hit, valid, cid, off)]
    lib = kernels.library()
    before = dict(lib.launches)
    got = tth.compact_thread_outputs(*rows)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in lib.launches.items() if c != before[n]} == (
        {"compact_rows": 1})
    for g, w in zip(got, tth.compact_thread_outputs_plain(*rows)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if pattern == "events" and N:
        assert int(got[6].min()) == W


def test_compact_rows_kernel_refuses_shapes(cuda):
    idx, hit, valid, cid, off, clamped = _thread_case(3, 9, "random", 1)
    rows = [t.to(cuda) for t in tth.thread_windows_plain(clamped, hit, valid, cid, off)]
    with pytest.raises(ValueError, match="disagree"):
        tth.compact_thread_outputs(*rows[:3], rows[3][:, :4].contiguous(), *rows[4:])
    with pytest.raises(TypeError, match="int64"):
        tth.compact_thread_outputs(rows[0].int(), *rows[1:])


def label_links(kind: str, C2: int, seed: int) -> np.ndarray:
    """prev_link arrays of known shape on C2 lanes, their lanes shuffled:
    "isolated" (every lane a head), "chains_pow2" / "chains_pow2_plus1"
    (chains of 2^j and 2^j + 1 nodes for j = 0, 1, ...), "one_chain" (all
    C2 lanes one chain: the most rounds), "cycles" (cycles of 2, 3, 4 and
    8 nodes mixed with chains), "self" (self-loops beside chains) and
    "random" (any prev in [-1, C2): tails running into cycles too),
    "one_cycle" (all C2 lanes one cycle: the most rounds of the cycle cut)
    and "cycles_pow2" / "cycles_pow2_plus1" (cycles of 2^j and 2^j + 1
    nodes)."""
    rng = np.random.default_rng(seed)
    lanes = rng.permutation(C2)
    prev = np.full(C2, -1, np.int64)
    if kind == "random":
        return np.where(rng.random(C2) < 0.2, -1, rng.integers(0, C2, C2))
    if kind == "isolated":
        return prev
    if kind == "one_chain":
        sizes = [C2]
    elif kind == "one_cycle":
        sizes = [("cycle", C2)]
    elif kind in ("cycles_pow2", "cycles_pow2_plus1"):
        sizes, j = [], 0
        while sum(n for _, n in sizes) < C2:
            sizes.append(("cycle", (1 << j) + (kind == "cycles_pow2_plus1")))
            j += 1
    elif kind in ("chains_pow2", "chains_pow2_plus1"):
        sizes, j = [], 0
        while sum(sizes) < C2:
            sizes.append((1 << j) + (kind == "chains_pow2_plus1"))
            j += 1
    else:
        pattern = [("cycle", 2), ("chain", 5), ("cycle", 3), ("cycle", 4), ("chain", 9),
                   ("cycle", 8), ("chain", 1)] if kind == "cycles" else [("cycle", 1), ("chain", 3)]
        sizes = pattern * -(-C2 // sum(n for _, n in pattern))
    at = 0
    for item in sizes:
        form, n = item if isinstance(item, tuple) else ("chain", item)
        group = lanes[at:at + n]
        at += n
        if len(group) == 0:
            break
        prev[group[1:]] = group[:-1]
        if form == "cycle" and len(group) == n:
            prev[group[0]] = group[-1]
    return prev


@pytest.mark.parametrize("kind", ["isolated", "chains_pow2", "chains_pow2_plus1", "one_chain",
                                  "cycles", "self", "random"])
@pytest.mark.parametrize("C2", [1, 2, 31, 32, 33, 1000, 65_537, 1 << 20])
def test_label_stage_kernel_matches_plain(cuda, kind, C2):
    """K13's label stage (every round enqueued at once over a frontier) on
    chains of 2^j and 2^j + 1 nodes, one chain of every lane (the round
    cap), power-of-two cycles (their lanes point at themselves and their
    offsets still double) and any links at all: ptr, dist and has_cycle
    equal the plain version's, in one launch count and one host read."""
    prev = torch.from_numpy(label_links(kind, C2, seed=C2)).to(cuda)
    want = tcd.label_stage_plain(prev)
    lib = kernels.library()
    before = lib.launches["label_round"]
    info = {}
    ptr, dist, has_cycle = tcd.label_stage(prev, info=info)
    torch.cuda.synchronize()
    assert lib.launches["label_round"] - before == 1
    _equal(ptr, want[0], "ptr")
    _equal(dist, want[1], "dist")
    assert has_cycle == want[2]
    if kind == "cycles" and C2 > 1 or kind == "self":
        assert has_cycle
    assert info["host_reads"] == 1 and len(info["frontier"]) == info["rounds_run"]
    assert info["frontier"][0] == C2
    assert 1 <= info["rounds_run"] <= max(C2.bit_length(), 1)


@pytest.mark.parametrize("with_ptr", [True, False])
@pytest.mark.parametrize("kind", ["cycles", "self", "random", "one_cycle", "chains_pow2"])
@pytest.mark.parametrize("C2", [1, 2, 31, 32, 33, 1000, 65_537, 1 << 20])
def test_cycle_fix_kernel_matches_plain(cuda, kind, C2, with_ptr):
    """K13's cycle cut (every round enqueued at once over the cycle lanes
    the label stage found, stopping after the first round that changes no
    minimum) equals the plain version on power-of-two cycles, self-loops,
    rho shapes, one cycle of every lane (every round runs) and chains
    (nothing to cut), with the label stage's pointers and without: one
    launch count a call, no host read, at most R rounds."""
    prev = torch.from_numpy(label_links(kind, C2, seed=C2)).to(cuda)
    want = tcd.cycle_fix_plain(prev)
    head_ptr = tcd.label_stage(prev)[0] if with_ptr else None
    lib = kernels.library()
    before = dict(lib.launches)
    info = {}
    cut = tcd.cycle_fix(prev, head_ptr, info=info)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in lib.launches.items() if c != before[n]}
    assert launched == ({"cycle_round": 1} if with_ptr else {"cycle_round": 1, "label_round": 1})
    _equal(cut, want, "cut")
    assert info["host_reads"] == 0
    assert 1 <= info["rounds_run"] == len(info["changed"]) <= max(C2.bit_length(), 1)
    assert info["frontier"] == int((prev[tcd.label_stage_plain(prev)[0]] >= 0).sum())
    if kind == "one_cycle":
        assert info["rounds_run"] == max(C2.bit_length(), 1)
    if kind == "chains_pow2":
        assert info["frontier"] == 0 and info["rounds_run"] == 1
        assert torch.equal(cut, prev)
    # no read of the card without info
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = tcd.cycle_fix(prev, head_ptr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _equal(again, want, "cut, no info")


def test_cycle_fix_kernel_refuses_shapes(cuda):
    prev = torch.from_numpy(label_links("cycles", 64, seed=1)).to(cuda)
    with pytest.raises(ValueError, match="disagree"):
        tcd.cycle_fix(prev, prev[:-1].contiguous())
    with pytest.raises(TypeError, match="int64"):
        tcd.cycle_fix(prev, prev.int())


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


@pytest.mark.parametrize("B", [20_480, 327_680])
def test_sf_jobs_kernel_at_scale(cuda, B):
    """K29 at K6's 4,096 and 65,536 jobs as their 5 seeded restart rows
    each: flows bit-equal to the plain version's, in one launch."""
    buf = torch.from_numpy(_sf_jobs(B, B // 5)).to(cuda)
    rows = tsf.restart_rows(buf, 4)
    lib = kernels.library()
    before = lib.launches["sf_jobs"]
    got = tsf.batched_greedy(*rows)
    assert lib.launches["sf_jobs"] - before == 1
    want = tsf.batched_greedy_plain(*(x.cpu() for x in rows))
    assert torch.equal(got.view(torch.int32).cpu(), want.view(torch.int32))


@pytest.mark.parametrize("shape", [(5, 7), (2, 3), (7, 8), (8, 1)])
def test_sf_jobs_kernel_mixed_sizes(cuda, shape):
    """One launch over rows whose real sizes vary below M x N < 8 x 8 (zero
    margins past each row's size, some rows all zero): bit-equal to the
    plain version."""
    M, N = shape
    rng = np.random.default_rng(M * 10 + N)
    B = 4099
    a = np.zeros((B, M), np.float32)
    b = np.zeros((B, N), np.float32)
    for r in range(B):
        if r % 7 == 0:
            continue
        m, n = int(rng.integers(1, M + 1)), int(rng.integers(1, N + 1))
        ints = r % 2 == 0
        a[r, :m] = rng.integers(1, 4, m) if ints else rng.uniform(0.1, 50, m)
        b[r, :n] = rng.integers(1, 4, n) if ints else rng.uniform(0.1, 50, n)
    args = (torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(rng.integers(0, 1 << 32, B, dtype=np.int64)),
            torch.arange(B) % 3 != 0)
    got = tsf.batched_greedy(*(x.to(cuda) for x in args))
    want = tsf.batched_greedy_plain(*args)
    assert got.shape == want.shape == (B, M, N)
    assert torch.equal(got.view(torch.int32).cpu(), want.view(torch.int32))


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


def _k6_jobs(kind: str, B: int, seed: int) -> np.ndarray:
    """K6's jobs of 1-8 by 1-8 margins: random real margins, all ties (every
    cell ties at every step), tiny margins beside a large one, or zero
    margins (nothing to pair); a random node seed each."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((B, 2 * tsf.MAXD + 1), np.int32)
    f = buf[:, : 2 * tsf.MAXD].view(np.float32)
    for r in range(B):
        M, N = int(rng.integers(1, 9)), int(rng.integers(1, 9))
        if kind == "random":
            f[r, :M] = rng.uniform(0.1, 50, M)
            f[r, tsf.MAXD : tsf.MAXD + N] = rng.uniform(0.1, 50, N)
        elif kind == "ties":
            f[r, :M] = 2.0
            f[r, tsf.MAXD : tsf.MAXD + N] = np.float32(2.0 * M / N)
        elif kind == "tiny":
            f[r, :M] = 1e-7
            f[r, 0] = 3.0
            f[r, tsf.MAXD : tsf.MAXD + N] = np.float32(1e-8)
            f[r, tsf.MAXD + N - 1] = np.float32(3.0 + 1e-7 * (M - 1))
    buf[:, 2 * tsf.MAXD] = rng.integers(0, 1 << 32, B, dtype=np.int64).astype(np.uint32).view(np.int32)
    return buf


def _k6_both(buf: torch.Tensor, restarts: int, max_steps: int) -> None:
    got = tsf.batched_greedy_packed(buf, restarts, max_steps)
    want = tsf.batched_greedy_packed_plain(buf, restarts, max_steps)
    torch.cuda.synchronize()
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["random", "ties", "tiny", "zero"])
@pytest.mark.parametrize("restarts", [0, 1, 4, 40])
@pytest.mark.parametrize("max_steps", [1, 4, 16])
def test_sf_greedy_kernel_on_margin_kinds(cuda, kind, restarts, max_steps):
    """K6 (a warp a restart, a job's restarts and their selection in one
    block) against its plain twin: flows bitwise, picks equal, at restart
    counts below, at and above a block's 8 warps and with the greedy cut
    short."""
    _k6_both(torch.from_numpy(_k6_jobs(kind, 1000, restarts * 17 + max_steps)).to(cuda),
             restarts, max_steps)


@pytest.mark.parametrize("B", [0, 1])
@pytest.mark.parametrize("restarts", [0, 4, 40])
def test_sf_greedy_kernel_on_no_job_and_one(cuda, B, restarts):
    _k6_both(torch.from_numpy(_sf_jobs(B, max(B, 1))[:B]).to(cuda), restarts, 2 * tsf.MAXD)


def test_sf_greedy_is_one_launch_with_two_allocations(cuda):
    """One launch a call and no global scratch: the call allocates its F
    and picks alone."""
    buf = torch.from_numpy(_sf_jobs(11, 2048)).to(cuda)  # outputs below 1 MB each
    lib = kernels.library()
    before = lib.launches["sf_greedy"]
    tsf.batched_greedy_packed(buf, 4)
    assert lib.launches["sf_greedy"] - before == 1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    F, picks = tsf.batched_greedy_packed(buf, 4)
    torch.cuda.synchronize()
    outputs = F.numel() * F.element_size() + picks.numel() * picks.element_size()
    assert torch.cuda.max_memory_allocated() - base <= outputs + 2 * 512


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


def _prune_rounds_both(counts, idx, hit, ratio, eps3, use_cap, rounds: int) -> dict:
    """K9's loop against its plain loop on the same CUDA inputs: counts and
    changed equal, the input unwritten, one launch (none at rounds 0), no
    host read at rounds >= 2 without info (a sync raises there), and with
    info the plain loop's rounds and pruned counts.  Returns the info."""
    lib = kernels.library()
    before_in = counts.clone()
    want_info, info = {}, {}
    want = tcor.prune_rounds_plain(counts, idx, hit, ratio, eps3, use_cap, rounds, want_info)
    torch.cuda.synchronize()
    launched = lib.launches["prune_round"]
    if rounds >= 2:
        torch.cuda.set_sync_debug_mode("error")
    try:
        got = tcor.prune_rounds(counts, idx, hit, ratio, eps3, use_cap, rounds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lib.launches["prune_round"] - launched == (1 if rounds >= 1 else 0)
    assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
    assert got[1] == want[1]
    again = tcor.prune_rounds(counts, idx, hit, ratio, eps3, use_cap, rounds, info)
    assert torch.equal(again[0], want[0]) and again[1] == want[1]
    assert (info["rounds_run"], info["pruned"]) == (want_info["rounds_run"], want_info["pruned"])
    assert info["host_reads"] == (1 if rounds >= 1 else 0)
    assert torch.equal(counts, before_in)  # the input is never written
    if rounds >= 1:  # the plain round on the loop's output changes nothing
        assert not tcor.prune_round_plain(got[0], idx, hit, ratio, eps3, use_cap)[1]
    return info


@pytest.mark.parametrize("k", [16, 24, 31])
@pytest.mark.parametrize("rounds", [0, 1, 2, 8])
@pytest.mark.parametrize("error_rate", [0.0, 0.01])
def test_prune_rounds_kernel_matches_plain(cuda, k, rounds, error_rate):
    """K9's loop (one launch of round 1) against the plain loop of rounds
    from the main path's rescue, at rounds 0, 1, 2 and correct_spectrum's
    8, with and without the error cap."""
    spec = _to(_spectrum(k), cuda)
    sib = tcor.probe_resolve_plain(spec, k, True, "sib")
    ext = tcor.probe_resolve_plain(spec, k, True, "ext")
    raw, counts = tcor.cut_counts(spec, 2)
    counts = tcor.rescue_rounds_plain(counts, raw, *sib, *ext, k + 2)[0]
    ratio, eps3 = tcor.prune_constants(0.1, error_rate)
    info = _prune_rounds_both(counts, *sib, ratio, eps3, error_rate > 0, rounds)
    if rounds >= 1:
        assert info["pruned"][0] > 0  # the round prunes lanes


@pytest.mark.parametrize("rounds", [0, 1, 2, 8])
@pytest.mark.parametrize("error_rate", [0.0, 0.01, 0.02])
def test_prune_rounds_kernel_float_grid(cuda, rounds, error_rate):
    """K9's loop on the float grid (every count 1..255 against every
    sibling maximum 1..4095): exact, and a second round prunes nothing."""
    counts, idx, hit = (torch.from_numpy(a).to(cuda) for a in prune_grid()[:3])
    ratio, eps3 = tcor.prune_constants(0.1, error_rate)
    info = _prune_rounds_both(counts, idx, hit, ratio, eps3, error_rate > 0, rounds)
    if rounds >= 1:
        assert info["pruned"][0] > 0 and info["pruned"][1:] in ([], [0])


def test_prune_rounds_refuses_a_negative_ratio_or_eps3(cuda):
    """The loop is round 1 only where the decision grows with the sibling
    maximum: prune_rounds refuses rounds >= 2 with a negative ratio or
    eps3 before it launches, and takes them at one round."""
    counts, idx, hit = (torch.from_numpy(a).to(cuda) for a in prune_grid(8, 16)[:3])
    for ratio, eps3 in ((-0.1, 0.0), (0.1, -0.01)):
        with pytest.raises(ValueError, match="ratio >= 0"):
            tcor.prune_rounds(counts, idx, hit, ratio, eps3, True, 2)
        got = tcor.prune_rounds(counts, idx, hit, ratio, eps3, True, 1)
        assert got[0].shape == counts.shape


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


def k22_tables(k: int, canonical: bool, C: int = 512) -> dict:
    """Spectra of C lanes for K22, made from seeds (counts 0..97 on real
    lanes): "sparse" n < C; "full" n == C; "one" n == 1; "empty" n == 0;
    "overflow" n == C + 7 (every lane real); "palindromic" (even k) keys
    that are their own reverse complements with their siblings."""
    real = probe_table("dense", k, canonical, C=4096)
    real = real[real != PAD][:C]
    assert len(real) == C
    rng = np.random.default_rng(k + 2 * canonical)
    out = {}
    for name, m, n in (("sparse", C - C // 5, C - C // 5), ("full", C, C), ("one", 1, 1),
                       ("empty", 0, 0), ("overflow", C, C + 7)):
        key = np.full(C, PAD, np.int64)
        key[:m] = real[:m] if name != "sparse" else np.sort(rng.choice(real, m, replace=False))
        out[name] = (key, n)
    if k % 2 == 0:
        key = probe_table("palindromic", k, canonical, C=C)
        assert (key[key != PAD] == _revcomp_np(key[key != PAD], k)).any()
        out["palindromic"] = (key, int((key != PAD).sum()))
    return {name: Spectrum(key=torch.from_numpy(key),
                           count=torch.from_numpy(np.where(key == PAD, 0, rng.integers(
                               0, 98, C)).astype(np.int32)), n=n)
            for name, (key, n) in out.items()}


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
    assert lib.launches["probe_lookup"] > 0 and lib.launches["prune_round"] == 1
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


def _revcomp_np(x: np.ndarray, k: int) -> np.ndarray:
    out, y = np.zeros_like(x), x.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (y & 3))
        y = y >> 2
    return out


# (k, canonical) of each stress case of stage_tables
STAGE_TABLES = {
    "empty": (15, True), "one": (15, True), "no_A": (15, True), "no_T": (15, True),
    "palindromes": (4, True), "odd_k": (15, True), "k31": (31, True),
    "tips": (15, False), "four_runs": (15, False),
}
# lanes of a stress spectrum (its node table has twice as many) and of a table
STAGE_SPECTRUM_LANES, STAGE_TABLE_LANES = 2048, 4096


def stage_tables(case: str) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """Sorted distinct keys that stress K11's and K12's designs, with counts
    1-60, made from a seed: (keys, counts, k, canonical).  With canonical
    the keys are canonical k-mers, a spectrum for nodes_stage (whose node
    table then feeds links_stage); otherwise a node table for links_stage.
    "empty" and "one": n = 0 and 1; "no_A" and "no_T": no node starts with
    A / with T (an empty source run); "palindromes": all 16 k-mers of k = 4
    that are their own reverse complement; "odd_k": k = 15, which has
    none; "k31"; "tips": 1,500 nodes starting with T whose suffixes fill a
    range no prefix falls in, beside 1,200 random ones, so one key-range
    tile holds about three times K12's source cap of one run and few
    targets; "four_runs": 300 (k-1)-mers each the suffix of one node of
    every first base (four sources in four runs) and the prefix of 0-4
    nodes."""
    k, canonical = STAGE_TABLES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    hs = 2 * (k - 1)

    def kmers(n, first=range(4), last=range(4)):
        mid = rng.integers(0, 1 << (hs - 2), n) if k > 1 else np.zeros(n, np.int64)
        return (rng.choice(list(first), n) << hs) | (mid << 2) | rng.choice(list(last), n)

    if case == "empty":
        keys = np.zeros(0, np.int64)
    elif case == "palindromes":
        h = np.arange(16, dtype=np.int64)
        keys = (h << 4) | _revcomp_np(h, 2)
    elif case == "tips":
        lo = 2 << 26  # the suffixes of the tips: [lo, lo + 1500)
        rand = kmers(4000)
        rand = rand[((rand >> 2) < lo) | ((rand >> 2) >= lo + 1500)][:1200]
        keys = np.concatenate([rand, (3 << hs) | np.arange(lo, lo + 1500, dtype=np.int64)])
    elif case == "four_runs":
        suf = rng.integers(0, 1 << hs, 300)
        src = (np.arange(4, dtype=np.int64)[:, None] << hs) | suf[None, :]
        tgt = [(s << 2) | c for s in suf for c in rng.permutation(4)[: rng.integers(0, 5)]]
        keys = np.concatenate([src.ravel(), np.array(tgt, np.int64)])
    else:
        n = {"one": 1, "odd_k": 1500, "k31": 1500}.get(case, 1200)
        first, last = {"no_A": ((1, 2, 3), (0, 1, 2)),
                       "no_T": ((0, 1, 2), (1, 2, 3))}.get(case, (range(4), range(4)))
        keys = kmers(n, first, last)
    if canonical:
        keys = np.minimum(keys, _revcomp_np(keys, k))
    keys = np.unique(keys)
    return keys, rng.integers(1, 61, len(keys)).astype(np.int32), k, canonical


def stage_input(case: str, device="cpu"):
    """stage_tables(case) padded with PAD: a Spectrum of STAGE_SPECTRUM_LANES
    lanes (canonical cases) or a node table of STAGE_TABLE_LANES lanes."""
    keys, counts, k, canonical = stage_tables(case)
    if canonical:
        return spectrum_from_arrays(keys.astype(np.uint64), counts, STAGE_SPECTRUM_LANES,
                                    device=device), k
    table = np.full(STAGE_TABLE_LANES, PAD, np.int64)
    table[: len(keys)] = keys
    return torch.from_numpy(table).to(device), k


# (k, canonical) of each reduce_tables case
REDUCE_TABLES = {
    "empty": (21, True), "all_pad": (21, True), "one_contig": (21, False),
    "singletons": (21, False), "twins_palindromes": (24, True), "non_canonical": (21, False),
    "cycles": (21, False),
}


def _seq_kmers(seq: str, k: int) -> np.ndarray:
    """The forward k-mer keys of every window of seq (2 bits a base)."""
    codes = np.array(["ACGT".index(c) for c in seq], np.int64)
    out = np.zeros(max(len(codes) - k + 1, 0), np.int64)
    for j in range(k):
        out = (out << 2) | codes[j:j + len(out)]
    return out


def reduce_tables(case: str, C2: int = 4096) -> tuple[np.ndarray, np.ndarray, int, int, bool]:
    """Node tables that stress K14, made from a seed: (node_key [C2] sorted,
    PAD past n_nodes; node_count [C2] int32, 0 on pads; n_nodes; k;
    canonical).  "empty": no lane at all; "all_pad": C2 pad lanes;
    "one_contig": the k-mers of one sequence, one chain through every real
    node; "singletons": C2 - 3 random k-mers that share no (k-1)-mer, every
    node a contig of its own (the contig ids run to the table's last
    tiles); "twins_palindromes": both strands of sequences with a
    palindromic junction h + revcomp(h) at even k (rc twins, and palindromes
    that are their own twin); "non_canonical": one strand of two sequences
    that share a middle segment (branches); "cycles": tandem repeats beside
    a chain, whose isolated cycles cycle_fix cuts."""
    k, canonical = REDUCE_TABLES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + C2)
    if case == "empty":
        C2 = 0

    def seq(n: int) -> str:
        return random_seq(rng, n)

    if case in ("empty", "all_pad"):
        keys = np.zeros(0, np.int64)
    elif case == "singletons":
        keys = rng.integers(0, 1 << (2 * k), max(C2 - 3, 0))
    else:
        if case == "one_contig":
            seqs = [seq(min(600, C2) + k - 1)]
        elif case == "twins_palindromes":
            seqs = []
            for _ in range(3):
                h = seq(40)
                seqs.append(seq(80) + h + revcomp_str(h) + seq(80))
        elif case == "non_canonical":
            m = seq(90)
            seqs = [seq(120) + m + seq(120), seq(100) + m + seq(140)]
        else:
            seqs = [seq(n) * 4 for n in (37, 52, 71)] + [seq(300)]
        keys = np.concatenate([_seq_kmers(x, k) for x in seqs])
    if canonical:
        keys = np.concatenate([keys, _revcomp_np(keys, k)])
    keys = np.unique(keys)
    n = len(keys)
    node_key = np.full(C2, PAD, np.int64)
    node_key[:n] = keys
    node_count = np.zeros(C2, np.int32)
    node_count[:n] = rng.integers(1, 61, n)
    return node_key, node_count, n, k, canonical


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
        cut = tcd.cycle_fix(prev, ptr)  # as build_contig_arrays calls it
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


@pytest.mark.parametrize("case,C2", [(case, 4096) for case in REDUCE_TABLES] + [
    ("singletons", C2) for C2 in (4095, 4097, 65_537)])
def test_reduce_kernel_on_edge_tables(cuda, case, C2, monkeypatch):
    """K14 against its plain version on reduce_tables' edge tables (the
    labels from the plain stages, cycles cut), every field over the full
    capacity, and at C2 one either side of the scan's tile of 4,096 lanes
    and across 17 tiles: one launch count, no torch.cumsum, its three
    kernels and no other, and less than one int32 array a lane allocated
    beyond its outputs ("empty" has no lane: no kernel launches)."""
    node_key, node_count, n_nodes, k, canonical = reduce_tables(case, C2)
    key = torch.from_numpy(node_key)
    prev, rec_lane, first_p, p_cnt = tcd.links_stage_plain(key, k)
    ptr, dist, has_cycle = tcd.label_stage_plain(prev)
    if has_cycle:
        prev = tcd.cycle_fix_plain(prev)
        ptr, dist, _ = tcd.label_stage_plain(prev)
    args = tuple(x.to(cuda) if torch.is_tensor(x) else x for x in (
        key, torch.from_numpy(node_count), n_nodes, prev, ptr, dist, rec_lane, first_p, p_cnt,
        k, canonical))
    want = tcd.reduce_stage_plain(*args)
    lib = kernels.library()
    before = lib.launches["contig_reduce"]
    cumsums, real_cumsum = [], torch.cumsum

    def counted_cumsum(*a, **kw):
        cumsums.append(1)
        return real_cumsum(*a, **kw)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    monkeypatch.setattr(torch, "cumsum", counted_cumsum)
    ca = tcd.reduce_stage(*args)
    monkeypatch.undo()
    torch.cuda.synchronize()
    fields = ("node_cid", "node_off", "klen", "abundance", "count_sum", "head_lane",
              "tail_lane", "out_edges", "rc_pair")
    outputs = sum(getattr(ca, f).numel() * getattr(ca, f).element_size() for f in fields)
    # the allocator rounds each of the call's dozen blocks up to 512 bytes
    assert torch.cuda.max_memory_allocated() - base < outputs + 4 * C2 + 16 * 512
    assert lib.launches["contig_reduce"] - before == 1 and not cumsums
    for f in fields:
        _equal(getattr(ca, f), getattr(want, f), f)
    assert (ca.n_nodes, ca.n_contigs) == (want.n_nodes, want.n_contigs)
    names = _kernel_names(lambda: tcd.reduce_stage(*args))
    assert {x for x in names if x.startswith("contig_")} == (
        {"contig_heads_kernel", "contig_lanes_kernel", "contig_slots_kernel"}
        if key.shape[0] else set())
    assert not any("Scan" in x or "head_flags" in x for x in names)


# K15's edge tables: reduce_tables' cases, and singletons tables whose
# n_contigs (C2 - 3) is K15's scan tile of 256 contigs or 16 of them, and one
# either side
STREAM_CASES = [(case, 4096) for case in REDUCE_TABLES] + [
    ("singletons", C2) for C2 in (258, 259, 260, 4098, 4099, 4100)]


def _stream_arrays(cuda, case: str, C2: int):
    """The ContigArrays K14 makes on the card of one reduce_tables case (the
    labels from the plain stages, cycles cut), and its k."""
    node_key, node_count, n_nodes, k, canonical = reduce_tables(case, C2)
    key = torch.from_numpy(node_key)
    prev, rec_lane, first_p, p_cnt = tcd.links_stage_plain(key, k)
    ptr, dist, has_cycle = tcd.label_stage_plain(prev)
    if has_cycle:
        prev = tcd.cycle_fix_plain(prev)
        ptr, dist, _ = tcd.label_stage_plain(prev)
    args = tuple(x.to(cuda) if torch.is_tensor(x) else x for x in (
        key, torch.from_numpy(node_count), n_nodes, prev, ptr, dist, rec_lane, first_p, p_cnt,
        k, canonical))
    return tcd.reduce_stage(*args), k


@pytest.mark.parametrize("case,C2", STREAM_CASES)
def test_base_streams_kernel_on_edge_tables(cuda, case, C2, monkeypatch):
    """K15 against its plain twin on the edge tables: tails and heads equal,
    one launch count, no torch.cumsum, no host read (the card's sync debug
    mode raises on one), its two kernels and no other; and the lanes past
    n_nodes are never read: poisoned, they change nothing."""
    ca, k = _stream_arrays(cuda, case, C2)
    if case == "singletons":
        assert ca.n_contigs == C2 - 3
    want = tcd.contig_base_streams_plain(ca, k)
    lib = kernels.library()
    before = lib.launches["base_streams"]
    cumsums, real_cumsum = [], torch.cumsum

    def counted_cumsum(*a, **kw):
        cumsums.append(1)
        return real_cumsum(*a, **kw)

    torch.cuda.synchronize()
    monkeypatch.setattr(torch, "cumsum", counted_cumsum)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tcd.contig_base_streams(ca, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        monkeypatch.undo()
    torch.cuda.synchronize()
    assert lib.launches["base_streams"] - before == 1 and not cumsums
    for g, w, name in zip(got, want, ("tails", "heads")):
        _equal(g, w, name)
    n = ca.n_nodes
    poisoned = tcd.ContigArrays(**{**ca.__dict__})
    for name, value in (("node_cid", 0), ("node_off", 0), ("node_key", 3)):
        t = getattr(ca, name).clone()
        t[n:] = value
        setattr(poisoned, name, t)
    for g, w, name in zip(tcd.contig_base_streams(poisoned, k), want, ("tails", "heads")):
        _equal(g, w, name)
    names = _kernel_names(lambda: tcd.contig_base_streams(ca, k))
    assert {x for x in names if "stream" in x} == (
        {"stream_heads_kernel", "tails_stream_kernel"} if ca.n_contigs else set())
    assert not any("Scan" in x for x in names)


def _kernel_names(fn) -> set:
    """The CUDA kernels one call of fn launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {evt.name.split("(")[0] for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not evt.name.startswith(("Memset", "Memcpy"))}


@pytest.mark.parametrize("case", list(STAGE_TABLES))
def test_nodes_links_kernels_stress_shapes(cuda, case, monkeypatch):
    """K11 and K12 on stage_tables' stress cases against their plain twins
    over the full capacity, one launch a stage call.  K11 sorts the n real
    reverse complements alone and launches neither K2 nor a search; K12
    sorts nothing, launches only its two kernels and allocates less than
    one 2*C2 int64 array beyond its outputs; K12 also at 7 target lanes a
    tile (no tile width divides C2, and most tiles take several chunks)."""
    inp, k = stage_input(case, cuda)
    lib = kernels.library()
    sorts, real_sort = [], torch.sort

    def counted_sort(x, *args, **kw):
        sorts.append(x.numel())
        return real_sort(x, *args, **kw)

    if isinstance(inp, Spectrum):
        want = tcd.nodes_stage_plain(inp, k, True)
        lib.reset_counts()
        monkeypatch.setattr(torch, "sort", counted_sort)
        got = tcd.nodes_stage(inp, k, True)
        monkeypatch.undo()
        assert sorts == [min(inp.n, inp.capacity)]
        assert (lib.launches["node_strands"], lib.launches["reduce_sorted"]) == (1, 0)
        _equal(got[0], want[0], "node_key")
        _equal(got[1], want[1], "node_count")
        assert got[2] == want[2]
        names = _kernel_names(lambda: tcd.nodes_stage(inp, k, True))
        assert {"node_merge_kernel"} | ({"node_rc_kernel"} if inp.n else set()) <= names
        assert not any("reduce_runs" in x or "search" in x or "node_counts" in x for x in names)
        node_key = got[0]
    else:
        node_key = inp
    C2 = node_key.shape[0]
    want = tcd.links_stage_plain(node_key, k)
    sorts.clear()
    lib.reset_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    monkeypatch.setattr(torch, "sort", counted_sort)
    got = tcd.links_stage(node_key, k)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < (40 + 16) * C2
    assert sorts == [] and lib.launches["group_links"] == 1
    for g, w, name in zip(got, want, ("prev_link", "rec_lane", "first_p", "p_cnt")):
        _equal(g, w, name)
    for g, w, name in zip(tcd._links_stage_cuda(node_key, k, tile=7), want,
                          ("prev_link", "rec_lane", "first_p", "p_cnt")):
        _equal(g, w, f"{name} at 7 lanes a tile")
    assert _kernel_names(lambda: tcd.links_stage(node_key, k)) == {
        "link_bounds_kernel", "link_tiles_kernel"}


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
    whose first 1,038,091 hold sorted distinct keys, nine in ten of count 1
    and the rest counts from -3 to 20,000 (some in bin 0, some past every
    max_count), or to 100,000 for the case "wide", and PAD with count 0
    past them (the Spectrum contract)."""
    if case == "counted":
        return _spectrum(24)
    if case == "all_pad":
        return empty_spectrum(4096, "cpu")
    if case == "no_lanes":
        return empty_spectrum(0, "cpu")
    rng = np.random.default_rng(2)
    C, n = 1 << 20, 1_038_091
    top = 100_000 if case == "wide" else 20_000
    count = np.zeros(C, np.int32)
    count[:n] = np.where(rng.random(n) < 0.9, 1, rng.integers(-3, top, n))
    key = np.full(C, PAD, np.int64)
    key[:n] = np.unique(rng.integers(0, 1 << 48, n + 64))[:n]
    return Spectrum(key=torch.from_numpy(key), count=torch.from_numpy(count), n=n)


@pytest.mark.parametrize("case", ["counted", "all_pad", "no_lanes", "count1_heavy"])
@pytest.mark.parametrize("max_count", [0, 64, 1024, 8192])
def test_count_histogram_kernel_matches_plain(cuda, case, max_count):
    """K16: bin for bin, h[0] = 0; one launch, also where no lane is
    real."""
    spec = _to(_histogram_spectrum(case), cuda)
    lib = kernels.library()
    before = lib.launches["count_histogram"]
    got = tcor.count_histogram(spec, max_count)
    assert lib.launches["count_histogram"] == before + 1
    want = tcor.count_histogram_plain(spec, max_count)
    torch.cuda.synchronize()
    _equal(got, want, "histogram")
    assert int(got[0]) == 0


@pytest.mark.parametrize("max_count", [8192, 8193, 65_536])
def test_count_histogram_kernel_at_any_max_count(cuda, max_count):
    """K16 at every width: bins below HIST_SMEM_BINS (8,192) in shared
    memory, higher ones by global atomics, on counts drawn up to 100,000."""
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


def _clip_inputs(dev, k: int = 24):
    """A counted spectrum on `dev`, its contig arrays (K11-K15) and one
    clip's host state (the port's host rounds)."""
    cfg = AssemblyConfig(k=k)
    spec = _to(_spectrum(k), dev)
    ca = tcd.build_contig_arrays(spec, k)
    n = ca.n_contigs
    st = ttc._host_clip_rounds(
        ca.klen[:n].cpu().numpy(), ca.count_sum[:n].cpu().numpy(),
        ttc._adjacency_lists(ca.out_edges[:, :n].cpu().numpy(), n), cfg,
    )
    return spec, ca, st


def _synthetic_contigs(node_key: np.ndarray, node_cid: np.ndarray, rng) -> tcd.ContigArrays:
    """Contig arrays around a node table (node_key sorted, PAD past its real
    lanes) and its contig ids; counts and offsets random, every per-contig
    field a placeholder (the drop and the remap read only the node fields)."""
    C2 = node_key.shape[0]
    z = torch.zeros(C2, dtype=torch.int64)
    return tcd.ContigArrays(
        node_key=torch.from_numpy(node_key), node_cid=torch.from_numpy(node_cid),
        node_count=torch.from_numpy(rng.integers(1, 1000, C2).astype(np.int32)),
        node_off=torch.from_numpy(rng.integers(-1, 300, C2)),
        klen=z, abundance=z.float(), count_sum=z, head_lane=z, tail_lane=z,
        out_edges=torch.zeros((4, C2), dtype=torch.int64), rc_pair=z,
        n_nodes=int((node_key != PAD).sum()), n_contigs=0,
    )


def _sorted_table(keys: np.ndarray, C: int) -> np.ndarray:
    out = np.full(C, PAD, np.int64)
    keys = np.unique(keys)
    out[: keys.shape[0]] = keys
    return out


# K18's inputs: the clip's own and its doom flags none, all and random; the
# clip's spectrum with keys absent from the node table (kept), all PAD (n =
# 0), with contig ids past C2 (the clamp to C2 - 1); synthetic tables with n
# real k-mers at 64 and 4,096 (the small and the kernel's tile) and one
# either side, 4,096 real nodes, so n + nodes also meets a tile edge; and a
# spectrum whose keys sit in the high key range, above a long run of nodes.
DROP_CASES = ["clip", "none", "all", "random", "absent", "all_pad",
              "cid_past_c2", "n_63", "n_64", "n_65", "n_4095", "n_4096", "n_4097",
              "high_keys"]


def drop_case(name: str) -> tuple:
    """(spectrum, contig arrays, doom flags over node lanes) of one K18
    case, on the CPU."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("n_") or name == "high_keys":
        C2, n_nodes, n_contigs = 8192, 4096, 700
        if name == "high_keys":
            low = rng.choice(1 << 40, size=n_nodes - 600, replace=False)
            high = (1 << 47) + rng.choice(1 << 40, size=600, replace=False)
            nodes = np.concatenate([low, high])
            spec_keys = np.concatenate([rng.choice(high, 300, replace=False),
                                        (1 << 47) + rng.choice(1 << 40, 200)])
            C = 1024
        else:
            nodes = rng.choice(1 << 46, size=n_nodes, replace=False)
            n = int(name[2:])
            hits = rng.choice(nodes, size=min(3 * n // 4, n_nodes), replace=False)
            absent = rng.choice(1 << 46, size=4 * n, replace=False)
            absent = rng.permutation(np.setdiff1d(absent, nodes))
            spec_keys = np.concatenate([hits, absent[: n - hits.shape[0]]])
            assert np.unique(spec_keys).shape[0] == n
            C = 8192
        node_key = _sorted_table(nodes, C2)
        node_cid = np.where(node_key != PAD, rng.integers(-1, n_contigs, C2), -1)
        ca = _synthetic_contigs(node_key, node_cid, rng)
        key = _sorted_table(spec_keys, C)
        n = int((key != PAD).sum())
        spec = Spectrum(key=torch.from_numpy(key), n=n,
                        count=torch.from_numpy(np.where(key != PAD, rng.integers(1, 99, C), 0)
                                               .astype(np.int32)))
        doomed = np.zeros(C2, bool)
        doomed[:n_contigs] = rng.random(n_contigs) < 0.4
        return spec, ca, torch.from_numpy(doomed)
    spec, ca, st = _clip_inputs("cpu")
    n, C2 = ca.n_contigs, ca.node_key.shape[0]
    assert st.doomed.any()
    doomed = torch.zeros(C2, dtype=torch.bool)
    doomed[:n] = torch.from_numpy(st.doomed)
    if name == "none":
        doomed[:] = False
    elif name == "all":
        doomed[:] = True
    elif name == "random":
        doomed[:n] = torch.from_numpy(np.random.default_rng(4).random(n) < 0.3)
    elif name == "absent":
        real = spec.key[: spec.n].numpy()
        extra = np.setdiff1d(rng.choice(1 << 48, 600, replace=False), ca.node_key.numpy())
        key = _sorted_table(np.concatenate([real, extra]), spec.capacity)
        count = np.zeros(spec.capacity, np.int32)
        count[np.searchsorted(key, real)] = spec.count[: spec.n].numpy()
        fresh = ~np.isin(key, real) & (key != PAD)
        count[fresh] = rng.integers(1, 99, int(fresh.sum()))
        spec = Spectrum(key=torch.from_numpy(key), count=torch.from_numpy(count),
                        n=int((key != PAD).sum()))
    elif name == "all_pad":
        spec = Spectrum(key=torch.full_like(spec.key, PAD), count=torch.zeros_like(spec.count),
                        n=0)
    elif name == "cid_past_c2":
        cid = ca.node_cid.clone()
        cid[: ca.n_nodes : 3] = C2 + torch.arange(0, ca.n_nodes, 3)
        ca = tcd.ContigArrays(**{**ca.__dict__, "node_cid": cid})
        doomed[C2 - 1] = True
    return spec, ca, doomed


def _contigs_to(ca: tcd.ContigArrays, dev) -> tcd.ContigArrays:
    return tcd.ContigArrays(**{f: (v.to(dev) if torch.is_tensor(v) else v)
                               for f, v in ca.__dict__.items()})


def _one_host_read(fn):
    """fn's result, and the messages of the synchronizing calls it made
    (the card's sync debug mode warns on each), after one call to warm the
    caching allocator and the kernel library."""
    import warnings

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in seen
                 if "called a synchronizing CUDA operation" in str(w.message)]


def _no_cumsum(monkeypatch, fn):
    """fn's result; fails if fn called torch.cumsum."""
    calls, real = [], torch.cumsum

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(torch, "cumsum", counted)
    try:
        out = fn()
    finally:
        monkeypatch.undo()
    assert not calls, "torch.cumsum ran"
    return out


@pytest.mark.parametrize("case", DROP_CASES)
def test_drop_contigs_kernel_matches_plain(cuda, case, monkeypatch):
    """K18 against its plain version on the same CUDA inputs: key, count
    and n equal, one launch count, no K10, no torch.cumsum and one host read
    (the n it returns)."""
    spec, ca, doomed = drop_case(case)
    spec, ca, doomed = _to(spec, cuda), _contigs_to(ca, cuda), doomed.to(cuda)
    lib = kernels.library()
    before = dict(lib.launches)
    got, reads = _one_host_read(
        lambda: _no_cumsum(monkeypatch, lambda: ttc._drop_contigs(spec, ca, doomed)))
    assert lib.launches["drop_contigs"] == before["drop_contigs"] + 2  # the warm-up's and ours
    assert lib.launches["compact_keep"] == before["compact_keep"]
    assert len(reads) == 1, reads
    want = ttc._drop_contigs_plain(spec, ca, doomed)
    torch.cuda.synchronize()
    assert got.n == want.n
    _equal(got.key, want.key, "key")
    _equal(got.count, want.count, "count")
    check_drop_count(case, spec, want)


def check_drop_count(case: str, spec: Spectrum, want: Spectrum) -> None:
    """What a K18 case's name promises of its result: the clip and random
    doom flags drop some real k-mers but not all, none drops none, all and
    an all-PAD spectrum leave nothing."""
    if case in ("clip", "none", "all", "random"):
        assert (want.n == 0) == (case == "all") and (want.n == spec.n) == (case == "none")
    if case == "all_pad":
        assert want.n == 0


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


def _remap_args(dev, doom: str):
    """_device_clip_remap's arguments: those one clip gives it (captured
    from _remap_clipped), or no contig doomed (every map the identity), or
    every contig doomed."""
    spec, ca, st = _clip_inputs(dev)
    if doom == "clip":
        return remap_args_of_clip(ca, st, ca.klen[: ca.n_contigs].cpu().numpy(), spec.n)
    n, C2 = ca.n_contigs, ca.node_key.shape[0]
    npad = tight_capacity(n, minimum=1 << 15)
    new_cid = torch.full((npad,), -1, dtype=torch.int64)
    if doom == "none":
        new_cid[:n] = torch.arange(n)
    return (ca, new_cid.to(dev), torch.zeros(npad, dtype=torch.int64, device=dev),
            ca.head_lane, ca.tail_lane, ca.klen, ca.count_sum, ca.rc_pair, ca.out_edges, n, C2)


# K19's synthetic node tables: C2 at the 32-lane word and the 64- and
# 4,096-lane tiles, and one either side.
REMAP_SIZES = [31, 32, 33, 63, 64, 65, 4095, 4096, 4097]


def remap_case(C2: int, cap: str) -> tuple:
    """_device_clip_remap's arguments on a random node table of C2 lanes,
    on the CPU: contig ids -1 and past the map's length among real ones,
    about half the contigs dropped, and head and tail lanes at -1, at
    dropped lanes, at C2 - 1, past C2, past out_cap and at kept lanes;
    out_cap the given one (half the table), below the kept lanes or above
    the table."""
    rng = np.random.default_rng(C2)
    n_real = C2 - C2 // 5
    node_key = _sorted_table(rng.choice(1 << 46, size=n_real, replace=False), C2)
    n_contigs = max(C2 // 6, 2)
    npad = n_contigs + 3
    node_cid = rng.integers(-1, n_contigs, C2)
    node_cid[rng.random(C2) < 0.05] = npad + 7  # clamped to the map's last entry
    node_cid[n_real:] = -1
    ca = _synthetic_contigs(node_key, node_cid, rng)
    M = max(n_contigs // 2, 16)
    new_cid = np.where(rng.random(npad) < 0.5, rng.integers(0, M, npad), -1)
    off_shift = rng.integers(0, 50, npad)
    kept = np.nonzero((node_cid >= 0) & (new_cid[np.clip(node_cid, 0, npad - 1)] >= 0))[0]
    dropped = np.setdiff1d(np.arange(C2), kept)
    n_keep = kept.shape[0]
    out_cap = {"given": C2 // 2, "below_kept": max(n_keep // 3, 1), "above_table": C2 + 100}[cap]
    picks = [np.full(M, -1), rng.integers(0, C2, M)]
    if dropped.size:
        picks.append(rng.choice(dropped, M))
    if kept.size:
        picks.append(rng.choice(kept, M))
        picks.append(np.full(M, kept[-1]))
    picks += [np.full(M, C2 - 1), np.full(M, C2 + 9)]
    choice = rng.integers(0, len(picks), (2, M))
    hl, tl = (np.choose(c, picks) for c in choice)
    hl[: len(picks)] = [x[0] for x in picks]  # every kind of lane at least once
    tl[: len(picks)] = [x[-1] for x in picks[::-1]]
    klen = rng.integers(0, 40, M)
    csum = rng.integers(0, 1 << 40, M)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))  # noqa: E731
    return (ca, t(new_cid), t(off_shift), t(hl), t(tl), t(klen), t(csum), t(np.arange(M)),
            torch.full((4, M), -1, dtype=torch.int64), M, out_cap)


def _remap_both(args, monkeypatch):
    """K19 and its plain version on the same CUDA arguments: every field
    equal over its full capacity, the float32 abundances bit for bit,
    n_nodes (every kept node, even past out_cap) and n_contigs; one launch
    count, no torch.cumsum and one host read (n_nodes).  Returns the plain
    result."""
    lib = kernels.library()
    before = lib.launches["clip_remap"]
    got, reads = _one_host_read(
        lambda: _no_cumsum(monkeypatch, lambda: ttc._device_clip_remap(*args)))
    assert lib.launches["clip_remap"] == before + 2  # the warm-up's and ours
    assert len(reads) == 1, reads
    want = ttc._device_clip_remap_plain(*args)
    torch.cuda.synchronize()
    for f in ("node_key", "node_count", "node_cid", "node_off", "klen", "count_sum",
              "head_lane", "tail_lane", "out_edges", "rc_pair"):
        _equal(getattr(got, f), getattr(want, f), f)
    _equal(got.abundance.view(torch.int32), want.abundance.view(torch.int32), "abundance")
    assert (got.n_nodes, got.n_contigs) == (want.n_nodes, want.n_contigs)
    return want


@pytest.mark.parametrize("doom", ["clip", "none", "all"])
@pytest.mark.parametrize("cap", ["given", "below_kept", "above_table"])
def test_clip_remap_kernel_matches_plain(cuda, doom, cap, monkeypatch):
    """K19 against its plain version on the same CUDA inputs (_remap_both)."""
    ca, *maps, n_new, out_cap = _remap_args(cuda, doom)
    C2 = ca.node_key.shape[0]
    if cap == "below_kept":
        out_cap = max(int((ca.node_cid >= 0).sum()) // 3, 1)
    elif cap == "above_table":
        out_cap = C2 + 1000
    want = _remap_both((ca, *maps, n_new, out_cap), monkeypatch)
    if doom == "all":
        assert want.n_nodes == 0
    if doom == "none":
        assert want.n_nodes == ca.n_nodes
        if cap == "given":
            _equal(want.node_cid, ca.node_cid, "identity remap")


@pytest.mark.parametrize("C2", REMAP_SIZES)
@pytest.mark.parametrize("cap", ["given", "below_kept", "above_table"])
def test_clip_remap_kernel_on_edge_tables(cuda, C2, cap, monkeypatch):
    """K19 against its plain version on remap_case's tables (_remap_both)."""
    ca, *maps = remap_case(C2, cap)
    args = (_contigs_to(ca, cuda), *(x.to(cuda) if torch.is_tensor(x) else x for x in maps))
    want = _remap_both(args, monkeypatch)
    if cap != "given":
        assert (want.n_nodes > args[-1]) == (cap == "below_kept")


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
@pytest.mark.parametrize("outputs", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("min_abundance", [-1, 0, 1, 3])
def test_abundance_cut_kernel_matches_plain(cuda, case, outputs, min_abundance):
    """K20 in every combination of its outputs; absent outputs stay None.
    count1_heavy holds real lanes of count 0 and below."""
    spec = _to(_histogram_spectrum(case), cuda)
    got = tcor.abundance_cut(spec, min_abundance, *outputs)
    want = tcor.abundance_cut_plain(spec, min_abundance, *outputs, keep=False)[:2]
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


# Tables at the edges of the Spectrum contract that K16 and K21 rely on
# (the real lanes first, strictly increasing; PAD with count 0 past min(n,
# C)): C twelve times n, as in the flagship table (174,607 real lanes in
# 2,097,152); n == C; n == 0 with C > 0; n above C (an overflowed count).
CONTRACT_CASES = ["sparse", "full", "empty", "overflow"]


def contract_case(name: str) -> tuple[Spectrum, list[np.ndarray]]:
    """(table on the CPU, queries) of one case, made of _spectrum(24)'s
    real lanes: the [8, C] sibling probes of every lane (a pad lane's probes
    repeat, warp after warp), and a shuffled flat set of hits, random
    misses, keys above and below every real key, and PAD."""
    base = _spectrum(24)
    n = base.n
    real_key, real_count = base.key[:n].numpy(), base.count[:n].numpy()
    C = {"sparse": 12 * n, "full": n, "empty": 4096, "overflow": n}[name]
    m = 0 if name == "empty" else n
    key = np.full(C, PAD, np.int64)
    key[:m] = real_key[:m]
    count = np.zeros(C, np.int32)
    count[:m] = real_count[:m]
    spec = Spectrum(key=torch.from_numpy(key), count=torch.from_numpy(count),
                    n=n + 7 if name == "overflow" else m)
    rng = np.random.default_rng(sum(map(ord, name)))
    top = int(real_key[-1])
    flat = np.concatenate([
        rng.choice(real_key, 3000), rng.integers(0, 1 << 48, 3000),
        top + 1 + rng.integers(0, 1 << 40, 500), [0, int(real_key[0]), top, top + 1, PAD - 1],
        np.full(100, PAD),
    ]).astype(np.int64)
    rng.shuffle(flat)
    probes = tsp.probe_keys(spec.key, 24, "sib", True).numpy()
    return spec, [flat, probes]


@pytest.mark.parametrize("case", CONTRACT_CASES)
def test_lookup_counts_kernel_on_contract_tables(cuda, case):
    """K21 == its plain version (which searches the whole table) on tables
    at the contract's edges; n == 0 returns zeros with no launch."""
    spec, queries = contract_case(case)
    spec = _to(spec, cuda)
    lib = kernels.library()
    for q in queries:
        before = lib.launches["lookup_counts"]
        query = torch.from_numpy(q).to(cuda)
        got = tsp.lookup_counts(spec, query)
        assert lib.launches["lookup_counts"] == before + (case != "empty")
        want = tsp.lookup_counts_plain(spec, query)
        torch.cuda.synchronize()
        _equal(got, want, "counts")
        assert (got[query == PAD] == 0).all()
        assert (got > 0).any() == (case != "empty")


@pytest.mark.parametrize("case", CONTRACT_CASES + ["unaligned"])
@pytest.mark.parametrize("max_count", [1024, 65_536])
def test_count_histogram_kernel_on_contract_tables(cuda, case, max_count):
    """K16 == its plain version on the contract's edge tables, and on a view
    that starts one lane into the wide table (its counts not 16-byte
    aligned), with a real-lane count that is not a multiple of 4."""
    if case == "unaligned":
        wide = _to(_histogram_spectrum("wide"), cuda)
        spec = Spectrum(key=wide.key[1:], count=wide.count[1:], n=wide.n - 1)
        assert spec.count.data_ptr() % 16 != 0 and spec.n % 4 != 0
    else:
        spec = _to(contract_case(case)[0], cuda)
    got = tcor.count_histogram(spec, max_count)
    want = tcor.count_histogram_plain(spec, max_count)
    torch.cuda.synchronize()
    _equal(got, want, "histogram")


# Tables of K20's transcription tests (tests/test_torch_correction.py) and
# cuda tests: real lanes ending inside a group of 16, on a compaction tile's
# edge and beside it, none, or all C = 8,195 lanes; cuts of 0, 1, 2 and 7,
# above every count.
K20_N_REAL = [0, 1, 5, 63, 4095, 4097, 6001, "C"]
K20_CUTS = [0, 1, 2, 7]


def cut_table(n_real, offset: int = 0, C: int = 8195, seed: int = 4,
              device="cpu") -> Spectrum:
    """A table of C lanes on `device` under the Spectrum contract: n_real
    ("C": every lane) sorted distinct keys with counts 0-6 first (real
    lanes of count 0 included), PAD with count 0 past them; with offset, a
    view that starts that many lanes into a table of C + offset lanes."""
    n = C if n_real == "C" else n_real
    rng = np.random.default_rng(seed + n)
    key = np.full(C + offset, PAD, np.int64)
    key[:n + offset] = np.sort(rng.choice(1 << 40, size=n + offset, replace=False))
    count = np.zeros(C + offset, np.int32)
    count[:n + offset] = rng.integers(0, 7, n + offset)
    key, count = torch.from_numpy(key).to(device), torch.from_numpy(count).to(device)
    return Spectrum(key=key[offset:], count=count[offset:], n=n)


@pytest.mark.parametrize("n_real", K20_N_REAL)
@pytest.mark.parametrize("m", K20_CUTS)
@pytest.mark.parametrize("offset", [0, 1])
def test_abundance_cut_and_filter_kernels_on_cut_tables(cuda, n_real, m, offset):
    """K20's two outputs == abundance_cut_plain's, and the abundance filter
    (one compaction, counted as K20, no K10) == compact_plain and K10 of
    abundance_cut_plain's keep flags, on the transcription tests' tables:
    aligned, and a view one lane past a 16-byte boundary."""
    spec = cut_table(n_real, offset, device=cuda)
    assert (spec.count.data_ptr() % 16 == 0) == (offset == 0)
    for g, w in zip(tcor.abundance_cut(spec, m), tcor.abundance_cut_plain(spec, m)):
        _equal(g, w, "abundance cut")
    _filter_matches_plain(spec, m)


def _filter_matches_plain(spec: Spectrum, m: int) -> None:
    lib = kernels.library()
    before = dict(lib.launches)
    got = tcor.abundance_filter(spec, m)
    assert lib.launches["abundance_cut"] == before["abundance_cut"] + 1
    assert lib.launches["compact_keep"] == before["compact_keep"]
    keep = tcor.abundance_cut_plain(spec, m, raw=False, cut=False)[2]
    for want in (tcor.compact_plain(spec, keep), tcor.compact(spec, keep)):
        assert got.n == want.n
        _equal(got.key, want.key, "filtered keys")
        _equal(got.count, want.count, "filtered counts")


@pytest.mark.parametrize("case", CONTRACT_CASES + ["unaligned", "counted", "count1_heavy",
                                                  "all_pad", "no_lanes"])
@pytest.mark.parametrize("m", [-1, 0, 1, 2, 3, 1 << 20])
def test_abundance_cut_and_filter_kernels_on_contract_tables(cuda, case, m):
    """K20's cut mode and the abundance filter == their plain versions on
    the contract's edge tables (n above C included), on a view one lane
    into the wide table, and on K16's tables (real lanes of count 0 and
    below, which the filter keeps at m <= 0)."""
    if case == "unaligned":
        wide = _to(_histogram_spectrum("wide"), cuda)
        spec = Spectrum(key=wide.key[1:], count=wide.count[1:], n=wide.n - 1)
        assert spec.count.data_ptr() % 16 != 0 and spec.n % 4 != 0
    elif case in CONTRACT_CASES:
        spec = _to(contract_case(case)[0], cuda)
    else:
        spec = _to(_histogram_spectrum(case), cuda)
    for outputs in ((True, True), (True, False), (False, True)):
        got = tcor.abundance_cut(spec, m, *outputs)
        want = tcor.abundance_cut_plain(spec, m, *outputs, keep=False)[:2]
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                _equal(g, w, "abundance cut")
    _filter_matches_plain(spec, m)


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


@pytest.mark.parametrize("k", [5, 16, 17, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_sibling_maxes_kernel_on_edge_tables(cuda, k, canonical):
    """K22 == its plain version (which searches the whole table) on
    k22_tables (n < C, n == C, n == 1, n == 0, n > C, palindromes at even
    k) into dirty memory: the kernel writes every lane, the zeros past the
    real lanes included; one launch a call, since these tables' index has
    at most one level (n <= 65,536), which each block of the kernel
    gathers from the table (two, the index build first, past that: the
    L2 test), and no host read."""
    lib = kernels.library()
    for name, spec in k22_tables(k, canonical).items():
        spec = _to(spec, cuda)
        want = tsp.sibling_maxes_plain(spec, k, canonical)
        _dirty(cuda, 4 * spec.capacity)
        before = lib.launches["sibling_maxes"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tsp.sibling_maxes(spec, k, canonical)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert lib.launches["sibling_maxes"] == before + 1
        torch.cuda.synchronize()
        _equal(got[0], want[0], f"{name}: right sibling maxima")
        _equal(got[1], want[1], f"{name}: left sibling maxima")
        names = _device_launches(lambda: tsp.sibling_maxes(spec, k, canonical))
        # the index build launches only where the index has two levels or more
        assert min(spec.n, spec.capacity) <= 16 * tsp.SEARCH_TOP_WORDS
        expect = ["sibling_maxes_kernel"]
        assert [x.split("(")[0] for x in names] == expect, (name, names)


def test_sibling_maxes_kernel_beyond_l2(cuda):
    """K22 on a table larger than the 50 MB L2: 2^24 lanes, 9,000,000 real
    random keys (k = 24, both canonical modes), against its plain
    version."""
    rng = np.random.default_rng(22)
    C, n = 1 << 24, 9_000_000
    key = torch.full((C,), PAD, dtype=torch.int64, device=cuda)
    key[:n] = torch.from_numpy(np.sort(rng.choice(1 << 48, n, replace=False))).to(cuda)
    count = torch.zeros(C, dtype=torch.int32, device=cuda)
    count[:n] = torch.from_numpy(rng.integers(1, 1000, n).astype(np.int32)).to(cuda)
    spec = Spectrum(key=key, count=count, n=n)
    for canonical in (True, False):
        got = tsp.sibling_maxes(spec, 24, canonical)
        want = tsp.sibling_maxes_plain(spec, 24, canonical)
        torch.cuda.synchronize()
        _equal(got[0], want[0], "right sibling maxima")
        _equal(got[1], want[1], "left sibling maxima")
        del want
    names = _device_launches(lambda: tsp.sibling_maxes(spec, 24, True))
    assert [x.split("(")[0] for x in names] == ["search_build_kernel", "sibling_maxes_kernel"]


@pytest.mark.parametrize("n", [16, 17, 16 * 4096, 16 * 4096 + 1])
@pytest.mark.parametrize("canonical", [True, False])
def test_sibling_maxes_kernel_at_index_edges(cuda, n, canonical):
    """K22 either side of the index's edges: no level (n <= 16), a top of
    level 1 that each block gathers from the table (one launch, up to
    65,536 real lanes), and two levels with the index built first (two
    launches); n random keys below 4^24 with the siblings of some, a PAD
    tail of 1,000 lanes, against the plain version."""
    rng = np.random.default_rng(n)
    real = rng.choice(1 << 46, n // 2, replace=False).astype(np.int64)
    real = np.concatenate([real, real[: n - n // 2] ^ 3])  # each with one sibling
    real = np.unique(real)
    while len(real) < n:
        real = np.unique(np.concatenate([real, rng.integers(0, 1 << 48, n - len(real))]))
    key = np.concatenate([real[:n], np.full(1000, PAD, np.int64)])
    count = np.where(key == PAD, 0, rng.integers(1, 500, key.shape[0])).astype(np.int32)
    spec = _to(Spectrum(key=torch.from_numpy(key), count=torch.from_numpy(count), n=n), cuda)
    got = tsp.sibling_maxes(spec, 24, canonical)
    want = tsp.sibling_maxes_plain(spec, 24, canonical)
    torch.cuda.synchronize()
    _equal(got[0], want[0], "right sibling maxima")
    _equal(got[1], want[1], "left sibling maxima")
    names = _device_launches(lambda: tsp.sibling_maxes(spec, 24, canonical))
    expect = ["search_build_kernel"] * (n > 16 * 4096) + ["sibling_maxes_kernel"]
    assert [x.split("(")[0] for x in names] == expect, names


def test_sibling_maxes_and_extract_codes_entries_refuse(cuda):
    """K22's entry point refuses a missing scratch where the index has two
    levels (at one it reads none) and an SM count below 1; K24's refuses an
    SM count below 1."""
    n = 16 * 4096 + 1
    key = torch.arange(n, dtype=torch.int64, device=cuda)
    count = torch.ones(n, dtype=torch.int32, device=cuda)
    out = torch.empty((2, n), dtype=torch.int32, device=cuda)
    lay = tsp.search_layout(n)
    assert len(lay.sizes) == 2
    scratch = torch.empty(lay.words, dtype=torch.int64, device=cuda)
    lib, p = kernels.library(), kernels.ptr
    for ptr, sms in ((None, 132), (p(scratch), 0)):
        with pytest.raises(RuntimeError, match="shannon_sibling_maxes"):
            lib.call("shannon_sibling_maxes", cuda, p(key), p(count), n, n, 24, 1, ptr,
                     lay.words, tsp.layout_words(lay), sms, p(out[0]), p(out[1]))
    codes = torch.zeros((4, 100), dtype=torch.uint8, device=cuda)
    lengths = torch.full((4,), 100, dtype=torch.int32, device=cuda)
    keys = torch.empty((4, 77), dtype=torch.int64, device=cuda)
    valid = torch.empty((4, 77), dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match="shannon_extract_codes"):
        lib.call("shannon_extract_codes", cuda, p(codes), p(lengths), 4, 100, 77, 24, 1, 0,
                 p(keys), p(valid))


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


@pytest.mark.parametrize("k", [5, 13, 16, 17, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_neighbor_counts_kernel_on_edge_tables(cuda, k, canonical):
    """K28 == its plain version (which searches the whole table) on
    k22_tables (n < C, n == C, n == 1, n == 0, n > C, palindromes at even
    k) into dirty memory: the kernel writes every lane of its ten rows, the
    zeros past the real lanes included; one launch a call (these tables'
    index has one level, which each block gathers from the table) and no
    host read."""
    lib = kernels.library()
    for name, spec in k22_tables(k, canonical).items():
        spec = _to(spec, cuda)
        want = tsp.neighbor_counts_plain(spec, k, canonical)
        _dirty(cuda, 16 * spec.capacity, 4 * spec.capacity)
        before = lib.launches["neighbor_counts"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tsp.neighbor_counts(spec, k, canonical)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert lib.launches["neighbor_counts"] == before + 1
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("right ext", "left ext", "right sib", "left sib")):
            _equal(g, w, f"{name}: {what}")
        names = _device_launches(lambda: tsp.neighbor_counts(spec, k, canonical))
        assert [x.split("(")[0] for x in names] == ["neighbor_counts_kernel"], (name, names)


def test_neighbor_counts_kernel_beyond_l2(cuda):
    """K28 on a table larger than the 50 MB L2 with a two-level index: 2^23
    lanes, up to 6,000,000 real random keys with a sibling and an extension
    of some (k = 24, both canonical modes), against its plain version; the
    index build, then the kernel."""
    rng = np.random.default_rng(28)
    C, n = 1 << 23, 6_000_000
    base = rng.choice(1 << 46, n // 3, replace=False)
    mask = (1 << 48) - 1
    real = np.unique(np.concatenate([base, base ^ 1, (base << 2 | 3) & mask]))[:n]
    key = torch.full((C,), PAD, dtype=torch.int64, device=cuda)
    key[:len(real)] = torch.from_numpy(real).to(cuda)
    count = torch.zeros(C, dtype=torch.int32, device=cuda)
    count[:len(real)] = torch.from_numpy(
        rng.integers(1, 1000, len(real)).astype(np.int32)).to(cuda)
    spec = Spectrum(key=key, count=count, n=len(real))
    for canonical in (True, False):
        got = tsp.neighbor_counts(spec, 24, canonical)
        want = tsp.neighbor_counts_plain(spec, 24, canonical)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("right ext", "left ext", "right sib", "left sib")):
            _equal(g, w, what)
        del got, want
    names = _device_launches(lambda: tsp.neighbor_counts(spec, 24, True))
    assert [x.split("(")[0] for x in names] == ["search_build_kernel", "neighbor_counts_kernel"]


def test_neighbor_counts_kernel_on_an_all_pad_table(cuda):
    spec = Spectrum(key=torch.full((1000,), PAD, dtype=torch.int64, device=cuda),
                    count=torch.zeros(1000, dtype=torch.int32, device=cuda), n=0)
    got = tsp.neighbor_counts(spec, 24)
    torch.cuda.synchronize()
    assert [tuple(x.shape) for x in got] == [(4, 1000), (4, 1000), (1000,), (1000,)]
    assert all((x == 0).all() for x in got)


def k23_float_grid(ratio: float, device="cpu"):
    """K23's float grid on `device`: every count 0..255 against every
    sibling maximum 0..4095 on the right (the left maximum half of it), and
    the same with the sides swapped, 7 PAD lanes after them; the keys are
    the lane numbers.  Returns (table, rmax, lmax, f32(ratio))."""
    c, m = np.meshgrid(np.arange(256), np.arange(4096), indexing="ij")
    c, m = np.tile(c.ravel(), 2), np.tile(m.ravel(), 2)
    half = c.size // 2
    rmax = np.concatenate([m[:half], m[half:] // 2]).astype(np.int32)
    lmax = np.concatenate([m[:half] // 2, m[half:]]).astype(np.int32)
    key = np.arange(c.size, dtype=np.int64)
    key[-7:] = PAD
    count = np.where(key == PAD, 0, c).astype(np.int32)
    spec = _to(Spectrum(key=torch.from_numpy(key), count=torch.from_numpy(count),
                        n=c.size - 7), device)
    ratio32, _ = tcor.prune_constants(ratio, 0.0)
    return (spec, torch.from_numpy(rmax).to(device), torch.from_numpy(lmax).to(device),
            ratio32)


@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.5])
def test_prune_keep_kernel_float_grid(cuda, ratio):
    """K23 bit-exact where an FMA would show: k23_float_grid through the
    fused entry point (prune_filter, the maxima given, of every lane and of
    the real lanes alone) against its plain version."""
    spec, r, l, ratio32 = k23_float_grid(ratio, cuda)
    want = tcor.prune_filter_plain(spec, r, l, ratio32)
    assert 0 < want.n < spec.n
    n = spec.n
    for maxes in ((r, l), (r[:n].clone(), l[:n].clone())):
        got = tcor.prune_filter(spec, *maxes, ratio32)
        torch.cuda.synchronize()
        assert got.n == want.n
        _equal(got.key, want.key, "kept keys")
        _equal(got.count, want.count, "kept counts")


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.5])
def test_sibling_prune_round_on_cuda_matches_cpu(cuda, k, canonical, ratio):
    """One round on the card equals the CPU run: K22 over the real lanes
    (its maxima sized to them: no zeros past them), then K23's one
    compaction after the memset of its scratch, and the tail fill; no K10,
    no C-wide keep array, one host read (the kept count)."""
    spec = _spectrum(k, canonical)
    lib = kernels.library()
    on_card = _to(spec, cuda)
    lib.reset_counts()
    got, reads = _one_host_read(lambda: tcor.sibling_prune_round(on_card, k, ratio, canonical))
    assert len(reads) == 1, reads
    for name, calls in (("sibling_maxes", 2), ("prune_keep", 2), ("compact_keep", 0)):
        assert lib.launches[name] == calls, lib.launches  # the warm-up's and ours
    want = tcor.sibling_prune_round(spec, k, ratio, canonical)
    assert got.n == want.n
    _equal(got.key.cpu(), want.key, "keys")
    _equal(got.count.cpu(), want.count, "counts")
    names = [x.split("(")[0] for x in _device_launches(
        lambda: tcor.sibling_prune_round(on_card, k, ratio, canonical)) if "Memcpy" not in x]
    # K22, the zeros of the scan's scratch, K23, the tail fill
    assert names[0] == "sibling_maxes_kernel" and "FillFunctor" in names[1], names
    assert names[2:] == ["prune_filter_kernel", "scan_fill_tail_kernel"], names
    n = min(on_card.n, on_card.capacity)
    assert n < on_card.capacity
    before = torch.cuda.memory_allocated()
    maxes = tsp._sibling_maxes_cuda(on_card, k, canonical, lanes=n)
    assert [m.shape[0] for m in maxes] == [n, n]
    assert torch.cuda.memory_allocated() - before <= 2 * (4 * n + 512)


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.5])
def test_sibling_prune_round_on_cuda_on_edge_tables(cuda, k, canonical, ratio):
    """The round on the card == its plain version on k22_tables (n < C,
    n == C, n == 1, n == 0, n > C, palindromes at even k): at n == 0 only
    the tail fill runs (no K22, no K23 launch)."""
    lib = kernels.library()
    for name, spec in k22_tables(k, canonical).items():
        before = dict(lib.launches)
        got = tcor.sibling_prune_round(_to(spec, cuda), k, ratio, canonical)
        real = int(min(spec.n, spec.capacity) > 0)
        for kernel in ("sibling_maxes", "prune_keep"):
            assert lib.launches[kernel] == before[kernel] + real, (name, kernel)
        want = tcor.sibling_prune_round(spec, k, ratio, canonical)
        assert got.n == want.n, name
        _equal(got.key.cpu(), want.key, f"{name}: keys")
        _equal(got.count.cpu(), want.count, f"{name}: counts")


def test_prune_filter_and_neighbor_counts_entries_refuse(cuda):
    """K23's entry point refuses a scratch other than scan_tiles(n_real) + 1
    words and n_real above C; K28's refuses a layout or a scratch that does
    not match the real lanes, a missing scratch where the index has two
    levels, and an SM count below 1."""
    n = 16 * 4096 + 1
    C = n + 5
    key = torch.full((C,), PAD, dtype=torch.int64, device=cuda)
    key[:n] = torch.arange(n, dtype=torch.int64, device=cuda)
    count = torch.ones(C, dtype=torch.int32, device=cuda)
    out_key, out_count = torch.empty_like(key), torch.empty_like(count)
    lib, p = kernels.library(), kernels.ptr
    tiles = -(-n // kernels.SCAN_TILE)
    for n_real, words in ((n, tiles), (n, tiles + 2),
                          (C + 1, -(-(C + 1) // kernels.SCAN_TILE) + 1)):
        scratch = torch.zeros(words, dtype=torch.int64, device=cuda)
        with pytest.raises(RuntimeError, match="shannon_prune_filter"):
            lib.call("shannon_prune_filter", cuda, p(key), p(count), p(count), p(count), n_real,
                     C, 0.1, p(scratch), words, p(out_key), p(out_count))
    lay = tsp.search_layout(n)
    assert len(lay.sizes) == 2
    scratch = torch.empty(lay.words + 16, dtype=torch.int64, device=cuda)
    rows = torch.empty((10, C), dtype=torch.int32, device=cuda)
    outs = (p(rows[0]), p(rows[4]), p(rows[8]), p(rows[9]))
    right = tsp.layout_words(lay)
    wrong = tsp.layout_words(tsp.search_layout(16 * 4096 + 17))
    for ptr, words, layout, sms in ((None, lay.words, right, 132),
                                    (p(scratch), lay.words, right, 0),
                                    (p(scratch), lay.words + 16, right, 132),
                                    (p(scratch), lay.words, wrong, 132)):
        with pytest.raises(RuntimeError, match="shannon_neighbor_counts"):
            lib.call("shannon_neighbor_counts", cuda, p(key), p(count), n, C, 24, 1, ptr, words,
                     layout, sms, *outs)


@pytest.mark.parametrize("k", [24, 31])
def test_entry_step_on_cuda_matches_cpu(cuda, k):
    """The flagship step at 512 reads, capacity 2^15, correction capacity
    2^14: the CUDA run launches K1, K2, K20 (its filter), K22 and K23 (the
    round's compaction), no K10, and equals the CPU run."""
    from shannon_tpu_torch import entry as tentry
    from shannon_tpu_torch.ops.count import upload_words

    batch = tentry.example_batch(512, tentry.READ_LEN)
    step = tentry.make_step(k, 1 << 15, 1 << 14, tentry.READ_LEN)
    lib = kernels.library()
    lib.reset_counts()
    key, count, n = step(upload_words(batch.words, cuda), torch.from_numpy(batch.lengths).to(cuda))
    for name in ("extract_kmers", "reduce_sorted", "abundance_cut", "sibling_maxes",
                 "prune_keep"):
        assert lib.launches[name] > 0, lib.launches
    assert lib.launches["compact_keep"] == 0, lib.launches
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
        tcor.prune_filter(spec, count[:4], count, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tcor.prune_filter(spec, count.cpu(), count, 0.1)


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


@pytest.mark.parametrize("L", [64, 100, 101, 128, 150])
@pytest.mark.parametrize("k", [1, 16, 24, 31])
def test_extract_codes_kernel_shapes(cuda, L, k):
    """K24 on codes_case (rows off 16-byte boundaries at L = 100 and 101, N
    codes either side of the word and mask-word edges, codes >= 4 past a
    read's length, reads shorter than k), both canonical modes, from the
    start of an allocation and from a view 5 bytes into one, into dirty
    memory: equal to the plain version; one launch, no copy or memset."""
    from shannon_tpu_torch.ops.kmers import extract_kmers, extract_kmers_plain

    codes, lengths = (torch.from_numpy(x) for x in codes_case(L, k))
    buf = torch.zeros(codes.numel() + 16, dtype=torch.uint8, device=cuda)
    buf[5:5 + codes.numel()] = codes.reshape(-1).to(cuda)
    lib = kernels.library()
    for dev_codes in (codes.to(cuda), buf[5:5 + codes.numel()].view(codes.shape)):
        for canonical in (True, False):
            want = extract_kmers_plain(codes, lengths, k, canonical)
            _dirty(cuda, 8 * want[0].numel(), want[1].numel())
            before = lib.launches["extract_codes"]
            got = extract_kmers(dev_codes, lengths.to(cuda), k, canonical)
            assert lib.launches["extract_codes"] == before + 1
            torch.cuda.synchronize()
            _equal(got[0].cpu(), want[0], "keys")
            _equal(got[1].cpu(), want[1], "valid")
    names = _device_launches(lambda: extract_kmers(dev_codes, lengths.to(cuda), k, True))
    assert [x.split("(")[0] for x in names if not x.startswith("Memcpy")] == [
        "extract_codes_kernel"], names


@pytest.mark.parametrize("L,k", [(36_000, 31), (131_056, 24), (140_000, 5), (200_001, 31)])
def test_extract_codes_kernel_long_rows(cuda, L, k):
    """Long rows: staged whole up to 131,056 codes (a block a row), and
    past that taken in pieces of CODES_PIECE windows (with a k - 1 base
    halo), N codes and short reads included, equal to the plain version,
    in one launch."""
    from shannon_tpu_torch.ops.kmers import extract_kmers, extract_kmers_plain

    codes, lengths = (torch.from_numpy(x) for x in codes_case(L, k, n=5))
    lengths[0] = L - 20_000  # a read that ends inside a middle piece
    lib = kernels.library()
    for canonical in (True, False):
        want = extract_kmers_plain(codes, lengths, k, canonical)
        before = lib.launches["extract_codes"]
        got = extract_kmers(codes.to(cuda), lengths.to(cuda), k, canonical)
        assert lib.launches["extract_codes"] == before + 1
        torch.cuda.synchronize()
        _equal(got[0].cpu(), want[0], "keys")
        _equal(got[1].cpu(), want[1], "valid")


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
    n_real = int((key != PAD).sum())
    widest = int(torch.bincount(td.owner_of(key[:n_real], n_dev)).max())
    bucket_cap = {"roomy": 2 * widest, "margin": widest, "over": widest - 1}[slack]
    want = td.owner_buckets_plain(key, count, n_dev, bucket_cap)
    lib = kernels.library()
    before = lib.launches["owner_buckets"]
    got = td.owner_buckets(key.to(cuda), count.to(cuda), n_dev, bucket_cap, n_real)
    assert lib.launches["owner_buckets"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert got[2].dtype == torch.bool and got[2].dim() == 0
    assert bool(got[2]) == bool(want[2]) == (slack == "over")


# Tables of K25's transcription tests (tests/test_torch_distributed.py) and
# cuda tests: real lanes ending on and beside a round of 64, a 16-byte pair,
# a warp's segment (256 lanes) and a tile (2,048 lanes), or filling all C =
# 4,500 lanes.
K25_N_REAL = [0, 1, 2, 63, 64, 65, 255, 256, 257, 1025, 2047, 2048, 2049, 4097, "C"]


def k25_table(n_real, C: int = 4500, seed: int = 0):
    """A sorted table of C lanes under the Spectrum contract, as numpy int64
    keys and int32 counts: n_real ("C": every lane) distinct random keys
    below 2^48 first, PAD with count 0 past them."""
    n = C if n_real == "C" else n_real
    rng = np.random.default_rng(seed + n)
    key = np.full(C, PAD, np.int64)
    key[:n] = np.sort(rng.choice(1 << 48, size=n, replace=False))
    count = np.where(key == PAD, 0, rng.integers(1, 1 << 20, size=C)).astype(np.int32)
    return key, count


@pytest.mark.parametrize("n_dev", [1, 2, 8, 33, 1024])
@pytest.mark.parametrize("n_real", K25_N_REAL + ["overflow"])
def test_owner_buckets_kernel_on_real_lane_tables(cuda, n_dev, n_real):
    """K25 == owner_buckets_plain on the transcription tests' tables and on
    a local table whose keys outgrew its capacity (n > C), at bucket_cap
    the widest owner's count and one below it (the flag up)."""
    from shannon_tpu_torch.ops.count import count_window_keys
    from shannon_tpu_torch.parallel import distributed as td

    if n_real == "overflow":
        keys = np.sort(np.random.default_rng(n_dev).integers(0, 1 << 40, size=6000))
        local = count_window_keys(torch.from_numpy(keys), 3000)
        assert local.n > local.capacity
        key, count, n = local.key, local.count, local.capacity
    else:
        key, count = (torch.from_numpy(a) for a in k25_table(n_real))
        n = key.shape[0] if n_real == "C" else n_real
    widest = int(torch.bincount(td.owner_of(key[:n], n_dev)).max()) if n else 0
    for cap in [max(widest, 1)] + ([widest - 1] if widest >= 2 else []):
        want = td.owner_buckets_plain(key, count, n_dev, cap)
        got = td.owner_buckets(key.to(cuda), count.to(cuda), n_dev, cap, n)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert bool(got[2]) == bool(want[2]) == (cap < widest)


def test_owner_buckets_kernel_on_unaligned_views(cuda):
    """A view one lane into the table (keys and counts not 16- and 8-byte
    aligned: every load lane by lane) gives the plain version's buckets."""
    from shannon_tpu_torch.parallel import distributed as td

    key, count = (torch.from_numpy(a) for a in k25_table(3001))
    d_key, d_count = key.to(cuda)[1:], count.to(cuda)[1:]
    assert d_key.data_ptr() % 16 != 0 and d_count.data_ptr() % 8 != 0
    for n_dev in (1, 8, 1024):
        want = td.owner_buckets_plain(key[1:], count[1:], n_dev, 700)
        got = td.owner_buckets(d_key, d_count, n_dev, 700, 3000)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("table", ["empty", "all_pad"])
def test_owner_buckets_kernel_edge_tables(cuda, table):
    """No lane, or only PAD lanes: all-PAD buckets and no flag, with n_real
    0 and (all_pad) with n_real C, where the PAD lanes take owner D."""
    from shannon_tpu_torch.parallel import distributed as td

    key = torch.full((0 if table == "empty" else 1000,), PAD, dtype=torch.int64)
    count = torch.zeros(key.shape[0], dtype=torch.int32)
    want = td.owner_buckets_plain(key, count, 8, 16)
    for n_real in {0, key.shape[0]}:
        got = td.owner_buckets(key.to(cuda), count.to(cuda), 8, 16, n_real)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert not bool(got[2]) and not bool(want[2])


def test_sharded_wrappers_validate_inputs(cuda):
    from shannon_tpu_torch.ops.kmers import extract_kmers
    from shannon_tpu_torch.parallel import distributed as td

    key = torch.zeros(8, dtype=torch.int64, device=cuda)
    count = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1..1024"):
        td.owner_buckets(key, count, 1025, 4, 8)
    with pytest.raises(ValueError, match="bucket_cap"):
        td.owner_buckets(key, count, 8, 0, 8)
    with pytest.raises(TypeError, match="int32"):
        td.owner_buckets(key, key, 8, 4, 8)
    with pytest.raises(ValueError, match="n_real"):
        td.owner_buckets(key, count, 8, 4, 9)
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


def _device_launches(fn, tries: int = 5) -> list:
    """The names of the kernels, copies and memsets on the card of one call
    of fn, in launch order, from a torch.profiler trace after a warm-up.
    The call runs between two `torch.cuda._sleep` kernels, and only a trace
    that holds both (so its collection was running before the call began)
    and something between them is read: a trace can miss the launches made
    just after it starts (after many traces in one process, an H100's
    traces dropped their first two or three), or all of a call's (every
    caller's fn launches at least once, so a call that launches nothing
    still fails, after the tries).  So eight sleeps open each trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        marks = [i for i, x in enumerate(names) if "spin_kernel" in x]
        if len(marks) >= 2 and marks[-1] > marks[-2] + 1:
            return names[marks[-2] + 1 : marks[-1]]
    raise AssertionError(f"no trace held the call between its two markers: {names}")


def _dirty(cuda, *sizes) -> None:
    """Fill and free, with -1, a large buffer and one buffer of each byte
    size given, so the caching allocator hands dirty memory to the next
    allocations of those sizes."""
    for n in (256 << 20, *sizes):
        buf = torch.full((max(n, 8) // 4,), -1, dtype=torch.int32, device=cuda)
        del buf


@pytest.mark.parametrize("n_ranks", [1, 2, 3, 4, 8, 512])
@pytest.mark.parametrize("case", ["random", "empty", "skew", "edge-1", "edge", "edge+1",
                                  "long", "wide", "stray"])
def test_ownership_kernels_on_transcription_cases(cuda, n_ranks, case, monkeypatch):
    """K26 and K27 == their plain versions on the cases of
    test_torch_ownership_transcription (a tile's edges, one path longer than
    a tile, a cap above every bucket, every path to one rank, owners outside
    [0, H)), on dirty memory; one launch count, one host read, no
    torch.cumsum and K26's three launches (two with no path) and K27's one
    with the scan's scratch fill, a call."""
    from shannon_tpu_torch.parallel import multihost as tmh
    from test_torch_ownership_transcription import ownership_case

    flat, offs, weights, owner, agree = ownership_case(case, n_ranks, "source")
    args = [torch.from_numpy(np.asarray(a, np.int64).astype(np.int32))
            for a in (flat, offs, weights, owner)]
    want = tmh.ownership_pack_plain(*args, n_ranks, agree)
    dev_args = [a.to(cuda) for a in args]

    def pack():
        return _no_cumsum(monkeypatch, lambda: tmh.ownership_pack(*dev_args, n_ranks, agree))

    lib = kernels.library()
    before = lib.launches["ownership_pack"]
    _, reads = _one_host_read(pack)
    assert len(reads) == 1, reads
    assert lib.launches["ownership_pack"] == before + 2  # the warm-up's and ours
    names = _device_launches(pack)
    ran = [x for x in names if not x.startswith("Memcpy")]
    assert len(ran) == (3 if len(offs) > 1 else 2) and all("pack_" in x for x in ran), names
    _dirty(cuda, 4 * want[0].numel())
    got = pack()
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])

    recv = got[0]
    plain = tmh.ownership_unpack_plain(want[0])

    def unpack():
        return _no_cumsum(monkeypatch, lambda: tmh.ownership_unpack(recv))

    before = lib.launches["ownership_unpack"]
    _, reads = _one_host_read(unpack)
    assert len(reads) == 1, reads
    assert lib.launches["ownership_unpack"] == before + 2
    names = [x for x in _device_launches(unpack) if not x.startswith("Memcpy")]
    assert len(names) == 2 and sum("ownership_unpack_kernel" in x for x in names) == 1, names
    _dirty(cuda, *(8 * x.numel() for x in plain))
    got = unpack()
    torch.cuda.synchronize()
    for g, w in zip(got, plain):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n_ranks, cap", [(1, 2), (2, 9), (512, 2), (512, 7)])
def test_ownership_unpack_kernel_on_empty_rows(cuda, n_ranks, cap):
    """A received buffer whose rows are all empty: offs == [0], no flat id,
    no weight."""
    from shannon_tpu_torch.parallel import multihost as tmh

    recv = torch.zeros((n_ranks, cap), dtype=torch.int32)
    _dirty(cuda, 8)
    got = tmh.ownership_unpack(recv.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, tmh.ownership_unpack_plain(recv)):
        assert torch.equal(g.cpu(), w)
    assert got[1].tolist() == [0]


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
    with pytest.raises(ValueError, match="below the widest bucket"):
        tmh.ownership_pack(flat, offs, weights, owner, 2, agree=lambda c: c - 1)
    with pytest.raises(ValueError, match="header"):
        tmh.ownership_unpack(torch.zeros((2, 1), dtype=torch.int32, device=cuda))
    # a launch the kernel refuses raises, with the entry point's CUDA status
    scratch = torch.zeros(2 * 513 + 2 * 513, dtype=torch.int32, device=cuda)
    sizes = torch.zeros(513, dtype=torch.int64, device=cuda)
    lib = kernels.library()
    with pytest.raises(RuntimeError, match="shannon_ownership_counts failed"):
        lib.call("shannon_ownership_counts", cuda, kernels.ptr(flat), kernels.ptr(offs), 4,
                 kernels.ptr(owner), 513, kernels.ptr(scratch), scratch.shape[0],
                 kernels.ptr(sizes))
