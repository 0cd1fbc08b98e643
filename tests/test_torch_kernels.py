"""The hand-written CUDA kernels K1-K10 against their plain PyTorch
versions, correction and the port's assembly (single-end and paired) on
CUDA against the CPU run.  Marked
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
from shannon_tpu_torch.io.pack import pack_reads
from shannon_tpu_torch.ops import correction as tcor
from shannon_tpu_torch.ops.count import Spectrum, count_reads_spectrum
from shannon_tpu_torch.sim import sample_paired_reads, sample_reads, simulate_gene_isoforms
from shannon_tpu_torch.utils.timing import StageTimer
from shannon_tpu_torch.ops import sparseflow as tsf
from shannon_tpu_torch.ops import thread as tth
from shannon_tpu_torch.ops.count import reduce_sorted, reduce_sorted_plain
from shannon_tpu_torch.ops.kmers import PAD, extract_kmers_packed, extract_kmers_packed_plain
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


@pytest.mark.parametrize("k", [5, 16, 24, 31])
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


def test_sf_greedy_kernel_validates_inputs(cuda):
    with pytest.raises(TypeError, match="int32"):
        tsf.batched_greedy_packed(torch.zeros((4, 17), dtype=torch.int64, device=cuda), 4)
    with pytest.raises(ValueError, match=r"\[B, 17\]"):
        tsf.batched_greedy_packed(torch.zeros((4, 16), dtype=torch.int32, device=cuda), 4)


def _assert_all_launched(launches: dict, timer: StageTimer) -> None:
    """Every kernel launched; K8 (rescue) only runs when the auto cut is
    above 1."""
    cut = timer.stages["spectrum+graph"]["auto_min_abundance"]
    missing = [n for n, c in launches.items() if c == 0 and not (n == "rescue_round" and cut == 1)]
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
    """K8 and K9, every round of the loops correct_spectrum runs, from the
    cut counts; and K10 on the final keep mask."""
    spec = _to(_spectrum(k), cuda)
    sib = tcor.probe_resolve_plain(spec, k, True, "sib")
    ext = tcor.probe_resolve_plain(spec, k, True, "ext")
    raw, counts = tcor.cut_counts(spec, cut)
    for _ in range(k + 2):
        got = tcor.rescue_round(counts, raw, *sib, *ext)
        want = tcor.rescue_round_plain(counts, raw, *sib, *ext)
        assert torch.equal(got[0], want[0]) and got[1] == want[1]
        if not want[1]:
            break
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


def test_correction_wrappers_validate_inputs(cuda):
    counts = torch.zeros(4, dtype=torch.int32, device=cuda)
    idx = torch.zeros((8, 4), dtype=torch.int64, device=cuda)
    hit = torch.zeros((8, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match=r"\[8, 4\]"):
        tcor.prune_round(counts, idx[:, :3].contiguous(), hit[:, :3].contiguous(), 0.1, 0.0, False)
    with pytest.raises(TypeError, match="int32"):
        tcor.rescue_round(counts.long(), counts, idx, hit, idx, hit)
    with pytest.raises(ValueError, match="side"):
        tcor.probe_resolve(Spectrum(key=idx[0], count=counts, n=0), 21, True, "up")


def test_paired_assemble_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(6)
    ts, _ = simulate_gene_isoforms(rng, n_genes=3)
    reads = sample_paired_reads(rng, ts, coverage=20, read_length=80, insert_size=250,
                                error_rate=0.01)
    cfg = AssemblyConfig(k=24, kmer_capacity=1 << 16, batch_reads=2048)
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
    cfg = AssemblyConfig(k=24, kmer_capacity=1 << 16, batch_reads=2048)
    lib = kernels.library()
    lib.reset_counts()
    timer = StageTimer(echo=False)
    gpu = assemble(reads, cfg, device=cuda, timer=timer)
    _assert_all_launched(lib.launches, timer)
    cpu = assemble(reads, cfg, device="cpu")
    assert [t.seq for t in gpu.transcripts] == [t.seq for t in cpu.transcripts]
    assert [t.abundance for t in gpu.transcripts] == [t.abundance for t in cpu.transcripts]
    assert gpu.stats == {**cpu.stats, "backend": "torch:cuda"}
