"""The hand-written CUDA kernels K1-K6 against their plain PyTorch
versions, and the port's assembly (single-end and paired) on CUDA against
the CPU run.  Marked
`cuda`: these need an NVIDIA GPU and nvcc and skip without them.  Run on
the card with

    python -m pytest tests/test_torch_kernels.py -m cuda

Tolerance: exact — integer outputs equal elementwise, the same
transcripts."""

import numpy as np
import pytest
import torch

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.sim import sample_paired_reads, sample_reads, simulate_gene_isoforms
from shannon_tpu_torch import kernels
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


def test_paired_assemble_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(6)
    ts, _ = simulate_gene_isoforms(rng, n_genes=3)
    reads = sample_paired_reads(rng, ts, coverage=20, read_length=80, insert_size=250,
                                error_rate=0.01)
    cfg = AssemblyConfig(k=24, kmer_capacity=1 << 16, batch_reads=2048)
    lib = kernels.library()
    lib.reset_counts()
    gpu = assemble(reads, cfg, device=cuda, paired=True)
    assert all(v > 0 for v in lib.launches.values()), lib.launches
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
    gpu = assemble(reads, cfg, device=cuda)
    assert all(v > 0 for v in lib.launches.values()), lib.launches
    cpu = assemble(reads, cfg, device="cpu")
    assert [t.seq for t in gpu.transcripts] == [t.seq for t in cpu.transcripts]
    assert [t.abundance for t in gpu.transcripts] == [t.abundance for t in cpu.transcripts]
    assert gpu.stats == {**cpu.stats, "backend": "torch:cuda"}
