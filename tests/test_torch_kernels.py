"""The hand-written CUDA kernels K1-K3 against their plain PyTorch
versions, and the port's assembly on CUDA against the CPU run.  Marked
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
from shannon_tpu.sim import sample_reads, simulate_gene_isoforms
from shannon_tpu_torch import kernels
from shannon_tpu_torch.ops.count import reduce_sorted, reduce_sorted_plain
from shannon_tpu_torch.ops.kmers import PAD, extract_kmers_packed, extract_kmers_packed_plain
from shannon_tpu_torch.ops.spectrum import lookup_sorted, lookup_sorted_plain
from shannon_tpu_torch.pipeline import assemble

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
