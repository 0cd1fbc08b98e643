"""Port parity: sharded counting (shannon_tpu_torch.parallel) against
shannon_tpu.parallel on the conftest's 8 virtual JAX-CPU devices, the port
on make_mesh(D, "cpu") (D shards, one process).  Every case of
tests/test_distributed.py, plus a bucket_cap at the margin where one lane
decides the overflow flag, a local table that overflows, meshes of 2 and 3
shards, the packed and batch drivers, the owner hash and K25's plain
version, and the sharded route through assemble, run_pipeline and the CLI.

Tolerance: exact — tables (keys, counts) over the whole capacity, the
overflow flag, the same transcripts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.fastx import write_fasta
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.parallel import distributed as jd
from shannon_tpu.parallel import make_mesh as ref_make_mesh
from shannon_tpu.pipeline import assemble as ref_assemble
from shannon_tpu.pipeline import run_pipeline as ref_run_pipeline
from shannon_tpu.sim import random_seq, sample_reads, simulate_isoforms, simulate_transcripts
from shannon_tpu_torch import convert
from shannon_tpu_torch import pipeline as tpipe
from shannon_tpu_torch.cli import main as port_cli
from shannon_tpu_torch.ops.count import count_spectrum
from shannon_tpu_torch.ops.kmers import PAD, extract_kmers
from shannon_tpu_torch.parallel import distributed as td
from shannon_tpu_torch.parallel.mesh import make_mesh

from test_torch_kernels import owner_table


def _random_batch(rng, n_reads, L=72):
    reads = [random_seq(rng, L) for _ in range(n_reads)]
    return reads, pack_reads(reads, pad_length=L)


def _assert_same(port, ref) -> None:
    """The whole table equal; n equal up to the reference's cut at the
    capacity (the port's n counts every gathered key)."""
    hi, lo, count, n = convert.spectrum_to_numpy(port)
    np.testing.assert_array_equal(hi, np.asarray(ref.hi))
    np.testing.assert_array_equal(lo, np.asarray(ref.lo))
    np.testing.assert_array_equal(count, np.asarray(ref.count))
    assert min(n, port.capacity) == int(ref.n)


def _both(codes, lengths, k, cap, n_dev=8, **kw):
    """(port spectrum, flag) after asserting both equal the reference's."""
    ref, ref_flag = jd.count_spectrum_sharded(
        jnp.asarray(codes), jnp.asarray(lengths), k, cap, ref_make_mesh(n_dev), **kw
    )
    port, flag = td.count_spectrum_sharded(
        torch.from_numpy(codes), torch.from_numpy(lengths), k, cap, make_mesh(n_dev, "cpu"), **kw
    )
    assert flag == bool(ref_flag)
    _assert_same(port, ref)
    assert port.to_dict() == ref.to_dict()
    return port, flag


def _single(b, k, cap, canonical=True):
    return count_spectrum(torch.from_numpy(b.codes), torch.from_numpy(b.lengths), k, cap, canonical)


@pytest.mark.parametrize("k", [15, 24])
def test_sharded_matches_reference(rng, k):
    _, b = _random_batch(rng, 64)
    port, flag = _both(b.codes, b.lengths, k, 1 << 12)
    assert not flag
    assert port.to_dict() == _single(b, k, 1 << 12).to_dict()


def test_sharded_with_duplicates_across_shards(rng):
    t = simulate_transcripts(rng, n=1, length=300)[0]
    reads = sample_reads(rng, [t], coverage=20, read_length=72)
    b = pack_reads(reads[: (len(reads) // 8) * 8], pad_length=72)
    port, flag = _both(b.codes, b.lengths, 21, 1 << 12)
    assert not flag
    assert port.to_dict() == _single(b, 21, 1 << 12).to_dict()
    assert max(port.to_dict().values()) > 1


def test_sharded_overflow_flag(rng):
    _, b = _random_batch(rng, 64)
    _, flag = _both(b.codes, b.lengths, 15, 1 << 12, bucket_cap=8)
    assert flag


def test_sharded_midscale_skewed_matches_reference(rng):
    """8,192+ reads of a skewed transcriptome: the default 2x bucket slack
    holds, and 2^10-lane buckets trip the flag."""
    ts = simulate_transcripts(rng, n=40, length=600)
    abund = np.exp(rng.normal(0.0, 1.0, 40))
    reads = sample_reads(rng, ts, abundances=(abund / abund.mean()).tolist(), coverage=34,
                         read_length=100, error_rate=0.01)
    b = pack_reads(reads[: (len(reads) // 8) * 8], pad_length=128)
    assert b.n_reads >= 8000
    port, flag = _both(b.codes, b.lengths, 24, 1 << 17)
    assert not flag
    assert port.to_dict() == _single(b, 24, 1 << 17).to_dict()
    _, flag = _both(b.codes, b.lengths, 24, 1 << 17, bucket_cap=1 << 10)
    assert flag


def test_sharded_strand_specific(rng):
    _, b = _random_batch(rng, 32)
    port, flag = _both(b.codes, b.lengths, 17, 1 << 12, canonical=False)
    assert not flag
    assert port.to_dict() == _single(b, 17, 1 << 12, canonical=False).to_dict()


def _owner_widths(b, k: int, n_dev: int = 8) -> list[int]:
    keys = torch.tensor(sorted(_single(b, k, 1 << 12).to_dict()))
    return torch.bincount(td.owner_of(keys, n_dev), minlength=n_dev).tolist()


def test_bucket_cap_at_the_margin():
    """At bucket_cap = the widest owner's key count nothing overflows; one
    lane fewer and the flag is up, in both packages (this batch's widest
    owner is shard 0, the one whose flag the reference returns)."""
    _, b = _random_batch(np.random.default_rng(2), 64)
    widths = _owner_widths(b, 19)
    assert widths[0] > max(widths[1:])
    assert not _both(b.codes, b.lengths, 19, 1 << 12, bucket_cap=widths[0])[1]
    assert _both(b.codes, b.lengths, 19, 1 << 12, bucket_cap=widths[0] - 1)[1]


def test_overflow_on_any_shard_is_flagged(rng):
    """Deliberate departure: the reference returns shard 0's flag alone (its
    shard_map declares the per-shard flag replicated), so a slice that
    outgrows bucket_cap on another shard drops a k-mer silently.  The port
    ORs every shard's flag; the tables stay equal."""
    _, b = _random_batch(rng, 64)
    widths = _owner_widths(b, 19)
    widest = max(widths)
    assert widths[0] < widest - 1
    args = (b.codes, b.lengths, 19, 1 << 12)
    ref, ref_flag = jd.count_spectrum_sharded(
        *map(jnp.asarray, args[:2]), *args[2:], ref_make_mesh(8), bucket_cap=widest - 1
    )
    port, flag = td.count_spectrum_sharded(
        *map(torch.from_numpy, args[:2]), *args[2:], make_mesh(8, "cpu"), bucket_cap=widest - 1
    )
    assert flag and not bool(ref_flag)
    _assert_same(port, ref)
    assert len(port.to_dict()) == sum(widths) - 1


def test_local_table_past_capacity_is_cut_as_the_reference_cuts_it(rng):
    """Each shard's local table holds more keys than capacity: it keeps its
    first `capacity` keys silently, and the gathered table is flagged."""
    _, b = _random_batch(rng, 64)
    local = td.count_window_keys(
        extract_kmers(torch.from_numpy(b.codes[:8]), torch.from_numpy(b.lengths[:8]), 15)[0], 256
    )
    assert local.n > 256
    _, flag = _both(b.codes, b.lengths, 15, 256)
    assert flag


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_mesh_sizes_match_reference(rng, n_dev):
    _, b = _random_batch(rng, 48)
    port, flag = _both(b.codes, b.lengths, 21, 1 << 12, n_dev=n_dev)
    assert not flag
    assert port.to_dict() == _single(b, 21, 1 << 12).to_dict()


def test_rows_that_do_not_split_raise(rng):
    _, b = _random_batch(rng, 50)
    with pytest.raises(ValueError, match=r"\(50, 72\) does not split into 8"):
        td.count_spectrum_sharded(torch.from_numpy(b.codes), torch.from_numpy(b.lengths), 21,
                                  1 << 12, make_mesh(8, "cpu"))


@pytest.mark.parametrize("with_n", [False, True])
def test_sharded_packed_matches_reference(rng, with_n):
    reads = [random_seq(rng, int(rng.integers(20, 100))) for _ in range(64)]
    if with_n:
        reads = [r[:10] + "N" + r[11:] if i % 3 == 0 else r for i, r in enumerate(reads)]
    b = pack_reads(reads, pad_length=128)
    assert (b.mask is not None) == with_n
    mask = None if b.mask is None else jnp.asarray(b.mask)
    ref, ref_flag = jd.count_spectrum_sharded_packed(
        jnp.asarray(b.words), jnp.asarray(b.lengths), 24, 1 << 12, ref_make_mesh(8), length=128,
        mask=mask,
    )
    port, flag = td.count_spectrum_sharded_packed(
        torch.from_numpy(b.words.view(np.int32)), torch.from_numpy(b.lengths), 24, 1 << 12,
        make_mesh(8, "cpu"), length=128,
        mask=None if b.mask is None else torch.from_numpy(b.mask.view(np.int32)),
    )
    assert flag == bool(ref_flag) is False
    _assert_same(port, ref)
    assert port.to_dict() == _single(b, 24, 1 << 12).to_dict()


def _reads_batch(seed: int):
    rng = np.random.default_rng(seed)
    ts = simulate_transcripts(rng, n=6, length=300)
    reads = sample_reads(rng, ts, coverage=30, read_length=60, error_rate=0.01)[:1200]
    return pack_reads(reads, pad_length=64)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_count_reads_spectrum_sharded_matches_reference(n_dev):
    """Four batches, the last one short (padded to 256 rows), merged batch
    to batch; the small capacity takes the grown merge."""
    b = _reads_batch(n_dev)
    ref, ref_flag = jd.count_reads_spectrum_sharded(
        b, k=21, capacity=1 << 12, mesh=ref_make_mesh(n_dev), batch_reads=384
    )
    port, flag = td.count_reads_spectrum_sharded(
        b, k=21, capacity=1 << 12, mesh=make_mesh(n_dev, "cpu"), batch_reads=384
    )
    assert flag == bool(ref_flag) is False
    assert port.capacity == ref.capacity > 1 << 12
    _assert_same(port, ref)


def test_padded_batch_that_does_not_split_is_refused_by_both():
    """384-row batches split into 3 shards, the last batch's 256 padded
    rows do not: the reference's shard_map refuses, the port raises."""
    b = _reads_batch(3)
    with pytest.raises(ValueError, match="divisible"):
        jd.count_reads_spectrum_sharded(b, k=21, capacity=1 << 12, mesh=ref_make_mesh(3),
                                        batch_reads=384)
    with pytest.raises(ValueError, match=r"\(256, 4\) does not split into 3"):
        td.count_reads_spectrum_sharded(b, k=21, capacity=1 << 12, mesh=make_mesh(3, "cpu"),
                                        batch_reads=384)


def test_owner_of_matches_reference():
    """Every 64-bit pattern, the top bits of hi and lo set included."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 64, size=20_000, dtype=np.uint64)
    keys[:4] = [0, (1 << 64) - 1, 0xFFFFFFFF, 0xFFFFFFFF00000000]
    keys[4:1000] |= np.uint64(0x8000000080000000)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    port_keys = torch.from_numpy(keys.view(np.int64))
    for n_dev in (1, 2, 3, 8, 64, 1000):
        want = np.asarray(jd._hash_dev(jnp.asarray(hi), jnp.asarray(lo), n_dev))
        np.testing.assert_array_equal(td.owner_of(port_keys, n_dev).numpy(), want)


def buckets_numpy(key: np.ndarray, count: np.ndarray, n_dev: int, bucket_cap: int):
    """parallel/distributed.py:133-160 in numpy: the uint32 hash, a sort by
    (owner, key) with PAD as owner D, each lane's place in its bucket, and
    the scatter (places at or past bucket_cap go to a discarded lane)."""
    hi = (key >> 32).astype(np.uint32)
    lo = (key & 0xFFFFFFFF).astype(np.uint32)
    h = lo * np.uint32(2654435761) + hi * np.uint32(0x9E3779B9)
    h ^= h >> np.uint32(16)
    dev = np.where(key == PAD, n_dev, (h % np.uint32(n_dev)).astype(np.int64))
    order = np.lexsort((key, dev))
    dev, key, count = dev[order], key[order], count[order]
    first = np.searchsorted(dev, np.arange(n_dev + 1))
    within = np.arange(len(key)) - first[np.clip(dev, 0, n_dev)]
    overflow = bool(np.any((within >= bucket_cap) & (dev < n_dev)))
    tgt = np.where((dev < n_dev) & (within < bucket_cap), dev * bucket_cap + within,
                   n_dev * bucket_cap)
    out_key = np.full(n_dev * bucket_cap + 1, PAD, np.int64)
    out_count = np.zeros(n_dev * bucket_cap + 1, np.int32)
    out_key[tgt] = key
    out_count[tgt] = np.where(dev < n_dev, count, 0)
    shape = (n_dev, bucket_cap)
    return out_key[:-1].reshape(shape), out_count[:-1].reshape(shape), overflow


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("slack", ["roomy", "margin", "over"])
def test_owner_buckets_plain_matches_numpy(n_dev, slack):
    key, count = owner_table(n_dev)
    widest = int(np.bincount(td.owner_of(torch.from_numpy(key[key != PAD]), n_dev).numpy()).max())
    bucket_cap = {"roomy": 2 * widest, "margin": widest, "over": widest - 1}[slack]
    got = td.owner_buckets(torch.from_numpy(key), torch.from_numpy(count), n_dev, bucket_cap)
    want = buckets_numpy(key, count, n_dev, bucket_cap)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert bool(got[2]) == want[2] == (slack == "over")


def test_make_mesh_places_shards_round_robin(monkeypatch):
    """The CPU mesh repeats the CPU; a CUDA mesh puts shard i on card
    (base + i) mod count, so 8 shards share one card (the reference caps
    n at its visible devices), and n_devices = 0 means every card."""
    assert make_mesh(8, "cpu") == (torch.device("cpu"),) * 8
    assert make_mesh(0, "cpu") == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh(8) == (torch.device("cuda", 0),) * 8
    assert make_mesh(0) == (torch.device("cuda", 0),)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert [d.index for d in make_mesh(5, "cuda:1")] == [1, 2, 0, 1, 2]
    assert [d.index for d in make_mesh(0)] == [0, 1, 2]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(ValueError, match=">= 0"):
        make_mesh(-1, "cpu")


def _isoform_reads():
    rng = np.random.default_rng(12345)
    ts = simulate_transcripts(rng, n=2, length=350) + simulate_isoforms(rng, exon_length=150)
    reads = sample_reads(rng, ts, abundances=[1, 3, 4, 1], coverage=30, read_length=70,
                         error_rate=0.005)
    return ts, reads


def _spy_sharded(monkeypatch) -> list:
    """Record each call of the pipeline's sharded counter."""
    calls = []
    real = tpipe.count_reads_spectrum_sharded

    def spy(*args, **kwargs):
        calls.append(len(kwargs["mesh"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(tpipe, "count_reads_spectrum_sharded", spy)
    return calls


def test_assemble_on_8_shards_matches_reference(monkeypatch):
    _, reads = _isoform_reads()
    calls = _spy_sharded(monkeypatch)
    cfg = AssemblyConfig(k=21, kmer_capacity=1 << 15, n_devices=8)
    port = tpipe.assemble(reads, cfg, device="cpu")
    assert calls == [8]
    ref = ref_assemble(reads, cfg, backend="device")
    assert [t.seq for t in port.transcripts] == [t.seq for t in ref.transcripts]
    assert [t.abundance for t in port.transcripts] == [t.abundance for t in ref.transcripts]
    one = tpipe.assemble(reads, AssemblyConfig(k=21, kmer_capacity=1 << 15, n_devices=1),
                         device="cpu")
    assert calls == [8]
    assert [t.seq for t in one.transcripts] == [t.seq for t in port.transcripts]


def test_run_pipeline_and_cli_on_8_shards_match_reference(tmp_path, monkeypatch):
    _, reads = _isoform_reads()
    fasta = tmp_path / "reads.fasta"
    write_fasta(fasta, [(f"r{i}", s) for i, s in enumerate(reads)])
    calls = _spy_sharded(monkeypatch)
    ref_out, run_out, cli_out = tmp_path / "ref", tmp_path / "run", tmp_path / "cli"

    def cfg(out):
        return AssemblyConfig(k=21, kmer_capacity=1 << 15, n_devices=8, out_dir=str(out))

    ref_run_pipeline(cfg(ref_out), single=str(fasta), backend="device")
    tpipe.run_pipeline(cfg(run_out), single=str(fasta), device="cpu")
    assert port_cli(["-o", str(cli_out), "--single", str(fasta), "-K", "21", "-p", "8",
                     "--kmer-capacity", str(1 << 15), "--device", "cpu"]) == 0
    assert calls == [8, 8]
    want = (ref_out / "transcripts.fasta").read_bytes()
    assert (run_out / "transcripts.fasta").read_bytes() == want
    assert (cli_out / "transcripts.fasta").read_bytes() == want
    for name in ("spectrum_corrected.npz", "spectrum.npz"):
        ref_arrays, port_arrays = np.load(ref_out / name), np.load(cli_out / name)
        for field in ref_arrays.files:
            np.testing.assert_array_equal(port_arrays[field], ref_arrays[field])
