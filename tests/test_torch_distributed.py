"""Port parity: sharded counting (shannon_tpu_torch.parallel) against
shannon_tpu.parallel on the conftest's 8 virtual JAX-CPU devices, the port
on make_mesh(D, "cpu") (D shards, one process).  Every case of
tests/test_distributed.py, plus a bucket_cap at the margin where one lane
decides the overflow flag, a local table that overflows, meshes of 2 and 3
shards, the packed and batch counts, the owner hash, K25's plain version
and a numpy transcription of K25's kernels (held to the plain version and
to the reference's bucketing in JAX), and the sharded route through
assemble, run_pipeline and the CLI.

Tolerance: exact — tables (keys, counts) over the whole capacity, the
overflow flag, the same transcripts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.config import AssemblyConfig
from shannon_tpu.io.fastx import write_fasta
from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.kmers import SENTINEL
from shannon_tpu.parallel import distributed as jd
from shannon_tpu.parallel import make_mesh as ref_make_mesh
from shannon_tpu.pipeline import assemble as ref_assemble
from shannon_tpu.pipeline import run_pipeline as ref_run_pipeline
from shannon_tpu.sim import random_seq, sample_reads, simulate_isoforms, simulate_transcripts
from shannon_tpu_torch import convert
from shannon_tpu_torch import pipeline as tpipe
from shannon_tpu_torch.cli import main as port_cli
from shannon_tpu_torch.ops.count import count_spectrum, count_window_keys
from shannon_tpu_torch.ops.kmers import PAD, extract_kmers
from shannon_tpu_torch.parallel import distributed as td
from shannon_tpu_torch.parallel.mesh import make_mesh

from test_torch_kernels import K25_N_REAL, k25_table, owner_table


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
    got = td.owner_buckets(torch.from_numpy(key), torch.from_numpy(count), n_dev, bucket_cap,
                           int((key != PAD).sum()))
    want = buckets_numpy(key, count, n_dev, bucket_cap)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert bool(got[2]) == want[2] == (slack == "over")


def buckets_jax(key: np.ndarray, count: np.ndarray, n_dev: int, bucket_cap: int):
    """The reference's bucketing, parallel/distributed.py:133-160 with its
    own _hash_dev, in JAX on the (hi, lo) halves of the keys."""
    import jax

    h, l = convert.key_to_hilo(key)
    hi, lo, cnt = jnp.asarray(h), jnp.asarray(l), jnp.asarray(count)
    dev = jd._hash_dev(hi, lo, n_dev)
    pad = (hi == SENTINEL) & (lo == SENTINEL)
    dev = jnp.where(pad, n_dev, dev)
    dev, bhi, blo, bcnt = jax.lax.sort((dev, hi, lo, cnt), num_keys=3)
    idx = jnp.arange(key.shape[0], dtype=jnp.int32)
    first_of_dev = jnp.searchsorted(dev, jnp.arange(n_dev + 1, dtype=jnp.int32)).astype(jnp.int32)
    within = idx - first_of_dev[jnp.clip(dev, 0, n_dev)]
    overflow = jnp.any((within >= bucket_cap) & (dev < n_dev))
    tgt = jnp.where((dev < n_dev) & (within < bucket_cap), dev * bucket_cap + within,
                    n_dev * bucket_cap)
    size = n_dev * bucket_cap + 1
    buf_hi = jnp.full(size, SENTINEL, jnp.uint32).at[tgt].set(bhi)
    buf_lo = jnp.full(size, SENTINEL, jnp.uint32).at[tgt].set(blo)
    buf_cnt = jnp.zeros(size, jnp.int32).at[tgt].set(jnp.where(dev < n_dev, bcnt, 0))
    out_key = convert.hilo_to_key(np.asarray(buf_hi[:-1]), np.asarray(buf_lo[:-1]))
    shape = (n_dev, bucket_cap)
    return out_key.reshape(shape), np.asarray(buf_cnt[:-1]).reshape(shape), bool(overflow)


def _owner_np(key: np.ndarray, n_dev: int) -> np.ndarray:
    """owner_of in numpy: the uint32 hash of (hi, lo), PAD to n_dev."""
    hi = (key >> 32).astype(np.uint32)
    lo = (key & 0xFFFFFFFF).astype(np.uint32)
    h = lo * np.uint32(2654435761) + hi * np.uint32(0x9E3779B9)
    h ^= h >> np.uint32(16)
    return np.where(key == PAD, n_dev, (h % np.uint32(n_dev)).astype(np.int64))


# csrc/distributed.cu's geometry: 8 warps a tile, 4 rounds of 64 lanes a
# warp (OB_TILE = 2,048 lanes), and a small one with many tiles
K25_GEOMETRIES = {"source": (8, 4), "small": (2, 1)}


def k25_transcription(key, count, n_real: int, n_dev: int, bucket_cap: int, warps: int = 8,
                      rounds: int = 4):
    """numpy transcription of K25 (csrc/distributed.cu): the tile counts of
    owner_tile_counts_kernel (a round's ballots of the owners' bits, its
    leaders' counts), owner_offsets_kernel's scan of each owner's row in
    chunks of 32 tiles, totals and flag, owner_write_kernel's ranks (a
    running count a warp and owner, then the warps' starts) and its fill of
    4 lanes a thread.  Returns (out_key, out_count, flag) and asserts that
    each bucket lane is written exactly once."""
    tile = warps * 64 * rounds
    tiles = -(-n_real // tile)
    nbits = (n_dev - 1).bit_length()
    k = np.full(tiles * tile, PAD, np.int64)
    k[:n_real] = key[:n_real]
    c = np.zeros(tiles * tile, np.int32)
    c[:n_real] = count[:n_real]
    shape = (tiles, warps, rounds, 32, 2)  # [tile, warp, round, lane, item]
    o = _owner_np(k, n_dev).reshape(shape)
    v = o < n_dev
    lanebit = np.uint64(1) << np.arange(32, dtype=np.uint64)
    full = np.uint64(0xFFFFFFFF)

    def ballot(pred):  # [..., 32] -> [..., 1], a mask of the lanes
        return (pred.astype(np.uint64) * lanebit).sum(-1, keepdims=True)

    oa, ob = o[..., 0], o[..., 1]
    bits_a = [ballot((oa >> b) & 1) for b in range(nbits)]
    bits_b = [ballot((ob >> b) & 1) for b in range(nbits)]
    va, vb = ballot(v[..., 0]), ballot(v[..., 1])

    def masks(bits, valid, own):
        m = np.broadcast_to(valid, own.shape).copy()
        for b in range(nbits):
            m &= np.where((own >> b) & 1 == 1, bits[b], ~bits[b] & full)
        return m

    lt = lanebit - np.uint64(1)
    le = lt | lanebit
    pc = np.bitwise_count
    aa, ab = masks(bits_a, va, oa), masks(bits_b, vb, oa)
    ba, bb = masks(bits_a, va, ob), masks(bits_b, vb, ob)
    rank_a = pc(aa & lt).astype(np.int64) + pc(ab & lt)
    total_a = pc(aa).astype(np.int64) + pc(ab)
    rank_b = pc(ba & le).astype(np.int64) + pc(bb & lt)
    total_b = pc(ba).astype(np.int64) + pc(bb)
    lead_a, lead_b = v[..., 0] & (rank_a == 0), v[..., 1] & (rank_b == 0)
    t_idx, w_idx, _ = np.indices(shape[:3])
    t_idx, w_idx = (np.broadcast_to(x[..., None], shape[:4]) for x in (t_idx, w_idx))

    # pass 1: each tile's count of each owner, from the leaders
    counts = np.zeros((n_dev, tiles), np.int64)
    np.add.at(counts, (oa[lead_a], t_idx[lead_a]), total_a[lead_a])
    np.add.at(counts, (ob[lead_b], t_idx[lead_b]), total_b[lead_b])
    assert counts.sum() == v.sum()
    # pass 2: each owner's row scanned in chunks of 32 tiles
    starts = np.zeros_like(counts)
    totals = np.zeros(n_dev, np.int64)
    for d in range(n_dev):
        run = 0
        for c0 in range(0, tiles, 32):
            chunk = counts[d, c0:c0 + 32]
            inc = np.cumsum(chunk)
            starts[d, c0:c0 + 32] = run + inc - chunk
            run += int(inc[-1])
        totals[d] = run
    flag = bool((totals > bucket_cap).any())
    # pass 3, tile blocks: the running count a warp and owner, round by round
    run = np.zeros((tiles, warps, n_dev), np.int64)
    base = np.zeros(shape, np.int64)
    for r in range(rounds):
        for item, lead, total in ((0, lead_a, total_a), (1, lead_b, total_b)):
            own = o[:, :, r, :, item]
            safe = np.where(v[:, :, r, :, item], own, 0)
            base[:, :, r, :, item] = run[t_idx[:, :, r], w_idx[:, :, r], safe]
        for item, lead, total in ((0, lead_a, total_a), (1, lead_b, total_b)):
            sel = lead[:, :, r]
            np.add.at(run, (t_idx[:, :, r][sel], w_idx[:, :, r][sel],
                            o[:, :, r, :, item][sel]), total[:, :, r][sel])
    warp_start = starts.T[:, None, :] + np.cumsum(run, axis=1) - run  # [tiles, warps, D]
    rank = np.stack([rank_a, rank_b], -1) + base
    written = np.zeros(n_dev * bucket_cap, np.int64)
    out_key = np.empty(n_dev * bucket_cap, np.int64)
    out_count = np.empty(n_dev * bucket_cap, np.int32)
    for t, w, r, lane, item in zip(*np.nonzero(v)):
        own = o[t, w, r, lane, item]
        place = warp_start[t, w, own] + rank[t, w, r, lane, item]
        if place < bucket_cap:
            at = own * bucket_cap + place
            out_key[at] = k.reshape(shape)[t, w, r, lane, item]
            out_count[at] = c.reshape(shape)[t, w, r, lane, item]
            written[at] += 1
    # pass 3, fill blocks: 4 lanes a thread of the flat buckets, stepping
    # across bucket edges
    lanes = n_dev * bucket_cap
    a = 4 * np.arange(-(-lanes // 4), dtype=np.int64)
    d = a // bucket_cap
    w = a - d * bucket_cap
    for j in range(4):
        if j > 0:
            w = w + 1
            wrap = w == bucket_cap
            d, w = d + wrap, np.where(wrap, 0, w)
        fill = (a + j < lanes) & (w >= totals[np.minimum(d, n_dev - 1)])
        out_key[a[fill] + j] = PAD
        out_count[a[fill] + j] = 0
        written[a[fill] + j] += 1
    assert (written == 1).all()
    return out_key.reshape(n_dev, bucket_cap), out_count.reshape(n_dev, bucket_cap), flag


def _k25_check(key, count, n_real: int, n_dev: int, geometry: str) -> None:
    """The transcription == owner_buckets_plain == the reference's
    bucketing, at bucket_cap the widest owner's count (no flag) and one
    below it (the flag up, the widest bucket cut)."""
    owners = _owner_np(key[:n_real], n_dev)
    widest = int(np.bincount(owners, minlength=n_dev).max()) if n_real else 0
    caps = [max(widest, 1)] + ([widest - 1] if widest >= 2 else [])
    for cap in caps:
        got = k25_transcription(key, count, n_real, n_dev, cap, *K25_GEOMETRIES[geometry])
        plain = td.owner_buckets_plain(torch.from_numpy(key), torch.from_numpy(count), n_dev, cap)
        ref = buckets_jax(key, count, n_dev, cap)
        for g, p, r in zip(got[:2], plain[:2], ref[:2]):
            np.testing.assert_array_equal(g, p.numpy())
            np.testing.assert_array_equal(g, r)
        assert got[2] == bool(plain[2]) == ref[2] == (cap < widest)


@pytest.mark.parametrize("n_dev", [1, 2, 8, 33, 1024])
@pytest.mark.parametrize("n_real", K25_N_REAL)
@pytest.mark.parametrize("geometry", list(K25_GEOMETRIES))
def test_k25_transcription_matches_plain_and_reference(n_dev, n_real, geometry):
    """K25's design (tile counts, offsets, in-tile ranks, fill) on tables
    whose real lanes end on and beside a round, a 16-byte pair, a warp's
    segment and a tile of either geometry, or fill the table (n_real == C,
    no PAD)."""
    key, count = k25_table(n_real)
    n = key.shape[0] if n_real == "C" else n_real
    _k25_check(key, count, n, n_dev, geometry)


@pytest.mark.parametrize("n_dev", [1, 2, 8, 33, 1024])
def test_k25_transcription_on_an_overflowed_table(n_dev):
    """A local table whose distinct keys outgrew its capacity (n > C, the
    reference's silent cut): every lane is real, and sharded_tail passes
    n_real = min(n, C) = C."""
    rng = np.random.default_rng(n_dev)
    keys = torch.from_numpy(np.sort(rng.integers(0, 1 << 40, size=6000)))
    local = count_window_keys(keys, 3000)
    assert local.n > local.capacity
    n_real = min(local.n, local.capacity)
    _k25_check(local.key.numpy(), local.count.numpy(), n_real, n_dev, "small")
    got = td.owner_buckets(local.key, local.count, n_dev, 3000, n_real)
    want = buckets_jax(local.key.numpy(), local.count.numpy(), n_dev, 3000)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_sharded_tail_passes_the_real_lanes(monkeypatch):
    """sharded_tail hands owner_buckets n_real = min(n, C) of the local
    table, and owner_buckets refuses an n_real outside 0..C."""
    seen = []
    real = td.owner_buckets

    def spy(key, count, n_dev, bucket_cap, n_real):
        seen.append((n_real, key.shape[0]))
        return real(key, count, n_dev, bucket_cap, n_real)

    monkeypatch.setattr(td, "owner_buckets", spy)
    keys = torch.from_numpy(np.sort(np.random.default_rng(3).integers(0, 1 << 40, 5000)))
    td.sharded_tail(keys, 8, 1 << 13, 1 << 11)
    td.sharded_tail(keys, 8, 1000, 1 << 11)
    local = count_window_keys(keys, 1 << 13)
    assert seen == [(local.n, 1 << 13), (1000, 1000)]
    with pytest.raises(ValueError, match="n_real"):
        real(local.key, local.count, 8, 16, (1 << 13) + 1)


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
