"""Port parity: counting (K2's plain version, from packed words and from
uint8 codes), merges, the batch driver and the convert round trip, against
shannon_tpu.ops.count on JAX-CPU.

Tolerance: exact — keys (as (hi, lo)), counts and n equal over the whole
capacity."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops import count as jc
from shannon_tpu.ops.kmers import hilo_to_int
from shannon_tpu.sim import sample_reads, simulate_transcripts
from shannon_tpu_torch import convert, kernels
from shannon_tpu_torch.ops import count as tc
from shannon_tpu_torch.ops.kmers import PAD

from test_torch_kernels import (
    EDGE_SIZES, MERGE_OVERFLOW_CASES, MERGE_TILE_CASES, RUN_SHAPES, merge_case, run_case,
)


def _reads(seed: int, n_tr: int = 3, error_rate: float = 0.01) -> list[str]:
    rng = np.random.default_rng(seed)
    ts = simulate_transcripts(rng, n=n_tr, length=300)
    return sample_reads(rng, ts, coverage=10, read_length=60, error_rate=error_rate)


def _assert_same(port: tc.Spectrum, ref: jc.Spectrum, capacity: bool = True):
    hi, lo, count, n = convert.spectrum_to_numpy(port)
    assert n == int(ref.n)
    if not capacity:
        hi, lo, count = hi[:n], lo[:n], count[:n]
        ref = jc._slice_spectrum(ref, n)
    np.testing.assert_array_equal(hi, np.asarray(ref.hi))
    np.testing.assert_array_equal(lo, np.asarray(ref.lo))
    np.testing.assert_array_equal(count, np.asarray(ref.count))


def _both_counts(batch, k, capacity, canonical=True):
    ref = jc.count_spectrum_packed(
        jnp.asarray(batch.words), jnp.asarray(batch.lengths), k, capacity,
        canonical, batch.pad_length,
        None if batch.mask is None else jnp.asarray(batch.mask),
    )
    port = tc.count_spectrum_packed(
        torch.from_numpy(batch.words.view(np.int32)), torch.from_numpy(batch.lengths),
        k, capacity, canonical, batch.pad_length,
        None if batch.mask is None else torch.from_numpy(batch.mask.view(np.int32)),
    )
    return port, ref


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_count_spectrum_packed_matches_reference(k, canonical):
    batch = pack_reads(_reads(k) + ["ACGTNACGTACGTAAACCCGGGTTT" * 3], pad_length=96)
    port, ref = _both_counts(batch, k, 1 << 13, canonical)
    assert not port.overflowed() and not ref.overflowed()
    _assert_same(port, ref)


@pytest.mark.parametrize("k", [15, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_count_spectrum_matches_reference(k, canonical):
    """The uint8 route (K24, sort, K2) == ops/count.py:215 count_spectrum,
    N codes and reads shorter than k included."""
    batch = pack_reads(_reads(k) + ["ACGTNACGTACGTAAACCCGGGTTT" * 3, "ACGTN"], pad_length=96)
    ref = jc.count_spectrum(jnp.asarray(batch.codes), jnp.asarray(batch.lengths), k, 1 << 13,
                            canonical)
    port = tc.count_spectrum(torch.from_numpy(batch.codes), torch.from_numpy(batch.lengths), k,
                             1 << 13, canonical)
    assert not port.overflowed() and port.n > 0
    _assert_same(port, ref)


def test_count_overflow_is_reported_not_truncated():
    batch = pack_reads(_reads(1), pad_length=64)
    port, ref = _both_counts(batch, 21, 64)
    assert port.overflowed() and ref.overflowed()
    assert port.n == int(ref.n) > 64
    _assert_same(port, ref)


def test_merge_matches_reference():
    a_port, a_ref = _both_counts(pack_reads(_reads(2), pad_length=64), 19, 1 << 12)
    b_port, b_ref = _both_counts(pack_reads(_reads(3), pad_length=64), 19, 1 << 12)
    _assert_same(tc.merge_at(a_port, b_port, 1 << 13), jc._merge_at(a_ref, b_ref, 1 << 13))
    _assert_same(tc.merge_spectra_sized(a_port, b_port), jc.merge_spectra_sized(a_ref, b_ref))


@pytest.mark.parametrize(
    "case", ["unequal", "identical", "disjoint", "empty", "overflow", *MERGE_TILE_CASES]
)
def test_merge_at_cases_match_reference(case):
    """K17's plain version == _merge_at: capacities that differ, a table
    merged with itself, disjoint and interleaved tables, an empty table,
    and an output capacity below the union (n counts every distinct key,
    the table keeps the first `capacity` of them), and K17's tile cases
    (repeated keys and wrapping counts among them)."""
    (ak, ac, acap), (bk, bc, bcap), cap = merge_case(case)
    port = tc.merge_at(
        tc.spectrum_from_arrays(ak, ac, acap, device="cpu"),
        tc.spectrum_from_arrays(bk, bc, bcap, device="cpu"), cap,
    )
    ref = jc._merge_at(jc.spectrum_from_arrays(ak, ac, acap), jc.spectrum_from_arrays(bk, bc, bcap),
                       cap)
    _assert_same(port, ref)
    union = len(np.union1d(ak, bk))
    assert port.n == union and port.overflowed() == (union >= cap)
    assert (case in MERGE_OVERFLOW_CASES) == (union > cap)


def test_merge_at_runs_plain_on_cpu(monkeypatch):
    """On CPU tensors merge_at is its plain version and reaches no kernel."""
    def no_library():
        raise AssertionError("a CPU merge reached the kernel library")

    monkeypatch.setattr(kernels, "library", no_library)
    (ak, ac, acap), (bk, bc, bcap), cap = merge_case("unequal")
    a = tc.spectrum_from_arrays(ak, ac, acap, device="cpu")
    b = tc.spectrum_from_arrays(bk, bc, bcap, device="cpu")
    got, want = tc.merge_at(a, b, cap), tc.merge_at_plain(a, b, cap)
    assert got.n == want.n
    assert torch.equal(got.key, want.key) and torch.equal(got.count, want.count)


@pytest.mark.parametrize("capacity", [1 << 11, 1 << 14])
def test_count_reads_spectrum_matches_reference(capacity):
    """Several batches; the small capacity forces the grown (sized)
    merge path."""
    batch = pack_reads(_reads(4, n_tr=6), pad_length=64)
    ref = jc.count_reads_spectrum(batch, k=21, capacity=capacity, batch_reads=128)
    port = tc.count_reads_spectrum(batch, k=21, capacity=capacity, batch_reads=128, device="cpu")
    assert port.capacity == ref.capacity
    _assert_same(port, ref)
    _assert_same(tc.shrink_spectrum(port), jc.shrink_spectrum(ref))


def _contract_producer(name: str) -> tc.Spectrum:
    """A Spectrum (CPU) from one of the port's producers, on small reads."""
    from shannon_tpu_torch.ops import correction as tcor
    from shannon_tpu_torch.ops import tipclip as ttc
    from shannon_tpu_torch.ops.condense import build_contig_arrays
    from shannon_tpu_torch.parallel import make_mesh
    from shannon_tpu_torch.parallel.distributed import count_reads_spectrum_sharded

    batch = pack_reads(_reads(5, n_tr=4), pad_length=64)
    k, cap = 21, 1 << 12

    def counted() -> tc.Spectrum:
        return tc.count_reads_spectrum(batch, k=k, capacity=cap, batch_reads=128, device="cpu")

    def part(seed: int) -> tc.Spectrum:
        return _both_counts(pack_reads(_reads(seed), pad_length=64), k, cap)[0]

    if name == "count_reads_spectrum":
        return counted()
    if name == "shrink_spectrum":
        return tc.shrink_spectrum(counted())
    if name == "merge_spectra_fixed":
        return tc.merge_spectra_fixed(part(2), part(3))
    if name == "merge_spectra_sized":
        return tc.merge_spectra_sized(part(2), part(3))
    if name == "abundance_filter":
        return tcor.abundance_filter(counted(), 2)
    if name == "correct_spectrum":
        return tcor.correct_spectrum(counted(), k, 0, 0.1, 8, True, 0.01)
    if name == "drop_contigs":
        spec = tcor.correct_spectrum(counted(), k, 0, 0.1, 8, True, 0.01)
        ca = build_contig_arrays(spec, k, True)
        doomed = torch.from_numpy(np.random.default_rng(5).random(ca.node_key.shape[0]) < 0.3)
        return ttc._drop_contigs(spec, ca, doomed)
    if name == "count_reads_spectrum_sharded":
        spec, overflowed = count_reads_spectrum_sharded(
            batch, k=k, capacity=cap, mesh=make_mesh(4, "cpu"), batch_reads=128)
        assert not overflowed
        return spec
    if name == "spectrum_from_numpy":
        ref = jc.count_reads_spectrum(batch, k=k, capacity=cap, batch_reads=128)
        return convert.spectrum_from_numpy(ref.hi, ref.lo, ref.count, int(ref.n))
    if name == "empty_spectrum":
        return tc.empty_spectrum(4096, "cpu")
    if name == "overflow_batch":  # a batch table past its capacity
        return _both_counts(pack_reads(_reads(1), pad_length=64), k, 64)[0]
    if name == "overflow_merge":  # a merge below the union
        return tc.merge_at(part(2), part(3), 256)
    if name == "overflow_slice":  # ops/count.py _slice_spectrum below n
        return tc._slice_spectrum(counted(), 100)
    raise ValueError(name)


CONTRACT_PRODUCERS = [
    "count_reads_spectrum", "shrink_spectrum", "merge_spectra_fixed", "merge_spectra_sized",
    "abundance_filter", "correct_spectrum", "drop_contigs", "count_reads_spectrum_sharded",
    "spectrum_from_numpy", "empty_spectrum", "overflow_batch", "overflow_merge",
    "overflow_slice",
]


@pytest.mark.parametrize("producer", CONTRACT_PRODUCERS)
def test_spectrum_contract(producer):
    """The Spectrum contract that K16 and K21 rely on (they read only the
    first min(n, C) lanes): key[:min(n, C)] strictly increasing with no PAD,
    key[min(n, C):] all PAD with count 0; for every producer of a Spectrum,
    and for tables that overflowed (n >= C)."""
    spec = _contract_producer(producer)
    m = min(spec.n, spec.capacity)
    key, count = spec.key.numpy(), spec.count.numpy()
    assert (key[:m] != PAD).all() and (np.diff(key[:m]) > 0).all()
    assert (key[m:] == PAD).all() and (count[m:] == 0).all()
    assert (m > 0) == (producer != "empty_spectrum")
    assert producer.startswith("overflow") == (spec.n >= spec.capacity)


def test_unique_first_sorted_matches_reference():
    rng = np.random.default_rng(7)
    keys = np.sort(rng.integers(0, 50, size=300)).astype(np.int64)
    keys = np.concatenate([keys, np.full(20, PAD, np.int64)])
    pay = rng.integers(0, 1000, size=keys.shape[0]).astype(np.int32)
    hi, lo = convert.key_to_hilo(keys)
    r_hi, r_lo, (r_pay,), r_n = jc.unique_first_sorted(
        jnp.asarray(hi), jnp.asarray(lo), (jnp.asarray(pay),), 400
    )
    key, (p_pay,), n = tc.unique_first_sorted(
        torch.from_numpy(keys), (torch.from_numpy(pay),), 400
    )
    assert n == int(r_n)
    np.testing.assert_array_equal(key.numpy(), convert.hilo_to_key(r_hi, r_lo))
    np.testing.assert_array_equal(p_pay.numpy(), np.asarray(r_pay))


def test_reduce_sorted_plain_contract():
    keys = torch.tensor([3, 3, 5, 7, 7, 7, 9, PAD, PAD])
    key, count, start, n = tc.reduce_sorted_plain(keys, None, 3)
    assert n == 4  # overflowed: 4 distinct keys, capacity 3
    assert key.tolist() == [3, 5, 7] and count.tolist() == [2, 1, 3]
    assert start.tolist() == [0, 2, 3]
    key, count, _, n = tc.reduce_sorted_plain(
        keys, torch.tensor([1, 2, 3, 4, 5, 6, 7, 0, 0], dtype=torch.int32), 6
    )
    assert n == 4
    assert key.tolist() == [3, 5, 7, 9, PAD, PAD]
    assert count.tolist() == [3, 3, 15, 7, 0, 0]


def _reduce_matches_reference(keys, counts, cap, merge: bool) -> int:
    """K2's plain version == _unique_reduce (merge) or _unique_reduce_unit
    on the same keys: keys, counts and n over the whole capacity."""
    hi, lo = convert.key_to_hilo(keys)
    if merge:
        ref = jc._unique_reduce(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(counts), cap)
    else:
        ref = jc._unique_reduce_unit(jnp.asarray(hi), jnp.asarray(lo), cap)
    key, count, _, n = tc.reduce_sorted_plain(
        torch.from_numpy(keys), torch.from_numpy(counts) if merge else None, cap
    )
    _assert_same(tc.Spectrum(key=key, count=count, n=n), ref)
    return n


@pytest.mark.parametrize("m", [m for m in EDGE_SIZES if m > 0])
@pytest.mark.parametrize("merge", [False, True])
def test_reduce_sorted_plain_at_tile_edges_matches_reference(m, merge):
    """The sizes that pin the single-pass scan's tile edges (K2's cuda
    tests use the same inputs); m = 0 is the contract case below, since
    the reference reads the last lane of its count prefix."""
    keys, counts, cap = run_case("random", m)
    _reduce_matches_reference(keys, counts, cap, merge)


def test_reduce_sorted_plain_on_no_keys():
    key, count, start, n = tc.reduce_sorted_plain(torch.zeros(0, dtype=torch.int64), None, 4)
    assert n == 0 and key.tolist() == [PAD] * 4 and count.tolist() == [0] * 4


@pytest.mark.parametrize("shape", RUN_SHAPES)
@pytest.mark.parametrize("merge", [False, True])
def test_reduce_sorted_plain_run_shapes_match_reference(shape, merge):
    """Runs over tile edges, a run ending on one, all PAD, and n past a
    capacity inside a tile (counts that wrap int32 in the long run)."""
    keys, counts, cap = run_case(shape)
    n = _reduce_matches_reference(keys, counts, cap, merge)
    assert (shape == "overflow_inside_tile") == (n > cap)


@pytest.mark.parametrize("n", [0, 1, 1 << 19, 3_000_000])
def test_tight_capacity_matches_reference(n):
    assert tc.tight_capacity(n) == jc.tight_capacity(n)
    assert tc.tight_capacity(n, minimum=1 << 15) == jc.tight_capacity(n, minimum=1 << 15)


def test_spectrum_convert_round_trip():
    batch = pack_reads(_reads(5), pad_length=64)
    port, ref = _both_counts(batch, 23, 1 << 12)
    back = convert.spectrum_from_numpy(
        np.asarray(ref.hi), np.asarray(ref.lo), np.asarray(ref.count), int(ref.n)
    )
    assert torch.equal(back.key, port.key) and torch.equal(back.count, port.count)
    assert back.n == port.n
    n = port.n
    kmers = hilo_to_int(ref.hi[:n], ref.lo[:n])
    counts = np.asarray(ref.count[:n])
    _assert_same(
        tc.spectrum_from_arrays(kmers, counts, device="cpu"), jc.spectrum_from_arrays(kmers, counts)
    )
    assert port.to_dict() == ref.to_dict()


def _warp_partition(lo: int, hi: int, pred) -> int:
    """csrc/kernels.cu warp_partition: the first index in [lo, hi) where
    pred is false (pred true on a prefix), 32 pivots a round."""
    while hi > lo:
        span = hi - lo
        if span <= 32:
            return lo + sum(pred(lo + lane) for lane in range(span))
        p = [lo + span * (lane + 1) // 33 for lane in range(32)]
        t = [pred(x) for x in p]
        c = sum(t)
        assert t == [True] * c + [False] * (32 - c)
        lo, hi = (p[c - 1] + 1 if c > 0 else lo), (p[c] if c < 32 else hi)
    return lo


def _k17_transcription(a_key, a_count, b_key, b_count, capacity, tile, threads):
    """merge_runs_kernel (csrc/kernels.cu) in numpy, its tiles in ticket
    order: real lengths by search for PAD, each tile's merge-path split on
    its two diagonals, each thread's split of its own diagonal in the tile
    and its merge (ties to a), K2's start flags, weights, records and
    copy-out, the edge runs added as the kernel's atomicAdds add them, the
    last real tile's total in the last status word, then the tail fill."""
    items = tile // threads
    Ca, Cb = len(a_key), len(b_key)
    na = _warp_partition(0, Ca, lambda i: a_key[i] != PAD)
    nb = _warp_partition(0, Cb, lambda i: b_key[i] != PAD)
    N, tiles = na + nb, -(-(Ca + Cb) // tile)

    def split(d):
        return _warp_partition(max(0, d - nb), min(d, na), lambda i: a_key[i] <= b_key[d - 1 - i])

    out_key = np.full(capacity, -7, np.int64)  # -7: never written
    out_count = np.zeros(capacity, np.uint32)
    status = np.zeros(tiles, np.int64)
    for t in range(tiles):
        d0 = t * tile
        if d0 >= N:
            break
        d1 = min(d0 + tile, N)
        a0, a1 = split(d0), split(d1)
        b0, b1 = d0 - a0, d1 - a1
        la, L = a1 - a0, d1 - d0
        lb = L - la
        sk = np.concatenate([a_key[a0:a1], b_key[b0:b1]])
        sc = np.concatenate([a_count[a0:a1], b_count[b0:b1]]).astype(np.uint32)
        lowest = -(1 << 63)
        before = PAD if d0 == 0 else max(a_key[a0 - 1] if a0 else lowest,
                                         b_key[b0 - 1] if b0 else lowest)
        after = min(a_key[a1] if a1 < na else PAD, b_key[b1] if b1 < nb else PAD)
        keys, weights, flags = [], [], []
        for tid in range(threads):
            first = tid * items
            lo, hi = (0, 0) if first >= L else (max(0, first - lb), min(first, la))
            while lo < hi:
                mid = (lo + hi) >> 1
                if sk[mid] <= sk[la + first - 1 - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            ai, bi = lo, first - lo
            prev = before
            if 0 < first < L:
                prev = max(sk[ai - 1] if ai else lowest, sk[la + bi - 1] if bi else lowest)
            for j in range(items):
                ka = sk[ai] if ai < la else PAD
                kb = sk[la + bi] if bi < lb else PAD
                if first + j >= L:
                    k, w = PAD, 0
                elif ka <= kb:
                    k, w, ai = ka, sc[ai], ai + 1
                else:
                    k, w, bi = kb, sc[la + bi], bi + 1
                flags.append(k != PAD and k != prev)
                keys.append(k)
                weights.append(w)
                prev = k
        assert keys[:L] == sorted(keys[:L])
        w = np.array(weights, np.uint64)
        excl = (np.cumsum(w) - w).astype(np.uint32)  # wraps modulo 2^32, as the kernel's sums
        tile_weight = np.uint32(int(w.sum()) % (1 << 32))
        start_at = np.flatnonzero(flags)
        s_start, s_before = np.array(keys)[start_at], excl[start_at]
        starts = len(start_at)
        prefix = int(status[t - 1]) if t else 0
        if prefix > 0 and prefix - 1 < capacity:
            out_count[prefix - 1] += s_before[0] if starts else tile_weight
        for q in range(starts):
            g = prefix + q
            if g >= capacity:
                break
            out_key[g] = s_start[q]
            if q + 1 < starts:
                out_count[g] = s_before[q + 1] - s_before[q]
            elif after == s_start[q]:
                out_count[g] += tile_weight - s_before[q]
            else:
                out_count[g] = tile_weight - s_before[q]
        status[t] = prefix + starts
        if d1 == N and t != tiles - 1:
            status[tiles - 1] = status[t]
    n = int(status[-1]) if tiles else 0
    out_key[n:] = PAD
    return tc.Spectrum(key=torch.from_numpy(out_key),
                       count=torch.from_numpy(out_count.view(np.int32)), n=n)


@pytest.mark.parametrize(
    "case", ["unequal", "identical", "disjoint", "empty", "overflow", *MERGE_TILE_CASES]
)
@pytest.mark.parametrize("tile,threads", [(4096, 256), (64, 16)])
def test_k17_merge_path_transcription_matches_reference(case, tile, threads):
    """K17's one-pass merge, transcribed, equals the reference's _merge_at
    on every merge case: at the kernel's tile, and at 64-lane tiles, where
    the same tables cross many tile edges (runs over several tiles, equal
    pairs split by a diagonal, a last tile short of its end)."""
    (ak, ac, acap), (bk, bc, bcap), cap = merge_case(case)
    a = tc.spectrum_from_arrays(ak, ac, acap, device="cpu")
    b = tc.spectrum_from_arrays(bk, bc, bcap, device="cpu")
    with np.errstate(over="ignore"):  # the counts' sums wrap modulo 2^32 on purpose
        port = _k17_transcription(a.key.numpy(), a.count.numpy(), b.key.numpy(),
                                  b.count.numpy(), cap, tile, threads)
    ref = jc._merge_at(jc.spectrum_from_arrays(ak, ac, acap), jc.spectrum_from_arrays(bk, bc, bcap),
                       cap)
    _assert_same(port, ref)
