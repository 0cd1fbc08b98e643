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

from test_torch_kernels import EDGE_SIZES, RUN_SHAPES, merge_case, run_case


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


@pytest.mark.parametrize("case", ["unequal", "identical", "disjoint", "empty", "overflow"])
def test_merge_at_cases_match_reference(case):
    """K17's plain version == _merge_at: capacities that differ, a table
    merged with itself, disjoint and interleaved tables, an empty table,
    and an output capacity below the union (n counts every distinct key,
    the table keeps the first `capacity` of them)."""
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
    assert (case == "overflow") == (union > cap)


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
