"""Port parity: counting (K2's plain version), merges, the batch driver
and the convert round trip, against shannon_tpu.ops.count on JAX-CPU.

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
from shannon_tpu_torch import convert
from shannon_tpu_torch.ops import count as tc
from shannon_tpu_torch.ops.kmers import PAD


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
