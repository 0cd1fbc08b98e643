"""Port parity: sorted-table lookup (K3's plain version) against
shannon_tpu.ops.spectrum.lookup_hilo on JAX-CPU, in both of the
reference's regimes (binary search for few queries, sort-merge join for
many); count lookups (K21's plain version) against lookup_counts,
sibling maxima (K22's plain version) against sibling_maxes, and neighbor
counts (K28's plain version) against neighbor_counts, on spectra both
packages counted from the same reads (via convert).

Tolerance: exact — hit masks equal, idx equal where hit (the contract of
both packages; on a miss the reference's two kernels differ); counts,
sibling maxima and neighbor counts equal on every lane."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.ops import spectrum as jspec
from shannon_tpu.ops.spectrum import lookup_hilo
from shannon_tpu_torch.convert import key_to_hilo
from shannon_tpu_torch.ops.kmers import PAD
from shannon_tpu_torch.ops.spectrum import (
    lookup_counts, lookup_sorted, neighbor_counts, probe_keys, sibling_maxes,
)
from shannon_tpu_torch.ops.count import Spectrum
from test_torch_correction import _jax_spectrum, _spectra
from test_torch_kernels import CONTRACT_CASES, contract_case


def _table(rng, k: int, n: int, cap: int) -> np.ndarray:
    keys = np.unique(rng.integers(0, 1 << (2 * k), size=n, dtype=np.int64))
    return np.concatenate([keys, np.full(cap - len(keys), PAD, np.int64)])


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("n_query", [7, 5000])
def test_lookup_matches_reference(k, n_query):
    rng = np.random.default_rng(k * 100 + n_query)
    table = _table(rng, k, 300, 512)
    real = table[table != PAD]
    query = np.where(
        rng.random(n_query) < 0.5,
        rng.choice(real, size=n_query),
        rng.integers(0, 1 << (2 * k), size=n_query, dtype=np.int64),
    )
    thi, tlo = key_to_hilo(table)
    qhi, qlo = key_to_hilo(query)
    r_idx, r_hit = lookup_hilo(jnp.asarray(thi), jnp.asarray(tlo), jnp.asarray(qhi), jnp.asarray(qlo))
    idx, hit = lookup_sorted(torch.from_numpy(table), torch.from_numpy(query))
    r_hit = np.asarray(r_hit)
    np.testing.assert_array_equal(hit.numpy(), r_hit)
    np.testing.assert_array_equal(idx.numpy()[r_hit], np.asarray(r_idx)[r_hit])
    # every hit points at the query's own key
    assert (table[idx.numpy()[r_hit]] == query[r_hit]).all()


def test_lookup_keeps_query_shape_and_clamps():
    table = torch.tensor([2, 4, 6, PAD])
    query = torch.tensor([[1, 2, 3], [6, 7, 1 << 40]])
    idx, hit = lookup_sorted(table, query)
    assert idx.shape == hit.shape == query.shape
    assert hit.tolist() == [[False, True, False], [True, False, False]]
    assert idx.tolist() == [[0, 0, 1], [2, 3, 3]]


def test_lookup_in_empty_table_is_refused():
    with pytest.raises(ValueError, match="empty"):
        lookup_sorted(torch.empty(0, dtype=torch.int64), torch.tensor([1]))


@pytest.mark.parametrize("shape", ["flat", "probes"])
def test_lookup_counts_matches_reference(shape):
    """[Q] queries (hits, misses and PAD) and the [8, C] sibling probes of
    the whole table, pad lanes' probes included."""
    port, ref = _spectra(24, seed=7)
    rng = np.random.default_rng(8)
    real = port.key[: port.n].numpy()
    if shape == "flat":
        query = np.concatenate([
            rng.choice(real, 300), rng.integers(0, 1 << 48, 300, dtype=np.int64), [PAD, PAD],
        ])
        rng.shuffle(query)
    else:
        query = probe_keys(port.key, 24, "sib", True).numpy()
    qhi, qlo = key_to_hilo(query)
    want = np.asarray(jspec.lookup_counts(ref, jnp.asarray(qhi), jnp.asarray(qlo)))
    got = lookup_counts(port, torch.from_numpy(query))
    assert got.shape == query.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any() and (want == 0).any()
    assert (got.numpy()[query == PAD] == 0).all()


def test_lookup_counts_in_an_empty_table_misses():
    port, _ = _spectra(24)
    empty = type(port)(key=port.key[:0], count=port.count[:0], n=0)
    assert lookup_counts(empty, torch.tensor([[1, PAD]])).tolist() == [[0, 0]]


@pytest.mark.parametrize("case", CONTRACT_CASES)
def test_lookup_counts_contract_tables_match_reference(case):
    """K21's plain version == lookup_counts on the Spectrum contract's edge
    tables (C twelve times n as in the flagship table, n == C, n == 0 with
    C > 0, n above C): the [8, C] sibling probes, and hits, misses, queries
    above and below every real key and PAD queries."""
    spec, queries = contract_case(case)
    ref = _jax_spectrum(spec)
    for q in queries:
        qhi, qlo = key_to_hilo(q)
        want = np.asarray(jspec.lookup_counts(ref, jnp.asarray(qhi), jnp.asarray(qlo)))
        got = lookup_counts(spec, torch.from_numpy(q))
        assert got.shape == q.shape
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want[q == PAD] == 0).all()


@pytest.mark.parametrize("case", CONTRACT_CASES)
def test_lookup_counts_of_the_real_lanes_alone(case):
    """What K21 relies on: under the contract a search of key[:min(n, C)]
    alone (a miss counting 0) gives the whole table's counts."""
    spec, queries = contract_case(case)
    m = min(spec.n, spec.capacity)
    real = Spectrum(key=spec.key[:m], count=spec.count[:m], n=m)
    for q in queries:
        query = torch.from_numpy(q)
        np.testing.assert_array_equal(lookup_counts(real, query).numpy(),
                                      lookup_counts(spec, query).numpy())


@pytest.mark.parametrize("k", [5, 16, 17, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_sibling_maxes_matches_reference(k, canonical):
    """16 and 17 straddle the reference's hs >= 32 branch."""
    port, ref = _spectra(k, canonical=canonical)
    want_r, want_l = (np.asarray(x) for x in jspec.sibling_maxes(ref, k, canonical))
    got_r, got_l = sibling_maxes(port, k, canonical)
    assert got_r.dtype == got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    n = port.n
    assert (got_r[:n] > port.count[:n]).any() and (got_l[:n] > port.count[:n]).any()
    assert (got_r[n:] == 0).all() and (got_l[n:] == 0).all()


def _assert_neighbor_counts_equal(port, ref, k, canonical):
    want = [np.asarray(x) for x in jspec.neighbor_counts(ref, k, canonical)]
    got = neighbor_counts(port, k, canonical)
    assert [tuple(g.shape) for g in got] == [(4, port.capacity)] * 2 + [(port.capacity,)] * 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    return got


@pytest.mark.parametrize("k", [13, 17, 24])
@pytest.mark.parametrize("canonical", [True, False])
def test_neighbor_counts_matches_reference(k, canonical):
    """K28's plain version == neighbor_counts on every lane of all four
    outputs.  2k = 26, 34 and 48: 17 and 24 put the left probes' top base
    in the reference's hi word (hs = 2(k-1) >= 32), 13 in its lo word."""
    port, ref = _spectra(k, canonical=canonical)
    rext, lext, rmax, lmax = _assert_neighbor_counts_equal(port, ref, k, canonical)
    n = port.n
    assert n < port.capacity  # PAD lanes are compared too, and give zeros
    for x in (rext[:, n:], lext[:, n:], rmax[n:], lmax[n:]):
        assert (x == 0).all()
    # the table holds its k-mers' neighbors: most entries extend both ways
    assert (rext[:, :n] > 0).any(0).float().mean() > 0.5
    assert (lext[:, :n] > 0).any(0).float().mean() > 0.5
    assert (rmax[:n] >= port.count[:n]).all() and (lmax[:n] >= port.count[:n]).all()


@pytest.mark.parametrize("kmer", ["ACGTTGCAACGTAGC", "AAAAAAAAAAAAAAA"])
@pytest.mark.parametrize("canonical", [True, False])
def test_neighbor_counts_of_a_one_entry_table(kmer, canonical):
    """One real entry in 8 lanes: a homopolymer is its own extension and
    sibling; any other k-mer finds only itself among its siblings."""
    from shannon_tpu.ops.count import spectrum_from_arrays as ref_from_arrays
    from shannon_tpu_torch.ops.count import spectrum_from_arrays
    from shannon_tpu_torch.oracle.counting import canon_kmer, str_to_kmer

    k = len(kmer)
    key = str_to_kmer(kmer)
    if canonical:
        key = canon_kmer(key, k)
    keys, counts = np.array([key], np.uint64), np.array([7], np.int64)
    port = spectrum_from_arrays(keys, counts, capacity=8, device="cpu")
    ref = ref_from_arrays(keys, counts, capacity=8)
    rext, lext, rmax, lmax = _assert_neighbor_counts_equal(port, ref, k, canonical)
    assert rmax[0] == lmax[0] == 7 and (rmax[1:] == 0).all()
    assert int(rext[:, 0].sum()) == int(lext[:, 0].sum()) == (7 if kmer[0] == kmer[1] else 0)
