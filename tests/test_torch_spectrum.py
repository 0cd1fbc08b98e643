"""Port parity: sorted-table lookup (K3's plain version) against
shannon_tpu.ops.spectrum.lookup_hilo on JAX-CPU, in both of the
reference's regimes (binary search for few queries, sort-merge join for
many).

Tolerance: exact — hit masks equal, idx equal where hit (the contract of
both packages; on a miss the reference's two kernels differ)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.ops.spectrum import lookup_hilo
from shannon_tpu_torch.convert import key_to_hilo
from shannon_tpu_torch.ops.kmers import PAD
from shannon_tpu_torch.ops.spectrum import lookup_sorted


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
