"""Port parity: k-mer keys and packed window extraction (K1's plain
version) against shannon_tpu.ops.kmers on JAX-CPU.

Tolerance: exact.  Keys compare through their (hi, lo) view, valid masks
elementwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.kmers import canonical_hilo, extract_kmers_packed, revcomp_hilo
from shannon_tpu_torch.convert import hilo_to_key, key_to_hilo
from shannon_tpu_torch.ops import kmers as tk


def _reads(seed: int, n: int = 200, with_n: bool = True) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(1, 100))
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, size=length))
        if with_n and rng.random() < 0.2:
            p = int(rng.integers(0, length))
            s = s[:p] + "N" + s[p + 1 :]
        out.append(s)
    return out


def _port_inputs(batch):
    words = torch.from_numpy(batch.words.view(np.int32))
    lengths = torch.from_numpy(batch.lengths)
    mask = None if batch.mask is None else torch.from_numpy(batch.mask.view(np.int32))
    return words, lengths, mask


@pytest.mark.parametrize("k", [5, 16, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("with_n", [True, False])
def test_extract_kmers_packed_matches_reference(k, canonical, with_n):
    batch = pack_reads(_reads(k, with_n=with_n), pad_length=128)
    assert (batch.mask is not None) == with_n
    hi, lo, valid = extract_kmers_packed(
        jnp.asarray(batch.words), jnp.asarray(batch.lengths), k, canonical,
        batch.pad_length,
        None if batch.mask is None else jnp.asarray(batch.mask),
    )
    words, lengths, mask = _port_inputs(batch)
    key, pvalid = tk.extract_kmers_packed(
        words, lengths, k, canonical, batch.pad_length, mask
    )
    phi, plo = key_to_hilo(key)
    np.testing.assert_array_equal(phi, np.asarray(hi))
    np.testing.assert_array_equal(plo, np.asarray(lo))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(valid))


@pytest.mark.parametrize("k", [5, 16, 17, 24, 31])
def test_revcomp_and_canonical_match_reference(k):
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 1 << (2 * k), size=4096, dtype=np.int64)
    hi, lo = key_to_hilo(keys)
    rhi, rlo = revcomp_hilo(jnp.asarray(hi), jnp.asarray(lo), k)
    chi, clo = canonical_hilo(jnp.asarray(hi), jnp.asarray(lo), k)
    t = torch.from_numpy(keys)
    np.testing.assert_array_equal(
        tk.revcomp_key(t, k).numpy(), hilo_to_key(np.asarray(rhi), np.asarray(rlo))
    )
    np.testing.assert_array_equal(
        tk.canonical_key(t, k).numpy(), hilo_to_key(np.asarray(chi), np.asarray(clo))
    )
    # an involution, and canonical keys are their own canonical form
    np.testing.assert_array_equal(tk.revcomp_key(tk.revcomp_key(t, k), k).numpy(), keys)


def test_pad_key_sorts_after_every_real_key():
    top = (1 << 62) - 1  # the all-T 31-mer
    assert tk.PAD > top
    t = torch.tensor([tk.PAD, top, 0])
    assert torch.sort(t).values.tolist() == [0, top, tk.PAD]
    hi, lo = key_to_hilo(t)
    assert hi[0] == lo[0] == 0xFFFFFFFF


def test_k32_is_refused():
    batch = pack_reads(["A" * 40], pad_length=64)
    words, lengths, _ = _port_inputs(batch)
    with pytest.raises(ValueError, match="1..31"):
        tk.extract_kmers_packed(words, lengths, 32)


def test_short_pad_is_refused():
    batch = pack_reads(["ACGT"], pad_length=16)
    words, lengths, _ = _port_inputs(batch)
    with pytest.raises(ValueError, match="pad_length"):
        tk.extract_kmers_packed(words, lengths, 20, length=16)
