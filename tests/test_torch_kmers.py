"""Port parity: k-mer keys, packed window extraction (K1's plain version)
and uint8 window extraction (K24's) against shannon_tpu.ops.kmers on
JAX-CPU.

Tolerance: exact.  Keys compare through their (hi, lo) view, valid masks
elementwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.io.pack import pack_reads
from shannon_tpu.ops.kmers import canonical_hilo, extract_kmers, extract_kmers_packed, revcomp_hilo
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


def _codes(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """uint8 codes of _reads(seed) at pad 100, with N (4) codes and short
    reads, plus codes >= 4 that no encoder writes (a code's low 2 bits must
    never be read where it is >= 4)."""
    batch = pack_reads(_reads(seed), pad_length=100)
    codes = batch.codes.copy()
    rng = np.random.default_rng(seed)
    hot = rng.random(codes.shape) < 0.005
    codes[hot] = rng.choice(np.array([4, 5, 7, 255], np.uint8), size=int(hot.sum()))
    return codes, batch.lengths


@pytest.mark.parametrize("k", [15, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_extract_kmers_matches_reference(k, canonical):
    codes, lengths = _codes(k)
    assert (codes >= 4).any() and (lengths < k).any()
    hi, lo, valid = extract_kmers(jnp.asarray(codes), jnp.asarray(lengths), k, canonical)
    key, pvalid = tk.extract_kmers(torch.from_numpy(codes), torch.from_numpy(lengths), k, canonical)
    phi, plo = key_to_hilo(key)
    np.testing.assert_array_equal(phi, np.asarray(hi))
    np.testing.assert_array_equal(plo, np.asarray(lo))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(valid))


def test_extract_kmers_equals_packed_extraction():
    """K24 on the codes == K1 on the words and mask packed from them."""
    batch = pack_reads(_reads(3), pad_length=128)
    words, lengths, mask = _port_inputs(batch)
    want = tk.extract_kmers_packed(words, lengths, 24, True, 128, mask)
    got = tk.extract_kmers(torch.from_numpy(batch.codes), lengths, 24)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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
    with pytest.raises(ValueError, match="1..31"):
        tk.extract_kmers(torch.from_numpy(batch.codes), lengths, 32)


def test_short_pad_is_refused():
    batch = pack_reads(["ACGT"], pad_length=16)
    words, lengths, _ = _port_inputs(batch)
    with pytest.raises(ValueError, match="pad_length"):
        tk.extract_kmers_packed(words, lengths, 20, length=16)
    with pytest.raises(ValueError, match="pad_length"):
        tk.extract_kmers(torch.from_numpy(batch.codes), lengths, 20)


_U32 = np.uint64(0xFFFFFFFF)


def _funnel_r(lo, hi, shift):
    """__funnelshift_r on uint64 arrays of 32-bit values, shift < 32."""
    return (((hi << np.uint64(32)) | lo) >> shift.astype(np.uint64)) & _U32


def _revcomp_bits(key, k: int):
    """csrc/common.cuh revcomp_bits: complement, reverse the 64 bits, swap
    each base's two bits back, shift down."""
    r = ~key & np.uint64((1 << (2 * k)) - 1)
    for s, m in ((1, 0x5555555555555555), (2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                 (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF), (32, 0x00000000FFFFFFFF)):
        s, m = np.uint64(s), np.uint64(m)
        r = ((r >> s) & m) | ((r & m) << s)  # __brevll
    m = np.uint64(0x5555555555555555)
    r = ((r >> np.uint64(1)) & m) | ((r & m) << np.uint64(1))
    return r >> np.uint64(64 - 2 * k)


def _k1_transcription(words, lengths, mask, length, k, canonical, rows, threads):
    """extract_kmers_kernel (csrc/kernels.cu) in numpy: blocks of `rows`
    read rows; each thread walks the block's flat windows from one division,
    stepping row and offset by constants (checked against the flat index);
    each window is one funnel shift of the <= 3 words holding its bases
    (words past the row read 0), rc = ~S & mask, fwd = revcomp_bits(rc),
    and the mask bits of [j, j + k) are one funnel shift of <= 2 words."""
    n, ww = words.shape
    W = length - k + 1
    w64 = np.concatenate([words.astype(np.uint64), np.zeros((n, 2), np.uint64)], axis=1)
    m64 = None if mask is None else np.concatenate(
        [mask.astype(np.uint64), np.zeros((n, 1), np.uint64)], axis=1)
    keys = np.full((n, W), -1, np.int64)
    valid = np.zeros((n, W), bool)
    for r0 in range(0, n, rows):
        total = min(rows, n - r0) * W
        step_r, step_j = threads // W, threads - (threads // W) * W
        walk = []
        for t in range(threads):
            r, j = t // W, t - (t // W) * W
            for f in range(t, total, threads):
                walk.append((f, r, j))
                j, r = j + step_j, r + step_r
                if j >= W:
                    j, r = j - W, r + 1
        f, r, j = (np.array(x, np.int64) for x in zip(*walk)) if walk else [np.zeros(0, int)] * 3
        assert np.array_equal(np.sort(f), np.arange(total)) and np.array_equal(f, r * W + j)
        row, w0 = r0 + r, j >> 4
        shift = (2 * (j & 15)).astype(np.uint64)
        x0, x1, x2 = (w64[row, w0 + i] for i in range(3))
        S = (_funnel_r(x1, x2, shift) << np.uint64(32)) | _funnel_r(x0, x1, shift)
        rc = ~S & np.uint64((1 << (2 * k)) - 1)
        fwd = _revcomp_bits(rc, k)
        ok = j + k <= lengths[row]
        if m64 is not None:
            bits = _funnel_r(m64[row, j >> 5], m64[row, (j >> 5) + 1], (j & 31).astype(np.uint64))
            ok &= (bits & np.uint64(0xFFFFFFFF >> (32 - k))) == 0
        v = np.where(canonical & (rc < fwd), rc, fwd).astype(np.int64)
        keys[row, j] = np.where(ok, v, tk.PAD)
        valid[row, j] = ok
    return keys, valid


@pytest.mark.parametrize("pad", [64, 100, 150, 256])
@pytest.mark.parametrize("k", [1, 16, 24, 31])
@pytest.mark.parametrize("rows,threads", [(32, 256), (3, 64)])
def test_k1_funnel_transcription_matches_reference(pad, k, rows, threads):
    """The funnel-shift design of K1, transcribed, equals the reference's
    extract_kmers_packed at pads 64-256, reads shorter than k and mask bits
    on either side of the mask words' edges, masked and not, both canonical
    modes; at the kernel's block shape and at a small one whose blocks and
    walks end mid-row."""
    from test_torch_kernels import extract_case

    words, lengths, mask, length = extract_case(pad, k, n=70)
    for m in (mask, None):
        for canonical in (True, False):
            hi, lo, valid = extract_kmers_packed(
                jnp.asarray(words), jnp.asarray(lengths), k, canonical, length,
                None if m is None else jnp.asarray(m))
            key, got_valid = _k1_transcription(words, lengths, m, length, k, canonical, rows,
                                               threads)
            np.testing.assert_array_equal(key, hilo_to_key(np.asarray(hi), np.asarray(lo)))
            np.testing.assert_array_equal(got_valid, np.asarray(valid))
