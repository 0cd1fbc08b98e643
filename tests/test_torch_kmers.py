"""Port parity: k-mer keys, packed window extraction (K1's plain version)
and uint8 window extraction (K24's) against shannon_tpu.ops.kmers on
JAX-CPU, and numpy transcriptions of the two kernels' designs (K1's
funnel-shift window walk, which K24 shares, and K24's pack of its code
bytes into K1's layout) against the same reference.

Tolerance: exact.  Keys compare through their (hi, lo) view, valid masks
elementwise."""

import functools

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


def _walk_windows(w64, m64, lens, W, k, canonical, threads):
    """extract_windows (csrc/kernels.cu, shared by K1 and K24) over one
    block's rows in numpy: w64 [rows, words + 2] uint64 of 32-bit words
    (two zero words past each row, which the kernel reads as 0), m64
    [rows, mask words + 1] or None, lens [rows].  Each thread walks the
    block's flat windows from one division, stepping row and offset by
    constants (checked against the flat index); each window is one funnel
    shift of the <= 3 words holding its bases, rc = ~S & mask, fwd =
    revcomp_bits(rc), and the mask bits of [j, j + k) are one funnel shift
    of <= 2 words.  Returns the block's keys and flags, flat."""
    total = w64.shape[0] * W
    step_r, step_j = threads // W, threads - (threads // W) * W
    t = np.arange(threads)
    r, j = t // W, t - (t // W) * W
    walk = []
    for f0 in range(0, total, threads):  # every thread's next window at once
        live = f0 + t < total
        walk.append((f0 + t[live], r[live], j[live]))
        j, r = j + step_j, r + step_r
        r, j = np.where(j >= W, r + 1, r), np.where(j >= W, j - W, j)
    f, r, j = (np.concatenate(x).astype(np.int64) for x in zip(*walk)) if walk else (
        [np.zeros(0, np.int64)] * 3)
    assert np.array_equal(np.sort(f), np.arange(total)) and np.array_equal(f, r * W + j)
    w0 = j >> 4
    shift = (2 * (j & 15)).astype(np.uint64)
    x0, x1, x2 = (w64[r, w0 + i] for i in range(3))
    S = (_funnel_r(x1, x2, shift) << np.uint64(32)) | _funnel_r(x0, x1, shift)
    rc = ~S & np.uint64((1 << (2 * k)) - 1)
    fwd = _revcomp_bits(rc, k)
    ok = j + k <= lens[r]
    if m64 is not None:
        bits = _funnel_r(m64[r, j >> 5], m64[r, (j >> 5) + 1], (j & 31).astype(np.uint64))
        ok &= (bits & np.uint64(0xFFFFFFFF >> (32 - k))) == 0
    v = np.where(canonical & (rc < fwd), rc, fwd).astype(np.int64)
    keys = np.full(total, -1, np.int64)
    valid = np.zeros(total, bool)
    keys[f] = np.where(ok, v, tk.PAD)
    valid[f] = ok
    return keys, valid


def _k1_transcription(words, lengths, mask, length, k, canonical, rows, threads):
    """extract_kmers_kernel (csrc/kernels.cu) in numpy: blocks of `rows`
    read rows, each walked by _walk_windows."""
    n, ww = words.shape
    W = length - k + 1
    w64 = np.concatenate([words.astype(np.uint64), np.zeros((n, 2), np.uint64)], axis=1)
    m64 = None if mask is None else np.concatenate(
        [mask.astype(np.uint64), np.zeros((n, 1), np.uint64)], axis=1)
    keys = np.full((n, W), -1, np.int64)
    valid = np.zeros((n, W), bool)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        kf, vf = _walk_windows(w64[r0:r1], None if m64 is None else m64[r0:r1],
                               lengths[r0:r1], W, k, canonical, threads)
        keys[r0:r1], valid[r0:r1] = kf.reshape(-1, W), vf.reshape(-1, W)
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


# K24 (extract_codes_kernel, csrc/kernels.cu): its shared-memory budget and
# row cap (EXTRACT_SMEM, EXTRACT_ROWS) and its piece of a long row
# (CODES_PIECE windows).
EXTRACT_SMEM, EXTRACT_ROWS, CODES_PIECE = 48 * 1024, 32, 16384


def _codes_smem_bytes(rows: int, length: int) -> int:
    units = -(-length // 16)
    return 4 * rows * (1 + units + (units + 1) // 2)


def k24_plan(L: int, k: int, n: int = 1 << 20, sms: int = 132) -> tuple[int, int, int]:
    """shannon_extract_codes's choice for n rows of L codes on a card of
    `sms` SMs: (rows a block, pieces a row, piece): up to EXTRACT_ROWS whole
    rows, and no more than n / sms rounded up, whose lengths, words and mask
    fit EXTRACT_SMEM (pieces 0), else one row in pieces of CODES_PIECE
    windows."""
    rows = min(EXTRACT_ROWS, -(-n // sms))
    while rows > 0 and _codes_smem_bytes(rows, L) > EXTRACT_SMEM:
        rows -= 1
    if rows:
        return rows, 0, CODES_PIECE
    return 1, -(-(L - k + 1) // CODES_PIECE), CODES_PIECE


def _pack4(b):
    """pack4: four code bytes' low 2 bits as 8 bits, the first byte lowest."""
    c = b & np.uint64(0x03030303)
    t = c | (c >> np.uint64(6))
    return (t & np.uint64(0xF)) | ((t >> np.uint64(12)) & np.uint64(0xF0))


def _bad4(b):
    """bad4: __vcmpgtu4(b, 0x03030303) (0xFF in each byte above 3), then one
    bit a byte by a multiply."""
    v = np.zeros_like(b)
    for i in range(4):
        byte = (b >> np.uint64(8 * i)) & np.uint64(0xFF)
        v |= np.where(byte > 3, np.uint64(0xFF << (8 * i)), np.uint64(0))
    prod = ((v & np.uint64(0x08040201)) * np.uint64(0x01010101)) & _U32
    return prod >> np.uint64(24)


def _span_words(buf, at, lo, hi):
    """span_word at byte addresses `at` (4-byte aligned): the aligned word
    of buf, its bytes outside [lo, hi) 0 and not read."""
    x = np.zeros(at.shape, np.uint64)
    for b in range(4):
        p = at + b
        inside = (p >= lo) & (p < hi)
        x |= np.where(inside, buf[np.where(inside, p, 0)].astype(np.uint64), 0) << np.uint64(8 * b)
    return x


def k24_transcription(buf, base, n, L, lengths, k, canonical, rows, pieces, piece, threads):
    """extract_codes_kernel in numpy.  The codes are the n * L bytes of buf
    from byte `base` on (buf's start is 16-byte aligned, as an allocation
    is; base is a view's offset).  A block takes `rows` whole rows (pieces
    0) or one piece of `piece` windows of a row, whose bases (a k - 1 base
    halo past its last window) it stages as a row of its own with the read's
    length less the piece's first window.  A thread packs 16 bases of a row
    from the <= 5 aligned 4-byte words that hold them (span_word: bytes
    outside the block's span 0 and not read), each pair funnel-shifted by
    the bases' byte offset, bytes past the row masked to 0, into one 2-bit
    word and one 16-bit half of an N-mask word (the high half of a row's
    last mask word 0 where its words are odd in number); then the block
    walks its windows with K1's walk."""
    W = L - k + 1
    keys = np.full((n, W), -1, np.int64)
    valid = np.zeros((n, W), bool)
    blocks = -(-n // rows) if pieces == 0 else n * pieces
    for blk in range(blocks):
        if pieces == 0:
            r0, j0, win, length = blk * rows, 0, W, L
            nr = min(rows, n - r0)
        else:
            r0, j0 = blk // pieces, (blk % pieces) * piece
            nr, win = 1, min(piece, W - j0)
            length = win + k - 1
        src = base + r0 * L + j0
        end = src + nr * length
        units = -(-length // 16)
        wm = (units + 1) // 2
        i, u = np.divmod(np.arange(nr * units), units)
        a = src + i * length + 16 * u
        nb = np.minimum(16, length - 16 * u)
        assert (nb > 0).all()
        w0, sh = a & ~3, (8 * (a & 3)).astype(np.uint64)
        nw = ((a & 3) + nb + 3) >> 2
        x = [np.where(q < nw, _span_words(buf, w0 + 4 * q, src, end), np.uint64(0))
             for q in range(5)]
        word = np.zeros(len(a), np.uint64)
        bad = np.zeros(len(a), np.uint64)
        for q in range(4):
            b = _funnel_r(x[q], x[q + 1], sh)
            in_row = np.clip(nb - 4 * q, 0, 4)
            b &= ((np.uint64(1) << (8 * in_row).astype(np.uint64)) - np.uint64(1))
            word |= _pack4(b) << np.uint64(8 * q)
            bad |= _bad4(b) << np.uint64(4 * q)
        words = np.zeros((nr, units + 2), np.uint64)
        words[i, u] = word
        halves = np.full((nr, 2 * wm + 2), 0xBEEF, np.uint64)  # dirty shared memory
        halves[i, u] = bad
        if units % 2:
            halves[:, units] = 0
        mask = halves[:, 0::2] | (halves[:, 1::2] << np.uint64(16))
        mask[:, wm] = 0  # the walk reads no mask word past the row's
        lens = lengths[r0:r0 + nr].astype(np.int64) - j0
        kf, vf = _walk_windows(words, mask, lens, win, k, canonical, threads)
        keys[r0:r0 + nr, j0:j0 + win] = kf.reshape(nr, win)
        valid[r0:r0 + nr, j0:j0 + win] = vf.reshape(nr, win)
    return keys, valid


K24_PADS = (64, 100, 101, 128, 150)


@functools.lru_cache(maxsize=None)
def _k24_reference(k: int, canonical: bool) -> dict:
    """The reference's extract_kmers on codes_case(L, k) for every L of
    K24_PADS in one call: each case's rows padded with code 0 to the widest
    L (window j < L - k + 1 reads only its row's first L codes), then cut
    back to each case's rows and L - k + 1 windows."""
    from test_torch_kernels import codes_case

    cases = [codes_case(L, k) for L in K24_PADS]
    width = max(K24_PADS)
    codes = np.concatenate([np.pad(c, ((0, 0), (0, width - c.shape[1]))) for c, _ in cases])
    lengths = np.concatenate([n for _, n in cases])
    hi, lo, valid = extract_kmers(jnp.asarray(codes), jnp.asarray(lengths), k, canonical)
    keys, valid = hilo_to_key(np.asarray(hi), np.asarray(lo)), np.asarray(valid)
    out, at = {}, 0
    for L, (c, _) in zip(K24_PADS, cases):
        out[L] = keys[at:at + len(c), :L - k + 1], valid[at:at + len(c), :L - k + 1]
        at += len(c)
    return out


@pytest.mark.parametrize("L", K24_PADS)
@pytest.mark.parametrize("k", [1, 16, 24, 31])
def test_k24_staged_transcription_matches_reference(L, k):
    """K24's design, transcribed, equals the reference's extract_kmers at
    pads 64-150 (rows that start off 16-byte boundaries at 100 and 101, a
    view that starts off one), N codes either side of the word and
    mask-word edges, codes >= 4 past a read's length, reads shorter than
    k, both canonical modes: at the kernel's plans for a large batch (32
    whole rows a block), for a dry run's 256-row shard and for its
    2,048-row batch (2 and 16 rows a block), at 3 rows a block with a
    small walk whose blocks end mid-row, and in pieces of 37 windows."""
    from test_torch_kernels import codes_case

    codes, lengths = codes_case(L, k)
    n = codes.shape[0]
    assert k24_plan(L, k) == (EXTRACT_ROWS, 0, CODES_PIECE)
    base = (L + 3 * k) % 16
    buf = np.zeros(base + codes.size + 16, np.uint8)
    buf[base:base + codes.size] = codes.reshape(-1)
    plans = [(*k24_plan(L, k, n=m), 256) for m in (1 << 20, 256, 2048)]
    plans += [(3, 0, 0, 64), (1, -(-(L - k + 1) // 37), 37, 64)]
    for canonical in (True, False):
        want = _k24_reference(k, canonical)[L]
        for rows, pieces, piece, threads in plans:
            got = k24_transcription(buf, base, n, L, lengths, k, canonical, rows, pieces, piece,
                                    threads)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


def test_k24_plan_stages_long_rows_in_pieces():
    """A row whose length, words and mask pass EXTRACT_SMEM alone is taken in
    pieces of CODES_PIECE windows; any shorter one whole, as many rows a
    block as fit up to EXTRACT_ROWS and n / SMs; every piece's bases
    fit."""
    assert k24_plan(128, 24) == (32, 0, CODES_PIECE)
    assert k24_plan(100, 24, n=65_536) == (32, 0, CODES_PIECE)
    assert k24_plan(100, 24, n=256) == (2, 0, CODES_PIECE)  # a dry run's shard
    assert k24_plan(100, 24, n=2048) == (16, 0, CODES_PIECE)  # its whole batch
    longest = max(L for L in range(120_000, 140_000) if _codes_smem_bytes(1, L) <= EXTRACT_SMEM)
    assert k24_plan(longest, 31) == (1, 0, CODES_PIECE)
    assert k24_plan(longest + 1, 31) == (1, -(-(longest - 29) // CODES_PIECE), CODES_PIECE)
    assert _codes_smem_bytes(1, CODES_PIECE + 30) <= EXTRACT_SMEM
    assert 1 < k24_plan(200_000, 1)[1] == -(-200_000 // CODES_PIECE)
    assert longest == 131_056
