"""numpy transcriptions of the CUDA designs of K26 (ownership_pack) and K27
(ownership_unpack) in shannon_tpu_torch/csrc/multihost.cu, held to their
plain versions and to the reference's pack and unpack as
test_torch_ownership transcribes them (ref_buckets, ref_send, ref_unpack).

K26: the count pass's tile columns and each path's destination (a
warp-uniform loop over the destinations present in a round of 32 paths),
the offsets pass (a block a destination, block scans of its two rows), the
write pass's ranks (a running count a warp and destination, a warp scan of
the lengths), each path's place and each flat id's place in its bucket
(the tile's word-to-path map, or a binary search of the tile's offsets),
the headers and the pad fill in 4-word groups.  K27: the headers scanned
into each source's first path, flat id and weight-or-flat word, the length
tiles' mapping to their sources and their look-back scan into offs, and
the copy blocks' mapping of the weights and flat ids.  Each transcription asserts that every output word
is written exactly once.

Cases: H = 1, 2, 3, 4, 8 and 512 ranks; no path; every path bound for one
rank; P at a tile's edge (tile - 1, tile, tile + 1); one path whose flat
range is longer than a tile; an agreed cap above every bucket; received
buffers of every source's rows and of empty rows alone.  Two geometries:
the source's, and a small one with many tiles.

Tolerance: exact."""

import numpy as np
import pytest
import torch

from shannon_tpu_torch.parallel import multihost as tmh
from test_torch_ownership import _t, evidence, ref_buckets, ref_send, ref_unpack

# (warps a block, rounds of 64 paths a warp (two a lane), tiles a thread in
# the offsets pass, words a lane in K27): csrc/multihost.cu's (a 2,048-path
# tile, and scan.cuh's 4,096-word tile in K27), and a small one
GEOMETRIES = {"source": (8, 4, 4, 16), "small": (2, 1, 1, 2)}
# threads of the blocks that scan the H rows (two rows a thread)
ROW_THREADS = 256
RANKS = [1, 2, 3, 4, 8, 512]
CASES = ["random", "empty", "skew", "edge-1", "edge", "edge+1", "long", "wide", "stray"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions run a few small torch ops a rank; at 512 ranks,
    torch's intra-op threads across the suite's workers cost far more than
    the ops themselves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pack_tile(geometry: str) -> int:
    warps, rounds, _, _ = GEOMETRIES[geometry]
    return warps * 64 * rounds


def ownership_case(case: str, n_ranks: int, geometry: str):
    """(flat, offs, weights, owner, agree) of a case: 'random' 700 paths,
    'empty' none, 'skew' every path bound for the last rank, 'edge-1',
    'edge', 'edge+1' a tile's paths less one, exactly, and one more, 'long'
    300 paths of which one holds 3 tiles' worth of flat ids plus 5, 'wide'
    the random case with a cap 13 words above the widest bucket, 'stray'
    one node in 7 owned by -1 or H (its paths go nowhere, as the plain
    version's selection by rank drops them)."""
    tile = pack_tile(geometry)
    n_paths = {"random": 700, "empty": 0, "skew": 400, "edge-1": tile - 1, "edge": tile,
               "edge+1": tile + 1, "long": 300, "wide": 700, "stray": 700}[case]
    seed = 1000 * n_ranks + len(case) + n_paths
    flat, offs, weights, owner = evidence(seed, n_paths, 4 * n_paths + 90, n_ranks,
                                          "skew" if case == "skew" else "random")
    if case == "long":
        lens = np.diff(offs)
        lens[117] = 3 * max(tile, 4096) + 5
        offs = np.concatenate([[0], np.cumsum(lens)])
        flat = np.random.default_rng(seed).integers(0, len(owner), int(offs[-1]))
    if case == "stray":
        owner = owner.copy()
        owner[::7] = np.where(np.arange(len(owner[::7])) % 2 == 0, -1, n_ranks)
    agree = (lambda c: c + 13) if case == "wide" else (lambda c: c)
    return flat, offs, weights, owner, agree


class Writes:
    """An output array that counts the writes to each word."""

    def __init__(self, shape):
        self.value = np.full(shape, -7, np.int64)
        self.count = np.zeros(shape, np.int64)

    def put(self, at, value) -> None:
        np.add.at(self.count, at, 1)
        self.value[at] = value

    def once(self) -> np.ndarray:
        assert (self.count == 1).all(), "a word written other than once"
        return self.value


def block_exclusive_scan(values: np.ndarray, threads: int, items: int) -> tuple:
    """scan.cuh's block_exclusive_scan over `items` consecutive values a
    thread: each value's exclusive prefix and the total."""
    padded = np.zeros(threads * items, np.int64)
    padded[: len(values)] = values
    per = padded.reshape(threads, items)
    sums = per.sum(1)
    before = np.cumsum(sums) - sums
    ex = before[:, None] + np.cumsum(per, 1) - per
    return ex.reshape(-1)[: len(values)], int(sums.sum())


def rows_scan(values: np.ndarray) -> tuple:
    """The exclusive scan of one value a row over a block of ROW_THREADS
    threads, two rows a thread, and the total."""
    assert len(values) <= 2 * ROW_THREADS
    return block_exclusive_scan(values, ROW_THREADS, 2)


def k26_transcription(flat, offs, weights, owner, n_ranks: int, agree, geometry: str):
    """numpy transcription of K26: pack_counts_kernel, pack_offsets_kernel,
    the host's read and agree, pack_write_kernel (tile and fill blocks).
    Returns (send [H, cap] int32, sizes int64)."""
    warps, rounds, offset_items, _ = GEOMETRIES[geometry]
    threads, warp_paths, tile = 32 * warps, 64 * rounds, pack_tile(geometry)
    H = n_ranks
    flat, offs, weights, owner = (np.asarray(a, np.int64) for a in (flat, offs, weights, owner))
    P = len(offs) - 1
    tiles = -(-P // tile)
    items = np.arange(64)  # lane l holds items 2l (its path a) and 2l + 1 (b)

    def round_paths(t: int, w: int, r: int, n: int, dest=None):
        """A round's 64 paths in order: tile-local path, destination (the
        owner of its head node, or the count pass's dest where given),
        length."""
        li = w * warp_paths + 64 * r + items
        valid = li < n
        i = t * tile + np.minimum(li, max(n - 1, 0))
        o = owner[flat[offs[i]]] if dest is None else dest[i]
        p = np.where(valid & (o >= 0) & (o < H), o, H)
        ln = np.where(valid, offs[i + 1] - offs[i], 0)
        return li, p, ln

    def destinations(p: np.ndarray):
        """The warp-uniform loop: each destination present, by its first
        item (the first lane holding one, its a before its b), and its
        items."""
        todo = p < H
        while todo.any():
            d = int(p[np.argmax(todo)])
            mine = p == d
            todo &= ~mine
            yield d, mine

    # 1. each tile's column of the [2H, tiles] counts, each path's destination
    counts = np.full((2 * H, tiles), -1, np.int64)
    dest = np.full(P, -1, np.int64)
    for t in range(tiles):
        n = min(tile, P - t * tile)
        bins = np.zeros(2 * H, np.int64)
        for w in range(warps):
            for r in range(rounds):
                li, p, ln = round_paths(t, w, r, n)
                dest[t * tile + li[li < n]] = p[li < n]
                for d, mine in destinations(p):
                    bins[d] += mine.sum()
                    bins[H + d] += ln[mine].sum()
        counts[:, t] = bins
    assert (counts >= 0).all() and (dest >= 0).all() and (dest <= H).all()
    # 2. a block a destination: both rows scanned in chunks of threads x
    # offset_items tiles
    starts = np.zeros_like(counts)
    n_paths, n_flat = np.zeros(H, np.int64), np.zeros(H, np.int64)
    for d in range(H):
        for row, total in ((d, n_paths), (H + d, n_flat)):
            run = 0
            for base in range(0, tiles, threads * offset_items):
                chunk = counts[row, base : base + threads * offset_items]
                ex, s = block_exclusive_scan(chunk, threads, offset_items)
                starts[row, base : base + len(chunk)] = run + ex
                run += s
            total[d] = run
    sizes = 2 + 2 * n_paths + n_flat
    # 3. the host's one read, then agree
    widest = int(sizes.max())
    cap = agree(widest)
    assert cap >= widest
    send = Writes(H * cap)
    # 4a. tile blocks
    for t in range(tiles):
        t0, n = t * tile, min(tile, P - t * tile)
        s_offs = offs[t0 : t0 + n + 1] - offs[t0]
        run = np.zeros((2, warps, H), np.int64)
        key_d = np.full(tile, -1)
        key_r = np.full(tile, -1)
        place = np.zeros(tile, np.int64)
        for w in range(warps):
            for r in range(rounds):
                li, p, ln = round_paths(t, w, r, n, dest)
                for d, mine in destinations(p):
                    v = np.where(mine, ln, 0)
                    inc = np.cumsum(v)
                    below = np.cumsum(mine) - mine
                    key_d[li[mine]] = d
                    key_r[li[mine]] = run[0, w, d] + below[mine]
                    place[li[mine]] = run[1, w, d] + inc[mine] - v[mine]
                    run[0, w, d] += mine.sum()
                    run[1, w, d] += inc[-1]
        assert (key_r[:n] < 1 << 16).all() and (key_d[:n] < 1 << 16).all()
        for d in range(H):  # each warp's start: the tile's plus the earlier warps'
            for k, row in ((0, d), (1, H + d)):
                counts_w = run[k, :, d].copy()
                run[k, :, d] = starts[row, t] + np.cumsum(counts_w) - counts_w
        li = np.arange(n)
        real = key_d[:n] >= 0  # a path whose owner lies outside [0, H) is dropped
        li, d, w = li[real], key_d[:n][real], li[real] // warp_paths
        at = run[0, w, d] + key_r[li]
        send.put(d * cap + 2 + at, s_offs[li + 1] - s_offs[li])
        send.put(d * cap + 2 + n_paths[d] + at, weights[t0 + li])
        place[li] += 2 + 2 * n_paths[d] + run[1, w, d] - s_offs[li]
        # the flat ids: word j's path is the last li with s_offs[li] <= j,
        # from a map each path writes for its words where the tile holds at
        # most 2 x tile words, else by a binary search
        j = np.arange(s_offs[n])
        path = np.searchsorted(s_offs, j, side="right") - 1
        if len(j) <= 2 * tile:
            mapped = np.repeat(np.arange(n), np.diff(s_offs))
            np.testing.assert_array_equal(mapped, path)
        assert (path < n).all()
        j, path = j[key_d[path] >= 0], path[key_d[path] >= 0]
        send.put(key_d[path] * cap + place[path] + j, flat[offs[t0] + j])
    # 4b. fill blocks: the headers, then each row's pad groups
    d = np.arange(H)
    send.put(d * cap, n_paths)
    send.put(d * cap + 1, n_flat)
    lo, end = d * cap + sizes, (d + 1) * cap
    groups = np.where(lo < end, ((end - 1) >> 2) - (lo >> 2) + 1, 0)
    first, total = rows_scan(groups)
    g = np.arange(total)
    row = np.searchsorted(first, g, side="right") - 1  # rows without pad passed over
    at = 4 * ((lo[row] >> 2) + (g - first[row]))
    for k in range(4):
        inside = (at + k >= lo[row]) & (at + k < end[row])
        send.put(at[inside] + k, 0)
    return send.once().reshape(H, cap).astype(np.int32), sizes


def k27_transcription(recv, geometry: str):
    """numpy transcription of K27: the headers' scan, then
    ownership_unpack_kernel's length tiles (ticket order is tile order here;
    each tile's prefix is every earlier tile's aggregate, as the look-back
    finds it) and its copy blocks over the rows' weights and flat ids.
    Returns int64 (flat, offs, weights)."""
    warps, _, _, items = GEOMETRIES[geometry]
    tile_words = 32 * warps * items
    recv = np.asarray(recv, np.int64)
    H = recv.shape[0]
    n_p, n_f = recv[:, 0], recv[:, 1]
    ep, total_p = rows_scan(n_p)
    ef, total_f = rows_scan(n_f)
    s_path = np.append(ep, total_p)
    s_flat = np.append(ef, total_f)
    s_other = s_path + s_flat
    flat, offs, weights = Writes(total_f), Writes(total_p + 1), Writes(total_p)
    offs.put(0, 0)  # block 0
    # [warp, item, lane]: word seg + 32 j + lane of a warp's segment
    layout = (np.arange(warps)[:, None, None] * 32 * items
              + 32 * np.arange(items)[None, :, None] + np.arange(32)[None, None, :])

    def sources(first, v, real):
        """Each word's source; a warp whose real words share one takes it
        once (the same source either way)."""
        s = np.searchsorted(first, np.where(real, v, 0), side="right") - 1
        s = np.minimum(s, H - 1)
        one = np.searchsorted(first, v[:, 0, 0], side="right") - 1
        shared = np.array([(s[w][real[w]] == one[w]).all() for w in range(warps)])
        return np.where(shared[:, None, None], one[:, None, None].clip(0, H - 1), s)

    # the length tiles
    aggregates = []
    for tile in range(-(-total_p // tile_words)):
        g = tile * tile_words + layout
        real = g < total_p
        s = sources(s_path, g, real)
        x = np.where(real, recv[s, np.minimum(2 + g - s_path[s], recv.shape[1] - 1)], 0)
        # item-major, then lanes, a warp; the warps' totals; the tiles'
        inc = np.cumsum(x.reshape(warps, -1), 1).reshape(x.shape)
        warp_total = inc[:, -1, -1]
        before = np.cumsum(warp_total) - warp_total
        prefix = sum(aggregates)  # the look-back: every earlier tile's aggregate
        aggregates.append(int(warp_total.sum()))
        offs.put(g[real] + 1, (prefix + before[:, None, None] + inc)[real])
    # the copy blocks: word u of the rows' [weights, flat ids] laid end to end
    for block in range(-(-(total_p + total_f) // tile_words)):
        u = block * tile_words + layout
        real = u < total_p + total_f
        s = sources(s_other, u, real)
        c = u - s_other[s]
        npp = s_path[s + 1] - s_path[s]
        x = recv[s, np.minimum(2 + npp + c, recv.shape[1] - 1)]
        is_w, is_f = real & (c < npp), real & (c >= npp)
        weights.put(s_path[s][is_w] + c[is_w], x[is_w])
        flat.put(s_flat[s][is_f] + c[is_f] - npp[is_f], x[is_f])
    return flat.once(), offs.once(), weights.once()


def _plain_pack(flat, offs, weights, owner, n_ranks, agree):
    send, sizes = tmh.ownership_pack_plain(_t(flat), _t(offs), _t(weights), _t(owner), n_ranks,
                                           agree)
    return send.numpy(), sizes.numpy()


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("n_ranks", RANKS)
@pytest.mark.parametrize("case", CASES)
def test_k26_transcription_matches_plain_and_reference(geometry, n_ranks, case):
    flat, offs, weights, owner, agree = ownership_case(case, n_ranks, geometry)
    send, sizes = k26_transcription(flat, offs, weights, owner, n_ranks, agree, geometry)
    p_send, p_sizes = _plain_pack(flat, offs, weights, owner, n_ranks, agree)
    np.testing.assert_array_equal(send, p_send)
    np.testing.assert_array_equal(sizes, p_sizes)
    buckets = ref_buckets(flat, offs, weights, owner, n_ranks)
    np.testing.assert_array_equal(send, ref_send(buckets, send.shape[1]))
    if case == "skew":
        assert (send[:-1, :2] == 0).all() and (send[:-1, 2:] == 0).all()


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("n_ranks", RANKS)
@pytest.mark.parametrize("case", CASES)
def test_k27_transcription_matches_plain_and_reference(geometry, n_ranks, case):
    flat, offs, weights, owner, agree = ownership_case(case, n_ranks, geometry)
    send, _ = _plain_pack(flat, offs, weights, owner, n_ranks, agree)
    got = k27_transcription(send, geometry)
    plain = tmh.ownership_unpack_plain(torch.from_numpy(send))
    for g, p, r in zip(got, plain, ref_unpack(send)):
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("n_ranks", [2, 3, 4, 8])
def test_k27_transcription_on_an_exchange(geometry, n_ranks):
    """What rank r receives: row r of every rank's buffer at the widest
    bucket of all ranks (the agreed cap)."""
    tile = pack_tile(geometry)
    ev = [evidence(7 * n_ranks + r, tile // 3 * (r + 1), 300, n_ranks, "random")
          for r in range(n_ranks)]
    widest = max(len(b) for e in ev for b in ref_buckets(*e, n_ranks))
    sends = [k26_transcription(*e, n_ranks, lambda c: widest, geometry)[0] for e in ev]
    for r in range(n_ranks):
        recv = np.stack([s[r] for s in sends])
        got = k27_transcription(recv, geometry)
        for g, p in zip(got, tmh.ownership_unpack_plain(torch.from_numpy(recv))):
            np.testing.assert_array_equal(g, p.numpy())


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("n_ranks, cap", [(1, 2), (2, 9), (512, 2), (512, 7)])
def test_k27_transcription_on_empty_rows(geometry, n_ranks, cap):
    """A buffer whose rows are all empty ([0, 0] and zeros): offs == [0]."""
    recv = np.zeros((n_ranks, cap), np.int32)
    got = k27_transcription(recv, geometry)
    for g, p in zip(got, tmh.ownership_unpack_plain(torch.from_numpy(recv))):
        np.testing.assert_array_equal(g, p.numpy())
    assert list(got[1]) == [0]
