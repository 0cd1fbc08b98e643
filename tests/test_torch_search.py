"""The 16-ary search index that K3 (lookup_sorted) and K7 (probe_lookup)
walk on the card (csrc/search.cuh), on the CPU:

1. the index: its layout (ops/spectrum.search_layout) and its plain build
   (search_index_plain), walked by a numpy transcription of the kernels'
   walk, equal to np.searchsorted plus the clamp on tables that pin every
   edge of the index;
2. K7's probe-group rule (csrc/correction.cu probe_route): the probes that
   resolve from a shared group are that group's key with their own base,
   and their lower bounds lie within 3 lanes of the group's; a forward
   right sibling's lies within 3 lanes of its own key's;
3. the plain twins (lookup_sorted_plain, probe_resolve_plain) equal to the
   JAX package's lower_bound_hilo on the same tables, idx on misses
   included;
4. K21 (csrc/spectrum.cu lookup_counts_kernel): search_lane, a lane's
   own walk of the index, equal to np.searchsorted; the queries resolved
   at the table's ends and the searches over the real lanes' index, equal
   to lookup_counts_plain on the Spectrum contract's edge tables;
5. K22 (csrc/spectrum.cu sibling_maxes_kernel): each real lane's 8 sibling
   probes resolved over key[:min(n, C)] by K7's group rule (own-group
   steps from the lane, one walk of the shared reverse-complement group
   and steps up from it, a lane walk for every other probe), equal to the
   JAX package's sibling_maxes at the contract's edges and on palindromes.

Inputs are made from seeds with numpy.  Tolerance: exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shannon_tpu.ops import spectrum as jspec
from shannon_tpu.ops.spectrum import lower_bound_hilo
from shannon_tpu_torch.convert import key_to_hilo
from shannon_tpu_torch.ops import correction as tcor
from shannon_tpu_torch.ops import spectrum as tsp
from shannon_tpu_torch.ops.count import Spectrum
from shannon_tpu_torch.ops.kmers import PAD
from test_torch_kernels import (
    CONTRACT_CASES, PROBE_TABLES, SEARCH_SIZES, SEARCH_TABLES, _revcomp_np, contract_case,
    k22_tables, probe_table, search_queries, search_table,
)

F = tsp.SEARCH_FANOUT


def walk(table: np.ndarray, index: np.ndarray, layout: tsp.SearchLayout, q: np.ndarray):
    """numpy transcription of search_top and search_walk: each query's
    lower bound in the top level (a lane's binary search in shared memory)
    clamped to the top's last entry is its node one level down; at each
    level below, the 16 entries of its node (a level's last node filled up
    with PAD), the rank (a ballot's popcount) picks the child, clamped to
    the level's last entry; at the leaf line, where lanes past the table's
    end compare greater than every query, the rank gives the lower bound in
    [0, n] and the equality ballot's bit at that rank gives hit."""
    n, lane = len(table), np.arange(F)
    node = np.zeros(len(q), np.int64)
    if layout.sizes:
        top = index[:layout.sizes[-1]]
        node = np.minimum(np.searchsorted(top, q, side="left"), len(top) - 1)
    for size, off in zip(reversed(layout.sizes[:-1]), reversed(layout.offsets[:-1])):
        e = index[off + node[:, None] * F + lane]
        node = np.minimum(node * F + (e < q[:, None]).sum(1), size - 1)
    pos = node[:, None] * F + lane
    ok = pos < n
    e = table[np.minimum(pos, n - 1)]
    r = (ok & (e < q[:, None])).sum(1)
    equal = np.concatenate([ok & (e == q[:, None]), np.zeros((len(q), 1), bool)], axis=1)
    return node * F + r, equal[np.arange(len(q)), r]


def test_layout_levels_and_offsets():
    """Levels of ceil(size / 16) up to the first of at most
    SEARCH_TOP_WORDS entries (the top, at offset 0 of the scratch), each
    rounded up to whole nodes of 16: the main path's two tables as the
    index was designed."""
    assert tsp.search_layout(16) == tsp.SearchLayout((), (), 0)
    assert tsp.search_layout(17) == tsp.SearchLayout((2,), (0,), 16)
    assert tsp.search_layout(16 * 4096) == tsp.SearchLayout((4096,), (0,), 4096)
    assert tsp.search_layout(16 * 4096 + 1) == tsp.SearchLayout((4097, 257), (272, 0), 4384)
    lay = tsp.search_layout(4_194_304)  # K3's node table: a top of 1,024 keys
    assert lay == tsp.SearchLayout((262_144, 16_384, 1_024), (17_408, 1_024, 0), 279_552)
    lay = tsp.search_layout(12_582_912)  # K7's correction input: a top of 3,072
    assert lay.sizes == (786_432, 49_152, 3_072) and lay.offsets == (52_224, 3_072, 0)
    with pytest.raises(ValueError, match="empty"):
        tsp.search_layout(0)
    with pytest.raises(ValueError, match="2\\^31"):
        tsp.search_layout(1 << 31)
    scratch, words = tsp.search_args(16 * 4096 + 1, "cpu")
    assert scratch.shape == (4384,)
    assert list(words) == [2, 4097, 257] + [0] * 6 + [272, 0] + [0] * 6


@pytest.mark.parametrize("n", SEARCH_SIZES)
@pytest.mark.parametrize("kind", SEARCH_TABLES)
def test_walk_of_the_index_is_the_clamped_lower_bound(n, kind):
    """The walk over search_index_plain == np.searchsorted plus
    the clamp (idx on misses too) on edge tables: all PAD, a PAD tail, keys
    0 and 4^k - 1, queries equal to PAD; and every index entry is the last
    key of its subtree."""
    table = search_table(n, kind)
    layout = tsp.search_layout(n)
    index = tsp.search_index_plain(torch.from_numpy(table)).numpy()
    for t, (size, off) in enumerate(zip(layout.sizes, layout.offsets)):
        j = np.arange(-(-size // F) * F)
        np.testing.assert_array_equal(
            index[off:off + len(j)],
            np.where(j < size, table[np.minimum(F ** (t + 1) * (j + 1), n) - 1], PAD))
    q = search_queries(table)
    lb, hit = walk(table, index, layout, q)
    want = np.searchsorted(table, q, side="left")
    np.testing.assert_array_equal(lb, want)
    idx = np.minimum(want, n - 1)
    np.testing.assert_array_equal(hit, table[idx] == q)
    got = tsp.lookup_sorted(torch.from_numpy(table), torch.from_numpy(q))
    np.testing.assert_array_equal(got[0].numpy(), idx)
    np.testing.assert_array_equal(got[1].numpy(), table[idx] == q)


def _routes(table: np.ndarray, k: int, side: str, canonical: bool):
    """numpy transcription of K7's probe_route: per [8, C] probe, 0 where it
    lies in its lane's own group (x & ~3 == v & ~3), 1 in group job 8, 2 in
    group job 9 (ext only), 3 a walk of its own, -1 on a PAD lane; with the
    probe keys, their forward forms and the group keys."""
    mask = (1 << (2 * k)) - 1
    keys = tsp.probe_keys(torch.from_numpy(table), k, side, canonical).numpy()
    fwd = tsp.probe_keys(torch.from_numpy(table), k, side, False).numpy()
    rc = _revcomp_np(table, k)
    ga = ((table << 2) & mask) if side == "ext" else (rc & ~3)
    gb = (rc << 2) & mask
    g = keys & ~3
    route = np.where(g == (table & ~3), 0,
                     np.where(g == ga, 1, np.where((side == "ext") & (g == gb), 2, 3)))
    return np.where(table == PAD, -1, route), keys, fwd, ga, gb


@pytest.mark.parametrize("kind", PROBE_TABLES + ["random"])
@pytest.mark.parametrize("k", [15, 24, 31])
@pytest.mark.parametrize("side", ["sib", "ext"])
@pytest.mark.parametrize("canonical", [True, False])
def test_probe_group_rule(kind, k, side, canonical):
    """Each probe K7 resolves from a shared group is that group's key with
    its own base set, and its lower bound lies in lb(g) .. lb(g) + 3; each
    forward right sibling resolves in its own group, within lanes i - 3 ..
    i + 3 (or at C, before the clamp); the shortcuts are taken wherever the
    form says."""
    if kind == "random":  # distinct random keys, canonical where the spectrum is
        keys = search_table(1500, "pad_tail", k)
        keys = keys[keys != PAD]
        keys = np.unique(np.minimum(keys, _revcomp_np(keys, k)) if canonical else keys)
        table = np.concatenate([keys, np.full(1500 - len(keys), PAD)])
    else:
        table = probe_table(kind, k, canonical, C=1500)
    mask = (1 << (2 * k)) - 1
    route, keys, fwd, ga, gb = _routes(table, k, side, canonical)
    real = table != PAD
    C = len(table)
    lane = np.arange(C)
    lb = np.searchsorted(table, keys, side="left")
    b = (np.arange(8) >> 1)[:, None]
    right = (np.arange(8) % 2 == 0)[:, None]
    is_fwd = keys == fwd
    rc = _revcomp_np(table, k)
    if side == "sib":
        expect_a = real & ~right & ~is_fwd
        np.testing.assert_array_equal(keys[expect_a], ((rc & ~3) | (3 - b))[expect_a])
        own = real & right & is_fwd
        np.testing.assert_array_equal(keys[own], ((table & ~3) | b)[own])
        assert (route[own] == 0).all()
        assert ((np.abs(lb - lane) <= 3) | (lb == C))[own].all()
        expect_b = np.zeros_like(expect_a)
    else:
        expect_a = real & right & is_fwd
        np.testing.assert_array_equal(keys[expect_a], (((table << 2) & mask) | b)[expect_a])
        expect_b = real & ~right & ~is_fwd
        np.testing.assert_array_equal(keys[expect_b],
                                      (((rc << 2) & mask) | (3 - b))[expect_b])
    # the form's shortcut is taken, unless the probe lies in the lane's own
    # group or, where the two groups are one (a palindrome), in group A
    assert np.isin(route[expect_a], (0, 1)).all()
    assert ((route == 0) | (route == 2) | ((route == 1) & (ga == gb)))[expect_b].all()
    for r, g in ((1, ga), (2, gb)):
        sel = route == r
        lb_g = np.broadcast_to(np.searchsorted(table, g, side="left"), keys.shape)
        assert ((keys & ~3) == g)[sel].all()
        assert ((lb[sel] >= lb_g[sel]) & (lb[sel] <= lb_g[sel] + 3)).all()
    own = route == 0
    assert ((np.abs(lb - lane) <= 3) | (lb == C))[own].all()


def _hilo_lower_bound(table: np.ndarray, q: np.ndarray):
    thi, tlo = key_to_hilo(table)
    qhi, qlo = key_to_hilo(q.reshape(-1))
    idx, hit = lower_bound_hilo(jnp.asarray(thi), jnp.asarray(tlo), jnp.asarray(qhi),
                                jnp.asarray(qlo))
    return np.asarray(idx).astype(np.int64).reshape(q.shape), np.asarray(hit).reshape(q.shape)


@pytest.mark.parametrize("n", SEARCH_SIZES)
@pytest.mark.parametrize("kind", SEARCH_TABLES)
def test_plain_lookup_matches_reference_lower_bound(n, kind):
    """lookup_sorted_plain == the reference's lower_bound_hilo on the edge
    tables: idx on every lane (both are the clamped lower bound) and hit."""
    table = search_table(n, kind)
    q = search_queries(table)
    want = _hilo_lower_bound(table, q)
    got = tsp.lookup_sorted_plain(torch.from_numpy(table), torch.from_numpy(q))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("kind", PROBE_TABLES)
@pytest.mark.parametrize("side", ["sib", "ext"])
@pytest.mark.parametrize("canonical", [True, False])
def test_plain_probe_resolve_matches_reference_lower_bound(kind, side, canonical):
    """probe_resolve_plain == lower_bound_hilo on the same probes, idx on
    misses included, at k = 24."""
    k = 24
    table = probe_table(kind, k, canonical, C=1500)
    spec = Spectrum(key=torch.from_numpy(table), count=torch.ones(len(table), dtype=torch.int32),
                    n=int((table != PAD).sum()))
    got = tcor.probe_resolve_plain(spec, k, canonical, side)
    q = tsp.probe_keys(spec.key, k, side, canonical).numpy()
    want = _hilo_lower_bound(table, q)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def lane_walk(table: np.ndarray, index: np.ndarray, layout: tsp.SearchLayout, q: np.ndarray):
    """numpy transcription of search_top and search_lane (a query a lane,
    q <= table[-1]): below the top, each level's and then the leaf line's
    16 entries searched by the four steps h = 8, 4, 2, 1 (r += h where
    entry r + h - 1 is below q; leaf lanes past the table's end compare
    greater).  Returns (lower bound, hit)."""
    n = len(table)
    node = np.zeros(len(q), np.int64)
    if layout.sizes:
        top = index[:layout.sizes[-1]]
        node = np.minimum(np.searchsorted(top, q, side="left"), len(top) - 1)

    def rank(entries):
        r = np.zeros(len(q), np.int64)
        for h in (8, 4, 2, 1):
            r += np.where(entries[np.arange(len(q)), r + h - 1] < q, h, 0)
        return r

    for off in reversed(layout.offsets[:-1]):
        node = node * F + rank(index[off + node[:, None] * F + np.arange(F)])
    pos = node[:, None] * F + np.arange(F)
    lb = node * F + rank(np.where(pos < n, table[np.minimum(pos, n - 1)], PAD))
    return lb, table[lb] == q


def k21_transcription(key: np.ndarray, count: np.ndarray, n: int, q: np.ndarray) -> np.ndarray:
    """numpy transcription of lookup_counts_kernel over key[:n]: a query
    inside [key[0], key[n - 1]] searches (lane_walk) and counts its hit's
    count, 0 on a miss; every other query, PAD included, counts 0 with no
    search."""
    out = np.zeros(len(q), np.int32)
    if n == 0:
        return out
    table = key[:n]
    layout = tsp.search_layout(n)
    index = tsp.search_index_plain(torch.from_numpy(table)).numpy()
    inside = (q >= table[0]) & (q <= table[-1])
    lb, hit = lane_walk(table, index, layout, q[inside])
    out[inside] = np.where(hit, count[lb], 0)
    return out


@pytest.mark.parametrize("n", SEARCH_SIZES)
@pytest.mark.parametrize("kind", SEARCH_TABLES)
def test_lane_walk_is_the_lower_bound(n, kind):
    """search_lane, transcribed, == np.searchsorted for every query up to
    the table's last key, on the edge tables of the index."""
    table = search_table(n, kind)
    real = table[table != PAD]
    if len(real) == 0:
        return
    table = real
    layout = tsp.search_layout(len(table))
    index = tsp.search_index_plain(torch.from_numpy(table)).numpy()
    q = search_queries(table)
    q = q[q <= table[-1]]
    lb, hit = lane_walk(table, index, layout, q)
    np.testing.assert_array_equal(lb, np.searchsorted(table, q, side="left"))
    np.testing.assert_array_equal(hit, table[lb] == q)


@pytest.mark.parametrize("case", CONTRACT_CASES)
def test_k21_transcription_matches_plain(case):
    """K21's search == lookup_counts_plain on the contract's edge tables:
    the flat queries (hits, misses, keys above and below every real key,
    PAD), the same sorted and repeated, and the [8, C] probes (a pad lane's
    probes fill warp after warp)."""
    spec, (flat, probes) = contract_case(case)
    key, count = spec.key.numpy(), spec.count.numpy()
    n = min(spec.n, spec.capacity)
    runs = np.sort(np.repeat(flat[:400], 77))
    for q in (flat, runs, probes.reshape(-1)):
        want = tsp.lookup_counts_plain(spec, torch.from_numpy(q)).numpy()
        np.testing.assert_array_equal(k21_transcription(key, count, n, q), want)


def _step_up(table: np.ndarray, j: np.ndarray, x: np.ndarray):
    """probe.cuh step_up: from lane j (at or below x's lower bound) up past
    the keys below x; (lower bound, hit)."""
    n, j = len(table), j.copy()
    while True:
        move = (j < n) & (table[np.minimum(j, n - 1)] < x)
        if not move.any():
            return j, (j < n) & (table[np.minimum(j, n - 1)] == x)
        j[move] += 1


def _step_down(table: np.ndarray, j: np.ndarray, x: np.ndarray):
    """probe.cuh step_down: from lane j, whose key is >= x, down past the
    keys >= x; (lower bound, hit)."""
    j = j.copy()
    while True:
        move = (j > 0) & (table[np.maximum(j - 1, 0)] >= x)
        if not move.any():
            return j, table[j] == x
        j[move] -= 1


def _real_index(table: np.ndarray) -> tuple[np.ndarray, tsp.SearchLayout]:
    """The index K22 and K28 walk over the real lanes `table`: the one the
    entry point builds or, where it has one level, the top each block
    gathers from the table (no build)."""
    n = len(table)
    layout = tsp.search_layout(n)
    if len(layout.sizes) == 1:
        top = layout.sizes[0]
        index = np.full(layout.words, tsp.PAD, np.int64)
        index[:top] = table[np.minimum(16 * np.arange(1, top + 1), n) - 1]
    else:
        index = tsp.search_index_plain(torch.from_numpy(table)).numpy()
    return index, layout


def probe_lane_transcription(table: np.ndarray, count: np.ndarray, k: int, side: str,
                             canonical: bool):
    """numpy transcription of probe.cuh's probe_lane over the real lanes
    `table` = key[:n] (distinct, sorted): a real lane v's probe p
    (probe_key: the plain version's form) in its own group (x & ~3 == v &
    ~3) steps from the lane (down from i where x <= v, else up from i + 1);
    one in group job 8 (sib: rc(v) & ~3; ext: (v << 2) & mask) or, for
    ext, job 9 ((rc(v) << 2) & mask) steps up from that group's lower
    bound, which one walk gives; every other probe walks.  A walk
    (probe_find) of a query above key[n - 1] gives n and a miss, any other
    the lane walk's answer over _real_index.  Returns (each probe's count,
    0 on a miss, [8, n]; the walks of each lane, group walks included)."""
    n = len(table)
    mask = (1 << (2 * k)) - 1
    index, layout = _real_index(table)

    def find(q):
        above = q > table[-1]
        lb, hit = lane_walk(table, index, layout, np.where(above, table[-1], q))
        return np.where(above, n, lb), hit & ~above

    lane = np.arange(n)
    rc = _revcomp_np(table, k)
    ga = ((table << 2) & mask) if side == "ext" else rc & ~3
    gb = (rc << 2) & mask
    x = tsp.probe_keys(torch.from_numpy(table), k, side, canonical).numpy()
    g = x & ~3
    route = np.where(g == (table & ~3), 0, np.where(
        g == ga, 1, np.where((side == "ext") & (g == gb), 2, 3)))
    lb, hit = np.zeros((8, n), np.int64), np.zeros((8, n), bool)
    for p in range(8):
        own, down = route[p] == 0, x[p] <= table
        for sel, step in ((own & down, _step_down), (own & ~down, _step_up)):
            at = lane[sel] + (step is _step_up)
            lb[p, sel], hit[p, sel] = step(table, at, x[p, sel])
        walks = route[p] == 3
        lb[p, walks], hit[p, walks] = find(x[p, walks])
    walked = (route == 3).sum(axis=0)
    for r, group in ((1, ga), (2, gb)):
        grouped = (route == r).any(axis=0)
        walked += grouped
        lb_g = np.zeros(n, np.int64)
        lb_g[grouped] = find(group[grouped])[0]
        for p in range(8):
            sel = route[p] == r
            lb[p, sel], hit[p, sel] = _step_up(table, lb_g[sel], x[p, sel])
    return np.where(hit, count[np.minimum(lb, n - 1)], 0), walked


def k22_transcription(key: np.ndarray, count: np.ndarray, n: int, k: int, canonical: bool):
    """numpy transcription of sibling_maxes_kernel over key[:n] (n = min(spectrum
    n, C), the real lanes under the Spectrum contract): lanes past n are 0;
    each real lane resolves its 8 sibling probes by probe_lane
    (probe_lane_transcription, side "sib"), and each probe's count (0 on a
    miss) goes into the right maximum (even p) or the left one (odd p).
    Returns (rmax, lmax, walks a lane)."""
    C = len(key)
    rmax, lmax = np.zeros(C, np.int32), np.zeros(C, np.int32)
    if n == 0:
        return rmax, lmax, np.zeros(0, np.int64)
    c, walks = probe_lane_transcription(key[:n], count[:n], k, "sib", canonical)
    rmax[:n], lmax[:n] = c[0::2].max(axis=0), c[1::2].max(axis=0)
    return rmax, lmax, walks


def k28_transcription(key: np.ndarray, count: np.ndarray, n: int, k: int, canonical: bool):
    """numpy transcription of neighbor_counts_kernel over key[:n] (the real
    lanes under the Spectrum contract): lanes past n are 0 in all ten rows;
    each real lane resolves its 8 sibling probes as K22 does and its 8
    extension probes by probe_lane with the ext routes
    (probe_lane_transcription, side "ext"), the extension counts stored at
    b * C + i.  Returns (rext [4, C], lext [4, C], rmax, lmax, walks a lane,
    both sides)."""
    C = len(key)
    rext, lext = np.zeros((4, C), np.int32), np.zeros((4, C), np.int32)
    rmax, lmax, sib_walks = k22_transcription(key, count, n, k, canonical)
    if n == 0:
        return rext, lext, rmax, lmax, sib_walks
    e, ext_walks = probe_lane_transcription(key[:n], count[:n], k, "ext", canonical)
    rext[:, :n], lext[:, :n] = e[0::2], e[1::2]
    return rext, lext, rmax, lmax, sib_walks + ext_walks


@pytest.mark.parametrize("k", [5, 16, 17, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_k22_transcription_matches_reference(k, canonical):
    """K22's per-lane resolution, transcribed, equals the JAX package's
    sibling_maxes on tables with n < C, n == C, n == 1, n == 0 and n > C,
    and on palindromes at even k; it walks at most 9 times a lane, and on
    the canonical tables fewer than the 8 searches a lane it replaced."""
    from test_torch_correction import _jax_spectrum

    for name, spec in k22_tables(k, canonical).items():
        key, count = spec.key.numpy(), spec.count.numpy()
        n = min(spec.n, spec.capacity)
        rmax, lmax, walks = k22_transcription(key, count, n, k, canonical)
        want = jspec.sibling_maxes(_jax_spectrum(spec), k, canonical)
        np.testing.assert_array_equal(rmax, np.asarray(want[0]), err_msg=name)
        np.testing.assert_array_equal(lmax, np.asarray(want[1]), err_msg=name)
        assert walks.max(initial=0) <= 9
        if canonical and name in ("sparse", "full"):
            assert walks.mean() < 6, (name, walks.mean())


@pytest.mark.parametrize("k", [5, 13, 16, 17, 24, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_k28_transcription_matches_reference(k, canonical):
    """K28's per-lane resolution, transcribed (K22's sibling routes plus
    K7's ext routes, zeros past the real lanes in all ten rows), equals the
    JAX package's neighbor_counts on tables with n < C, n == C, n == 1,
    n == 0 and n > C, and on palindromes at even k; it walks at most 17
    times a lane (K22's 9 and 8 for the extensions, group walks included),
    and on the canonical tables fewer than the 16 searches a lane it
    replaced."""
    from test_torch_correction import _jax_spectrum

    for name, spec in k22_tables(k, canonical).items():
        key, count = spec.key.numpy(), spec.count.numpy()
        n = min(spec.n, spec.capacity)
        *got, walks = k28_transcription(key, count, n, k, canonical)
        want = jspec.neighbor_counts(_jax_spectrum(spec), k, canonical)
        for g, w, what in zip(got, want, ("right ext", "left ext", "right sib", "left sib")):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{name}: {what}")
        assert walks.max(initial=0) <= 17
        if canonical and name in ("sparse", "full"):
            assert walks.mean() < 16, (name, walks.mean())
