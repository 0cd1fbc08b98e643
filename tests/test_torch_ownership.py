"""Port parity: the evidence-ownership pack and unpack (K26, K27) of
shannon_tpu_torch.parallel.multihost, through their plain versions (the
CPU's), against a numpy transcription of the reference's host pack and
unpack (shannon_tpu/parallel/multihost.py:176-209 and :234-248, which run
only inside a multi-process JAX program): H = 1, 2, 3, 4 and 8 ranks,
empty evidence, single-node paths, every path to one owner, an exchange of
every rank's buckets, and the int32 range checks of route_evidence_ownership.

Tolerance: exact — the [H, cap] int32 send buffer, each bucket's length, and
the unpacked int64 (flat, offs, weights)."""

import numpy as np
import pytest
import torch

from shannon_tpu_torch.parallel import multihost as tmh


def ref_buckets(flat, offs, weights, owner, n_ranks):
    """multihost.py:176-193: one int32 bucket a destination rank."""
    flat, offs, weights = (np.asarray(a, np.int64) for a in (flat, offs, weights))
    lens = np.diff(offs)
    dest_p = np.asarray(owner, np.int64)[flat[offs[:-1]] if len(lens) else np.empty(0, np.int64)]
    buckets = []
    for p in range(n_ranks):
        sel = dest_p == p
        bf = flat[np.repeat(sel, lens)] if len(lens) else flat[:0]
        buckets.append(np.concatenate(
            [np.array([sel.sum(), len(bf)], np.int64), lens[sel], weights[sel], bf]
        ).astype(np.int32))
    return buckets


def ref_send(buckets, cap):
    """multihost.py:201-209 with one device a process: [H, cap], zero past
    each bucket."""
    send = np.zeros((len(buckets), cap), np.int32)
    for p, b in enumerate(buckets):
        send[p, : len(b)] = b
    return send


def ref_unpack(recv):
    """multihost.py:234-248."""
    parts_l, parts_w, parts_f = [], [], []
    for b in recv:
        n_p, n_f = int(b[0]), int(b[1])
        c = 2
        parts_l.append(b[c : c + n_p].astype(np.int64)); c += n_p
        parts_w.append(b[c : c + n_p].astype(np.int64)); c += n_p
        parts_f.append(b[c : c + n_f].astype(np.int64))
    g_lens = np.concatenate(parts_l)
    offs2 = np.zeros(len(g_lens) + 1, np.int64)
    np.cumsum(g_lens, out=offs2[1:])
    return np.concatenate(parts_f), offs2, np.concatenate(parts_w)


def evidence(seed: int, n_paths: int, n_nodes: int, n_ranks: int, case: str):
    """Random evidence of n_paths paths over n_nodes nodes and an owner
    table: 'random' lengths 1-7, 'single' one-node paths, 'skew' every node
    owned by the last rank."""
    rng = np.random.default_rng(seed)
    lens = np.ones(n_paths, np.int64) if case == "single" else rng.integers(1, 8, n_paths)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    flat = rng.integers(0, n_nodes, int(offs[-1])).astype(np.int64)
    weights = rng.integers(1, 1 << 20, n_paths).astype(np.int64)
    owner = rng.integers(0, n_ranks, n_nodes).astype(np.int64)
    if case == "skew":
        owner[:] = n_ranks - 1
    return flat, offs, weights, owner


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64).astype(np.int32))


@pytest.mark.parametrize("n_ranks", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case, n_paths", [
    ("random", 700), ("random", 0), ("random", 1), ("single", 300), ("skew", 400),
])
def test_pack_and_unpack_match_reference(n_ranks, case, n_paths):
    flat, offs, weights, owner = evidence(n_ranks * 7 + n_paths, n_paths, 90, n_ranks, case)
    buckets = ref_buckets(flat, offs, weights, owner, n_ranks)
    cap = max(len(b) for b in buckets)
    send, sizes = tmh.ownership_pack(_t(flat), _t(offs), _t(weights), _t(owner), n_ranks)
    np.testing.assert_array_equal(send.numpy(), ref_send(buckets, cap))
    assert send.dtype == torch.int32
    np.testing.assert_array_equal(sizes.numpy(), [len(b) for b in buckets])
    if case == "skew":
        assert (send[:-1, :2] == 0).all() and int(send[-1, 0]) == n_paths
    for got, want in zip(tmh.ownership_unpack(send), ref_unpack(ref_send(buckets, cap))):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_ranks", [2, 3, 4, 8])
def test_exchange_of_every_ranks_buckets(n_ranks):
    """What rank r receives is row r of every rank's send buffer (padded to
    the widest bucket of all ranks, the agreed cap); its unpack is every
    source's paths for r in source-rank order, as the reference's."""
    ev = [evidence(100 * n_ranks + r, 50 * (r + 1), 60, n_ranks, "random")
          for r in range(n_ranks)]
    widest = max(len(b) for e in ev for b in ref_buckets(*e, n_ranks))
    sends = [tmh.ownership_pack(*(_t(a) for a in e), n_ranks, agree=lambda c: widest)[0]
             for e in ev]
    assert all(s.shape == (n_ranks, widest) for s in sends)
    for r in range(n_ranks):
        recv = torch.stack([s[r] for s in sends])
        want = ref_unpack(np.stack([ref_send(ref_buckets(*e, n_ranks), widest)[r] for e in ev]))
        for got, w in zip(tmh.ownership_unpack(recv), want):
            np.testing.assert_array_equal(got.numpy(), w)


def test_pack_asks_agree_for_the_widest_bucket():
    flat, offs, weights, owner = evidence(3, 40, 20, 3, "random")
    seen = []
    send, sizes = tmh.ownership_pack(_t(flat), _t(offs), _t(weights), _t(owner), 3,
                                     agree=lambda c: seen.append(c) or c + 5)
    assert seen == [int(sizes.max())] and send.shape == (3, seen[0] + 5)
    assert (send[:, seen[0]:] == 0).all()


def test_unpack_refuses_a_header_past_its_row():
    recv = torch.zeros((2, 6), dtype=torch.int32)
    recv[1, :2] = torch.tensor([2, 1])  # 2 + 2 * 2 + 1 > 6
    with pytest.raises(ValueError, match="header"):
        tmh.ownership_unpack(recv)


@pytest.mark.parametrize("bad", ["flat", "weights", "offs"])
def test_route_refuses_the_int32_transport_range(monkeypatch, bad):
    """The range checks run before any collective (a 2-rank world here is
    the patched world(), no process group)."""
    monkeypatch.setattr(tmh, "world", lambda: (0, 2))
    flat, offs, weights, owner = evidence(1, 10, 10, 2, "random")
    if bad == "flat":
        flat = flat.copy()
        flat[3] = 1 << 31
    elif bad == "weights":
        weights = weights.copy()
        weights[0] = 1 << 31
    else:
        offs = offs.copy()
        offs[-1] = 1 << 31
    with pytest.raises(ValueError, match="int32 transport range"):
        tmh.route_evidence_ownership(flat, offs, weights, owner, "cpu")


def test_route_refuses_paths_outside_the_owner_table(monkeypatch):
    monkeypatch.setattr(tmh, "world", lambda: (0, 2))
    flat, offs, weights, owner = evidence(2, 10, 10, 2, "random")
    with pytest.raises(ValueError, match="owner table"):
        tmh.route_evidence_ownership(flat, offs, weights, owner[:5], "cpu")
    with pytest.raises(ValueError, match="owner ranks"):
        tmh.route_evidence_ownership(flat, offs, weights, owner + 2, "cpu")


def test_route_is_the_identity_in_one_process():
    flat, offs, weights, owner = evidence(4, 10, 10, 1, "random")
    got = tmh.route_evidence_ownership(flat, offs, weights, owner, "cpu")
    assert got[0] is flat and got[1] is offs and got[2] is weights
