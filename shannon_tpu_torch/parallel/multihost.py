"""Multi-process assembly on ``torch.distributed`` (counterpart of
``shannon_tpu/parallel/multihost.py``).

One process a rank, launched by torchrun
(``python -m torch.distributed.run --nproc-per-node N -m
shannon_tpu_torch.cli ...``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
Each rank ingests its own contiguous slice of the input (``host_byte_range``,
``host_read_slice``), so rank order is read order.  Counting is one shard a
rank (``count_reads_spectrum_multihost``: the per-shard half of the sharded
count, an ``all_to_all_single`` of the owner buckets, each owner's merge and
an ``all_gather`` of the slices), and every rank continues on the same
replicated spectrum; the graph stages are deterministic, so every rank
builds the same graph.  The back half either gathers all evidence to every
rank (``gather_evidence``, 'replicate') or routes each path to the rank that
owns its component (``route_evidence_ownership``, 'ownership': kernels K26
and K27 around an ``all_to_all_single``) and gathers the transcripts
(``gather_transcripts``).

Collective tensors live where the backend takes them (``_for_backend``).
Every rank makes the same collective calls in the same order, whatever its
share of the data: an empty bucket is still sent, a rank with no reads still
counts its empty batches.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from shannon_tpu_torch import kernels
from shannon_tpu_torch.ops.count import Spectrum, merge_batch, upload_words
from shannon_tpu_torch.ops.kmers import extract_kmers_packed
from shannon_tpu_torch.parallel.distributed import (
    default_bucket_cap,
    gathered_spectrum,
    owner_slice,
    sharded_tail,
)

# The most ranks K26 and K27 take (MAX_RANKS in csrc/multihost.cu).
MAX_RANKS = 512
# Paths a tile of K26 (PACK_TILE in csrc/multihost.cu; the entry points
# refuse a scratch sized for any other tile).
_PACK_TILE = 2048
_INT32_RANGE = 1 << 31


# ---- process group -----------------------------------------------------------


def backend_for(device, local_world_size: int, n_cards: int) -> str:
    """The process group's backend, by one fixed rule: gloo on the CPU (as
    the reference picks gloo for its CPU collectives); gloo where a node's
    ranks outnumber its visible cards (NCCL refuses two ranks on one card,
    so they share it over gloo); nccl otherwise, rank r on card LOCAL_RANK."""
    if torch.device(device).type != "cuda" or local_world_size > n_cards:
        return "gloo"
    return "nccl"


def init_distributed(device="cuda") -> bool:
    """Join the process group torchrun describes in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), with
    the backend of :func:`backend_for`; on CUDA the rank's card
    (LOCAL_RANK mod the visible cards) becomes its current device.  Returns
    world_size > 1.  A no-op without that environment, and in a process
    that has joined already.  A failed init raises: nothing retries on
    another backend, and nothing carries on in one process."""
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        device = torch.device(device)
        n_cards = 0
        if device.type == "cuda":
            n_cards = torch.cuda.device_count()
            if n_cards == 0:
                raise RuntimeError(f"device {device} was asked for, but torch sees no CUDA device")
            torch.cuda.set_device(local_rank % n_cards)
        dist.init_process_group(
            backend_for(device, local_size, n_cards),
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=rank,
            world_size=size,
            timeout=timedelta(minutes=10),
        )
    return dist.get_world_size() > 1


def leave_distributed() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None


def _for_backend(t: torch.Tensor) -> torch.Tensor:
    """`t` where the backend takes collective tensors.  nccl takes them on
    the rank's card alone, so a host tensor is copied there.  gloo takes
    host and CUDA tensors alike in every collective used here
    (all_gather_into_tensor, all_to_all_single, all_reduce; checked on an
    H100 with torch 2.11), staging a CUDA tensor through the host itself, so
    `t` stays where it is."""
    if dist.get_backend() == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """[H * n, ...]: every rank's [n, ...] tensor in rank order."""
    t = _for_backend(t.contiguous())
    out = torch.empty((world()[1] * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t)
    return out


def _all_to_all(t: torch.Tensor) -> torch.Tensor:
    """[H, ...]: row s of the result is row `rank` of rank s's tensor (row p
    of `t` goes to rank p)."""
    if t.shape[0] != world()[1]:
        raise ValueError(f"all_to_all of {t.shape[0]} rows in a group of {world()[1]} ranks")
    t = _for_backend(t.contiguous())
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t)
    return out


def max_over_ranks(x: int) -> int:
    """The largest of every rank's x (all_reduce(MAX))."""
    t = _for_backend(torch.tensor([x], dtype=torch.int64))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


# ---- host helpers --------------------------------------------------------------


# copied from shannon_tpu/parallel/multihost.py:50 (jax.process_* -> world())
def host_byte_range(path: str | os.PathLike) -> tuple[int, int]:
    """This rank's byte range of an (uncompressed) input file: an equal byte
    split of [0, file_size) over the ranks.  With
    native.pack_file_range's contract (a record belongs to the range holding
    its header byte), every record lands on exactly one rank, and ranks hold
    ascending ranges."""
    size = os.path.getsize(path)
    p, n = world()
    return p * size // n, (p + 1) * size // n


# copied from shannon_tpu/parallel/multihost.py:434 (jax.process_* -> world())
def host_read_slice(n_records: int) -> slice:
    """The record range this rank ingests: a contiguous slice of the input,
    pair-aligned (even boundaries) so mates stay on one rank."""
    p, n = world()
    per = -(-n_records // n)
    per += per % 2  # pair alignment
    start = min(p * per, n_records)
    stop = min(start + per, n_records)
    return slice(start, stop)


def allgather_ragged(a: np.ndarray) -> np.ndarray:
    """Every rank's array (axis 0 may differ by rank) concatenated in rank
    order, on every rank (multihost.py:68): gather the lengths, pad to the
    longest, gather, trim."""
    a = np.ascontiguousarray(a)
    ns = _all_gather(torch.tensor([a.shape[0]], dtype=torch.int64)).tolist()
    pad = np.zeros((max(ns),) + a.shape[1:], a.dtype)
    pad[: a.shape[0]] = a
    g = _all_gather(torch.from_numpy(pad)).cpu().numpy().reshape((len(ns),) + pad.shape)
    return np.concatenate([g[p, :n] for p, n in enumerate(ns)], axis=0)


def gather_evidence(flat, offs, weights):
    """Every rank's threading evidence (flat node ids, row offsets, weights)
    concatenated in rank order, on every rank (multihost.py:88).  Ranks hold
    ascending ranges of the input, so rank order is read order, and
    first-occurrence dedup sees what one process sees."""
    if world()[1] == 1:
        return flat, offs, weights
    lens = np.diff(np.asarray(offs, np.int64))
    g_flat = allgather_ragged(np.asarray(flat, np.int64))
    g_lens = allgather_ragged(lens)
    g_w = allgather_ragged(np.asarray(weights, np.int64))
    offs2 = np.zeros(len(g_lens) + 1, np.int64)
    np.cumsum(g_lens, out=offs2[1:])
    return g_flat, offs2, g_w


def gather_transcripts(transcripts):
    """Every rank's transcripts in rank order (multihost.py:261): the
    ownership back half assembles disjoint sets of components, and the
    final dedupe of the union does not depend on its order."""
    from shannon_tpu_torch.oracle.assemble import Transcript

    if world()[1] == 1:
        return transcripts
    seqs = np.frombuffer("".join(t.seq for t in transcripts).encode("ascii"), np.uint8)
    lens = np.array([len(t.seq) for t in transcripts], np.int64)
    abunds = np.array([t.abundance for t in transcripts], np.float64)
    blob = allgather_ragged(seqs).tobytes().decode("ascii")
    out, pos = [], 0
    for n, a in zip(allgather_ragged(lens).tolist(), allgather_ragged(abunds).tolist()):
        out.append(Transcript(seq=blob[pos : pos + n], abundance=a))
        pos += n
    return out


def allreduce_stats(*vals: int) -> list[int]:
    """Sums of small per-rank integer stats over the ranks."""
    if world()[1] == 1:
        return list(vals)
    t = _for_backend(torch.tensor(vals, dtype=torch.int64))
    dist.all_reduce(t)
    return t.tolist()


def localize_spectrum(spec: Spectrum, device) -> Spectrum:
    """The replicated spectrum moved onto this rank's device, where the
    stages after the count run (multihost.py:305)."""
    return Spectrum(key=spec.key.to(device), count=spec.count.to(device), n=spec.n)


# ---- counting ------------------------------------------------------------------


def count_reads_spectrum_multihost(
    batch,
    k: int = 24,
    capacity: int = 1 << 22,
    canonical: bool = True,
    batch_reads: int = 1 << 16,
    device="cuda",
    bucket_cap: int | None = None,
) -> tuple[Spectrum, bool]:
    """The sharded count with one shard a rank (multihost.py:325
    count_reads_spectrum_multihost): each rank counts its own read slice
    (`batch`) in batches of batch_reads rows.  Per batch, each rank runs the
    per-shard half (K1, torch.sort, K2, then K25's owner buckets, D = world
    size); all_to_all_single delivers row j of every rank's buckets to rank
    j; each owner sorts and sums them (K2); all_gather brings every owner's
    slice to every rank, where the sorted gather is the batch's table.
    Batches merge on K17, as in count_reads_spectrum_sharded.  Returns the
    replicated spectrum on `device` and the overflow flag, up on every rank
    where any rank's bucket or owner slice outgrew bucket_cap or the gather
    outgrew capacity (an all_reduce(MAX): the port's flag covers every
    shard, the reference's shard 0's alone)."""
    _, n_ranks = world()
    if bucket_cap is None:
        bucket_cap = default_bucket_cap(capacity, n_ranks)
    # Every rank must make the same collective calls in the same order (the
    # torch form of the reference's "program structure must agree"), so the
    # batch count is the largest over the ranks: a rank past its reads
    # counts empty batches.
    n_local = batch.n_reads
    n_batches = max(1, -(-max_over_ranks(n_local) // batch_reads))
    total, overflowed = None, False
    for b in range(n_batches):
        s = min(b * batch_reads, n_local)
        e = min(s + batch_reads, n_local)
        m = batch.mask_rows(s, e)
        keys, _ = extract_kmers_packed(
            upload_words(batch.words[s:e], device),
            torch.from_numpy(batch.lengths[s:e]).to(device),
            k, canonical, batch.pad_length,
            None if m is None else upload_words(m, device),
        )
        b_key, b_count, flag = sharded_tail(keys, n_ranks, capacity, bucket_cap)
        r_key = _all_to_all(b_key).to(device)
        r_count = _all_to_all(b_count).to(device)
        key, count, n = owner_slice(r_key.reshape(-1), r_count.reshape(-1), bucket_cap)
        ns = _all_gather(torch.tensor([n], dtype=torch.int64)).tolist()
        n_real = sum(min(x, bucket_cap) for x in ns)
        part = gathered_spectrum(_all_gather(key).to(device), _all_gather(count).to(device),
                                 n_real, capacity)
        overflowed |= bool(flag) or n > bucket_cap or n_real > capacity
        total = merge_batch(total, part)
    return total, max_over_ranks(int(overflowed)) > 0


# ---- K26 / K27: the evidence-ownership pack and unpack ---------------------------


def _local_cap(x: int) -> int:
    """cap outside a process group: the widest local bucket."""
    return x


def ownership_pack_plain(flat, offs, weights, owner, n_ranks: int, agree=_local_cap):
    """Plain PyTorch K26, as the reference packs (multihost.py:176-209): per
    destination p, the boolean selection of the paths whose head node p
    owns, their flat ids by repeat_interleave, one int32 row [n_paths,
    n_flat, lens, weights, flat].  Returns (send [H, cap] int32, zero past
    each bucket; each bucket's length, int64 [H])."""
    lens = offs[1:] - offs[:-1]
    dest = owner[flat[offs[:-1]]].long()
    sel = [dest == p for p in range(n_ranks)]
    n_paths = torch.stack([s.sum() for s in sel])
    n_flat = torch.stack([lens[s].sum() for s in sel]).to(torch.int64)
    sizes = 2 + 2 * n_paths + n_flat
    cap = agree(int(sizes.max()))
    send = torch.zeros((n_ranks, cap), dtype=torch.int32, device=flat.device)
    for p, s in enumerate(sel):
        bucket = torch.cat([
            torch.stack([n_paths[p], n_flat[p]]).to(torch.int32),
            lens[s], weights[s], flat[torch.repeat_interleave(s, lens)],
        ])
        send[p, : bucket.shape[0]] = bucket
    return send, sizes


def _ownership_pack_cuda(flat, offs, weights, owner, n_ranks, agree):
    for name, t in (("flat", flat), ("offs", offs), ("weights", weights), ("owner", owner)):
        kernels.check_cuda(name, t, torch.int32, 1)
    P = offs.shape[0] - 1
    if weights.shape[0] != P:
        raise ValueError("offs and weights disagree on the path count")
    if not 1 <= n_ranks <= MAX_RANKS:
        raise ValueError(f"n_ranks={n_ranks} is outside 1..{MAX_RANKS}")
    dev = flat.device
    # the [2H, tiles] counts (then starts), n_paths [H], n_flat [H], then a
    # uint16 destination a path
    scratch = torch.empty(2 * n_ranks * -(-P // _PACK_TILE) + 2 * n_ranks + (P + 1) // 2,
                          dtype=torch.int32, device=dev)
    sizes = torch.empty(n_ranks, dtype=torch.int64, device=dev)
    lib = kernels.library()
    lib.call(
        "shannon_ownership_counts", dev,
        kernels.ptr(flat), kernels.ptr(offs), P, kernels.ptr(owner), n_ranks,
        kernels.ptr(scratch), scratch.shape[0], kernels.ptr(sizes),
    )
    host = sizes.cpu()  # the one read from the device
    widest = int(host.numpy().max())
    cap = agree(widest)
    if cap < widest:
        raise ValueError(f"cap {cap} is below the widest bucket, {widest} words")
    send = torch.empty((n_ranks, cap), dtype=torch.int32, device=dev)
    lib.call(
        "shannon_ownership_scatter", dev,
        kernels.ptr(flat), kernels.ptr(offs), kernels.ptr(weights), P, n_ranks,
        kernels.ptr(scratch), scratch.shape[0], kernels.ptr(sizes), kernels.ptr(host), cap,
        kernels.ptr(send),
    )
    lib.count("ownership_pack")
    return send, sizes


def ownership_pack(flat, offs, weights, owner, n_ranks: int, agree=_local_cap):
    """Pack a rank's evidence (int32 flat node ids, row offsets, weights, and
    the owner rank of each node, all on one device) into the per-rank
    buckets of the ownership exchange: (send [H, cap] int32, row p =
    [n_paths, n_flat, lens, weights, flat] of the paths whose head node
    rank p owns, in source-local order, zero-padded; each bucket's length,
    int64 [H]).  `agree` maps the widest local bucket to cap: the
    all_reduce(MAX) over the ranks in a process group, the identity
    otherwise.  Kernel K26 on CUDA (a count and an offsets launch, one
    host read of the sizes, `agree`, one write launch), the plain version
    on CPU.  Inputs are not range-checked here: the
    caller checks them on the host (route_evidence_ownership)."""
    if flat.is_cuda:
        return _ownership_pack_cuda(flat, offs, weights, owner, n_ranks, agree)
    return ownership_pack_plain(flat, offs, weights, owner, n_ranks, agree)


def _check_headers(hdr, cap: int) -> None:
    """Each (n_paths, n_flat) header on the host (an int64 [H, 2] tensor or
    numpy array) must fit its row of cap."""
    if bool((hdr < 0).any()) or bool((2 + 2 * hdr[:, 0] + hdr[:, 1] > cap).any()):
        raise ValueError("a received bucket's header does not fit its row")


def ownership_unpack_plain(recv: torch.Tensor):
    """Plain PyTorch K27, as the reference unpacks (multihost.py:234-248):
    source by source, the lens, weights and flat of each row, concatenated
    in source-rank order.  Returns int64 (flat, offs, weights)."""
    hdr = recv[:, :2].to(torch.int64).cpu()
    _check_headers(hdr, recv.shape[1])
    parts = []
    for row, (n_p, n_f) in zip(recv.to(torch.int64), hdr.tolist()):
        parts.append((row[2 : 2 + n_p], row[2 + n_p : 2 + 2 * n_p],
                      row[2 + 2 * n_p : 2 + 2 * n_p + n_f]))
    lens = torch.cat([p[0] for p in parts])
    offs = torch.zeros(lens.shape[0] + 1, dtype=torch.int64, device=recv.device)
    torch.cumsum(lens, 0, out=offs[1:])
    return torch.cat([p[2] for p in parts]), offs, torch.cat([p[1] for p in parts])


def _ownership_unpack_cuda(recv: torch.Tensor):
    kernels.check_cuda("recv", recv, torch.int32, 2)
    n_ranks, cap = recv.shape
    if n_ranks > MAX_RANKS:
        raise ValueError(f"{n_ranks} source ranks exceed {MAX_RANKS}")
    if cap < 2:
        raise ValueError("a received bucket's header does not fit its row")
    dev = recv.device
    lib = kernels.library()
    hdr = torch.empty((n_ranks, 2), dtype=torch.int32, pin_memory=True)
    lib.call("shannon_ownership_headers", dev, kernels.ptr(recv), n_ranks, cap, kernels.ptr(hdr))
    torch.cuda.current_stream(dev).synchronize()  # the one read from the device
    hdr = hdr.numpy().astype(np.int64)
    _check_headers(hdr, cap)
    n_paths, n_flat = (int(x) for x in hdr.sum(0))
    flat = torch.empty(n_flat, dtype=torch.int64, device=dev)
    offs = torch.empty(n_paths + 1, dtype=torch.int64, device=dev)
    weights = torch.empty(n_paths, dtype=torch.int64, device=dev)
    scratch = kernels.scan_scratch(n_paths, dev)
    lib.call(
        "shannon_ownership_unpack", dev,
        kernels.ptr(recv), n_ranks, cap, n_paths, n_flat, kernels.ptr(scratch),
        scratch.shape[0], kernels.ptr(flat), kernels.ptr(offs), kernels.ptr(weights),
    )
    lib.count("ownership_unpack")
    return flat, offs, weights


def ownership_unpack(recv: torch.Tensor):
    """The evidence an exchange delivered ([H, cap] int32, row s from rank
    s) as int64 (flat, offs, weights), concatenated in source-rank order.
    Kernel K27 on CUDA (one host read of the headers, one launch over the
    rows' real words), the plain version on CPU."""
    if recv.shape[0] == 0:
        raise ValueError("unpack of an exchange with no ranks")
    if recv.is_cuda:
        return _ownership_unpack_cuda(recv)
    return ownership_unpack_plain(recv)


def route_evidence_ownership(flat, offs, weights, owner_of_node, device, volumes=None):
    """Route each evidence path to the rank that owns its component
    (multihost.py:115): owner_of_node[v] is the rank that assembles node v's
    component (the same table on every rank), and a path never leaves its
    component, so its head node decides.  K26 packs the buckets on
    `device`, all_to_all_single exchanges them (row p goes to rank p of the
    world group), K27 unpacks what arrived.  Returns this rank's (flat,
    offs, weights) as int64 numpy arrays, in (source rank, source-local
    order): rank order is read order, so dedup's first occurrence and every
    tie-break match one process.

    `volumes`, if given, receives the reference's measured volumes:
    ownership_sent_bytes (the real buckets sent to other ranks),
    ownership_padded_bytes (the padded send buffer), replicate_equiv_bytes
    (what gather_evidence would send: H - 1 times the local evidence),
    owned_paths and local_paths."""
    rank, n_ranks = world()
    if n_ranks == 1:
        return flat, offs, weights
    flat = np.asarray(flat, np.int64)
    offs = np.asarray(offs, np.int64)
    weights = np.asarray(weights, np.int64)
    owner = np.asarray(owner_of_node, np.int64)
    if (flat.max(initial=0) >= _INT32_RANGE or weights.max(initial=0) >= _INT32_RANGE
            or offs[-1] >= _INT32_RANGE):
        raise ValueError("evidence exceeds int32 transport range")
    lens = np.diff(offs)
    if (lens < 1).any() or flat.min(initial=0) < 0 or flat.max(initial=-1) >= len(owner):
        raise ValueError("evidence paths must be non-empty and name nodes of the owner table")
    if owner.min(initial=0) < 0 or owner.max(initial=0) >= n_ranks:
        raise ValueError(f"owner ranks must lie in [0, {n_ranks})")

    # Buckets go by explicit rank: row p of the send buffer is rank p's, and
    # all_to_all_single delivers it there, in the world group.

    def up(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    send, sizes = ownership_pack(up(flat), up(offs), up(weights), up(owner), n_ranks,
                                 agree=max_over_ranks)
    g_flat, g_offs, g_w = (
        t.cpu().numpy() for t in ownership_unpack(_all_to_all(send).to(device))
    )
    if volumes is not None:
        sizes = sizes.cpu()
        volumes.update(
            ownership_sent_bytes=4 * int(sizes.sum() - sizes[rank]),
            ownership_padded_bytes=send.numel() * send.element_size(),
            replicate_equiv_bytes=(n_ranks - 1) * 4 * (len(flat) + 2 * len(lens)),
            owned_paths=len(g_w),
            local_paths=len(lens),
        )
    return g_flat, g_offs, g_w
