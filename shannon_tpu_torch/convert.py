"""State carried between the two packages: the k-mer table and the
contig/node table.

The reference keeps a k-mer as a ``(hi, lo)`` uint32 pair with the all-ones
pair as padding; the port keeps one int64 key with ``PAD = 2^63 - 1``.
These converters map one to the other so a test can feed one stage's output
from either package into the other's next stage and compare array by
array.  Arrays cross as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from shannon_tpu_torch.ops.condense import ContigArrays
from shannon_tpu_torch.ops.count import Spectrum
from shannon_tpu_torch.ops.kmers import PAD

SENTINEL = 0xFFFFFFFF


def hilo_to_key(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 arrays -> int64 keys; the all-ones pair -> PAD."""
    hi = np.asarray(hi, np.uint32).astype(np.int64)
    lo = np.asarray(lo, np.uint32).astype(np.int64)
    key = (hi << 32) | lo
    key[(hi == SENTINEL) & (lo == SENTINEL)] = PAD
    return key


def key_to_hilo(key) -> tuple[np.ndarray, np.ndarray]:
    """int64 keys (numpy or tensor) -> (hi, lo) uint32; PAD -> all ones."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    key = np.asarray(key, np.int64)
    pad = key == PAD
    hi = ((key >> 32) & SENTINEL).astype(np.uint32)
    lo = (key & SENTINEL).astype(np.uint32)
    hi[pad] = SENTINEL
    lo[pad] = SENTINEL
    return hi, lo


def spectrum_from_numpy(hi, lo, count, n, device="cpu") -> Spectrum:
    """A reference Spectrum's arrays -> the port's Spectrum on `device`."""
    return Spectrum(
        key=torch.from_numpy(hilo_to_key(hi, lo)).to(device),
        count=torch.from_numpy(np.asarray(count, np.int32).copy()).to(device),
        n=int(n),
    )


def spectrum_to_numpy(spec: Spectrum) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The port's Spectrum -> (hi, lo, count int32, n) as the reference
    holds them."""
    hi, lo = key_to_hilo(spec.key)
    return hi, lo, spec.count.cpu().numpy().astype(np.int32), spec.n


def contig_arrays_from_numpy(
    node_hi, node_lo, node_count, node_cid, node_off, klen, abundance,
    count_sum, head_lane, tail_lane, out_edges, rc_pair, n_nodes, n_contigs,
    device="cpu",
) -> ContigArrays:
    """The reference ContigArrays fields, in its field order -> the port's
    ContigArrays on `device`."""

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)

    return ContigArrays(
        node_key=torch.from_numpy(hilo_to_key(node_hi, node_lo)).to(device),
        node_count=t(node_count, np.int32),
        node_cid=t(node_cid, np.int64),
        node_off=t(node_off, np.int64),
        klen=t(klen, np.int64),
        abundance=t(abundance, np.float32),
        count_sum=t(count_sum, np.int64),
        head_lane=t(head_lane, np.int64),
        tail_lane=t(tail_lane, np.int64),
        out_edges=t(out_edges, np.int64),
        rc_pair=t(rc_pair, np.int64),
        n_nodes=int(n_nodes),
        n_contigs=int(n_contigs),
    )


def contig_arrays_to_numpy(ca: ContigArrays) -> tuple:
    """The port's ContigArrays -> the reference's fields in its order and
    dtypes (uint32 node_hi/node_lo, int32 integers, float32 abundance)."""
    node_hi, node_lo = key_to_hilo(ca.node_key)

    def i32(x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy().astype(np.int32)

    return (
        node_hi, node_lo, i32(ca.node_count), i32(ca.node_cid), i32(ca.node_off),
        i32(ca.klen), ca.abundance.cpu().numpy().astype(np.float32),
        i32(ca.count_sum), i32(ca.head_lane), i32(ca.tail_lane),
        i32(ca.out_edges), i32(ca.rc_pair), ca.n_nodes, ca.n_contigs,
    )
