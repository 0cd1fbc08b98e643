"""Mesh construction (counterpart of ``shannon_tpu/parallel/mesh.py``)."""

from __future__ import annotations

import torch

READS_AXIS = "d"
"""The reference's one mesh axis (read shards / k-mer hash slices); kept for
parity of names: the port's mesh is a plain tuple with no named axis."""

Mesh = tuple[torch.device, ...]


def make_mesh(n_devices: int = 0, device="cuda") -> Mesh:
    """One device per shard.  On CUDA: n = n_devices, or every visible card
    when it is 0; shard i lies on card (base + i) mod count, base being the
    index of `device`, so shards beyond the cards share them round robin
    (the reference caps n at its visible devices).  On the CPU: n_devices
    shards (1 when it is 0), all on the CPU, as the reference's tests run
    on virtual CPU devices."""
    if n_devices < 0:
        raise ValueError(f"n_devices={n_devices} must be >= 0")
    device = torch.device(device)
    if device.type != "cuda":
        return (device,) * (n_devices or 1)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f"device {device} was asked for, but torch sees no CUDA device")
    base = device.index or 0
    return tuple(torch.device("cuda", (base + i) % count) for i in range(n_devices or count))
