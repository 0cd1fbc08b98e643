"""Multi-device counting (counterpart of ``shannon_tpu/parallel``).

One process drives every shard, as the reference's single controller drives
its mesh through ``shard_map``: a mesh is a tuple of ``torch.device``s, one
per shard, and the reference's collectives become tensor copies between
them.  Shards beyond the visible cards share a card (``make_mesh``).
"""

from shannon_tpu_torch.parallel.distributed import count_spectrum_sharded  # noqa: F401
from shannon_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
