"""shannon_tpu_torch — the shannon_tpu assembler ported to PyTorch and CUDA.

The JAX package ``shannon_tpu`` is the reference; this package mirrors its
layout (``ops/{kmers,count,spectrum,correction,condense,tipclip,partition,
thread,sparseflow}.py``, ``components.py``, ``pipeline.py``, ``cli.py``)
and is held to it array by array in ``tests/test_torch_*.py``.

Entry points, all on one device: ``pipeline.assemble(reads, config,
device=..., paired=...)`` in memory, ``pipeline.run_pipeline(config, ...,
device=...)`` from files with stage checkpoints, and the CLI
``shannon-tpu-torch`` (``cli.py``).  On CUDA tensors the k-mer extraction
(K1), sorted-run reduction (K2), sorted-table lookup (K3), threading run
scan (K4) and compaction (K5) and the sparse-flow solver (K6) are
hand-written kernels in ``csrc/*.cu``, built with nvcc at first use; on CPU
tensors their plain PyTorch versions run.

This package imports ``torch`` and never ``jax``.  From ``shannon_tpu`` it
uses only the framework-free modules: ``config``, ``io``, ``oracle``,
``sim``, ``eval`` and ``utils.timing``.
"""

from shannon_tpu.config import AssemblyConfig  # noqa: F401
