"""shannon_tpu_torch — the shannon_tpu assembler ported to PyTorch and CUDA.

The JAX package ``shannon_tpu`` is the reference; this package mirrors its
layout (``ops/{kmers,count,spectrum,correction,condense,tipclip,partition,
thread,sparseflow}.py``, ``components.py``, ``pipeline.py``) and is held to
it array by array in ``tests/test_torch_*.py``.

Main path: ``shannon_tpu_torch.pipeline.assemble(reads, config,
device=...)``, single-end on one device.  On CUDA tensors the k-mer
extraction (K1), sorted-run reduction (K2) and sorted-table lookup (K3) are
hand-written kernels in ``csrc/kernels.cu``, built with nvcc at first use;
on CPU tensors their plain PyTorch versions run.

This package imports ``torch`` and never ``jax``.  From ``shannon_tpu`` it
uses only the framework-free modules: ``config``, ``io``, ``oracle``,
``sim``, ``eval`` and ``utils.timing``.
"""

from shannon_tpu.config import AssemblyConfig  # noqa: F401
