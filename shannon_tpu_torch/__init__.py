"""shannon_tpu_torch — the shannon_tpu assembler ported to PyTorch and CUDA.

The JAX package ``shannon_tpu`` is the reference; this package mirrors its
layout (``ops/{kmers,count,spectrum,correction,condense,tipclip,partition,
thread,sparseflow}.py``, ``components.py``, ``pipeline.py``, ``cli.py``)
and is held to it array by array in ``tests/test_torch_*.py``.

Entry points: ``pipeline.assemble(reads, config, backend=..., device=...,
paired=...)`` in memory, ``pipeline.run_pipeline(config, ..., backend=...,
device=...)`` from files with stage checkpoints, the CLI
``shannon-tpu-torch`` (``cli.py``), and the quality gates
(``python -m shannon_tpu_torch.quality``).  backend="device" runs on one
torch device (the first CUDA card unless the caller asks for the CPU);
backend="oracle" runs the reference's pure-Python oracle on the host.  On
CUDA tensors every device program of the reference is a hand-written
kernel in ``csrc/*.cu`` (K1-K29, ``PERF.md``), built with nvcc at first
use; on CPU tensors their plain PyTorch versions run.

This package imports ``torch`` and never ``jax``, and nothing of
``shannon_tpu``: it owns copies of the reference's framework-free modules
(``config``, ``io``, ``native``, ``oracle``, ``sim``, ``eval`` and
``utils.timing``), each held equal to its source by
``tests/test_torch_imports.py``.
"""

from shannon_tpu_torch.config import AssemblyConfig  # noqa: F401
