# Copied from shannon_tpu/utils/__init__.py; equal to it apart from this line and the package name in imports.
"""Cross-cutting utilities: stage timing/observability and stage
checkpointing (reference: per-stage wall-clock log + files-as-checkpoints
resume — SURVEY.md §6)."""

from shannon_tpu_torch.utils.timing import StageTimer  # noqa: F401
