"""Tensor stages of the port (counterparts of shannon_tpu/ops)."""
