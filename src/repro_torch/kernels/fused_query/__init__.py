"""Fused decode→score→top-k query op (CUDA kernel + plain version)."""

from .ops import FUSED_MODES, fused_query  # noqa: F401
