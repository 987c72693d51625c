"""Score-accumulation op (CUDA kernel + plain version)."""

from .ops import score_accumulate  # noqa: F401
