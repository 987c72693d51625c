"""Two-tower candidate scoring op (CUDA kernel + plain version)."""

from .ops import candidate_scores  # noqa: F401
