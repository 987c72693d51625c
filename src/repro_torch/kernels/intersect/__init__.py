"""Sorted-list membership op (CUDA kernel + plain version)."""

from .ops import intersect_sorted  # noqa: F401
