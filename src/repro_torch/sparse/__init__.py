"""Sparse and ragged primitives: embedding bags and segment reductions."""

from .ops import embedding_bag, segment_sum, take_rows  # noqa: F401
