"""Sparse and ragged primitives: embedding bags and segment reductions."""

from .ops import (coalesce_edges, embedding_bag, segment_max,  # noqa: F401
                  segment_mean, segment_softmax, segment_sum, take_rows)
