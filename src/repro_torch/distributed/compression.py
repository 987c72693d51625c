"""Gradient compression for the cross-pod all-reduce: int8 with error
feedback.

Ported from the JAX package's ``src/repro/distributed/compression.py``.
The "pod" axis crosses the slowest links, so gradients are quantized to
int8 with a per-tensor scale before the cross-pod reduction, and the
quantization error is fed back into the next step (the EF-SGD and 1-bit
Adam lineage: the error buffer keeps the compressed optimizer unbiased in
the long run).  compress -> all-reduce (int8 summed as int32) ->
decompress moves a quarter of float32's bytes over the pod links.

``x / scale`` and the rounding are exact IEEE operations in both
frameworks, and ``torch.round`` rounds half to even as ``jnp.round``
does, so :func:`compress_int8` gives the reference's ``q`` and scale bit
for bit.  Trees are walked by ``tree.py`` in JAX's order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import tree


class ErrorFeedback(NamedTuple):
    residual: object  # same tree structure as grads


def ef_init(grads_like) -> ErrorFeedback:
    return ErrorFeedback(residual=tree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compress_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _ef_pairs(grads, ef: ErrorFeedback):
    """(the ``(q, scale)`` pairs in flatten order, the treedef, the new
    ErrorFeedback)."""
    flat, treedef = tree.flatten(grads)
    corrected = [g.to(torch.float32) + r
                 for g, r in zip(flat, tree.leaves(ef.residual))]
    pairs = [compress_int8(c) for c in corrected]
    residual = [c - decompress_int8(*qs) for c, qs in zip(corrected, pairs)]
    return pairs, treedef, ErrorFeedback(
        residual=tree.unflatten(treedef, residual))


def ef_compress_tree(grads, ef: ErrorFeedback):
    """Apply error feedback then quantize every leaf.

    Returns (the tree of ``(q, scale)`` pairs, the new ErrorFeedback)."""
    pairs, treedef, ef = _ef_pairs(grads, ef)
    return tree.unflatten(treedef, pairs), ef


def psum_compressed(grads, group, ef: ErrorFeedback):
    """Compressed mean-reduce of ``grads`` over the process group ``group``
    (None: the default group), the reference's ``psum_compressed`` inside
    ``shard_map`` over one mesh axis.

    int8 payloads are summed in int32 (no overflow for groups smaller than
    2**23), scales are averaged: an upper-bound reconstruction matching
    EF-SGD.  Returns (the mean tree, float32, the new ErrorFeedback)."""
    pairs, treedef, ef = _ef_pairs(grads, ef)
    n = float(dist.get_world_size(group))
    out = []
    for q, s in pairs:
        tot = q.to(torch.int32)
        dist.all_reduce(tot, group=group)
        s_sum = s.reshape(1).clone()
        dist.all_reduce(s_sum, group=group)
        s_mean = s_sum.reshape(()) / n
        out.append((tot.to(torch.float32) * s_mean) / n)
    return tree.unflatten(treedef, out), ef
