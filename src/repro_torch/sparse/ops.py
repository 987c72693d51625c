"""Embedding bags and segment sums, as the JAX package computes them.

The reference builds EmbeddingBag from a gather and segment reductions
(``src/repro/sparse/ops.py``); the port keeps its two calling conventions
and its gather semantics, which differ from PyTorch's indexing:

* a JAX gather clamps an out-of-range id instead of raising: an id ≥ rows
  reads the last row, and a negative id counts from the end (and clamps to
  row 0 below -rows).  Its gradient, XLA's scatter-add, drops the update of
  an id that is still out of range after the count from the end.
  :func:`take_rows` does both, so a lookup past the table computes what
  the reference computes, forward and backward (a CUDA gather would
  otherwise assert on the card);
* ``jax.ops.segment_sum`` drops elements whose segment id is out of range;
  :func:`segment_sum` does too.
"""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with JAX's clamped gather: (*ids.shape, D).  An id
    out of range reads a clamped row and sends it no gradient."""
    rows = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + rows, ids)
    out = table[ids.clamp(0, rows - 1)]
    if out.requires_grad:
        inside = ((ids >= 0) & (ids < rows)).unsqueeze(-1)
        out.register_hook(lambda g: g * inside)
    return out


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of ``data``'s rows by segment id into ``num_segments`` rows;
    out-of-range ids are dropped."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids[keep], data[keep])


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor | None = None,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """torch.nn.EmbeddingBag's function in the reference's two forms:

    * ``ids`` (B, L) fixed-size bags (``weights`` (B, L) masks ragged
      bags) -> (B, D); ``mean`` divides by the weights' sum, ``max`` takes
      the largest weighted row;
    * ``ids`` (M,) flat with ``offsets`` (B,) bag starts -> (B, D); ``mean``
      divides by the bag's element count, ``max`` takes the largest weighted
      row of each bag (an empty bag gives zeros, as torch's EmbeddingBag).
      The reference's flat form returns the bag sum for ``max``; the port
      gives the maximum its docstring promises.
    """
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    rows = take_rows(table, ids)
    if offsets is None:
        if weights is not None:
            rows = rows * weights[..., None]
        if mode == "sum":
            return rows.sum(dim=-2)
        if mode == "max":
            return rows.amax(dim=-2)
        if weights is None:
            return rows.mean(dim=-2)
        den = torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
        return rows.sum(dim=-2) / den
    m, nbags = ids.shape[0], offsets.shape[0]
    bag = torch.searchsorted(offsets.to(torch.int64),
                             torch.arange(m, device=ids.device),
                             right=True) - 1
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "max":
        keep = bag >= 0
        out = torch.zeros((nbags, table.shape[1]), dtype=rows.dtype,
                          device=rows.device)
        idx = bag[keep, None].expand(-1, table.shape[1])
        return out.scatter_reduce_(0, idx, rows[keep], "amax",
                                   include_self=False)
    out = segment_sum(rows, bag, nbags)
    if mode == "mean":
        cnt = segment_sum(torch.ones(m, dtype=table.dtype, device=ids.device),
                          bag, nbags)
        out = out / torch.clamp(cnt, min=1)[:, None]
    return out
