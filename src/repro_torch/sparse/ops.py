"""Embedding bags and segment reductions, as the JAX package computes them.

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
* ``jax.ops.segment_sum`` and ``segment_max`` drop elements whose segment
  id is out of range; :func:`segment_sum` and :func:`segment_max` do too,
  and so do :func:`segment_mean` and :func:`segment_softmax`, built on
  them as the reference builds its own.

:func:`coalesce_edges` sorts edges by an exact int64 key.  The
reference's key, ``dst.astype(jnp.int64) * n + src``, is int32 while JAX's
x64 mode is off (its default) and wraps once ``dst * n`` reaches 2**31, so
its order is not sorted by destination there; below that the two orders
are equal.
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
        inside = ((ids >= 0) & (ids < rows)).reshape(
            *ids.shape, *(1,) * (table.dim() - 1))
        out.register_hook(lambda g: g * inside)
    return out


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of ``data``'s rows by segment id into ``num_segments`` rows;
    out-of-range ids are dropped (added into a spare row that is cut off,
    so nothing waits for the device to count them)."""
    out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, _spare(segment_ids, num_segments),
                          data)[:num_segments]


def _spare(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_ids`` as int64 with every out-of-range id replaced by
    ``num_segments``, the spare row."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    return torch.where(keep, ids, num_segments)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Maximum of ``data``'s rows by segment id into ``num_segments`` rows,
    as ``jax.ops.segment_max``: an empty segment holds the dtype's identity
    (-inf for floats, the least int for ints), out-of-range ids are
    dropped, and where several elements tie for a maximum its gradient is
    split evenly among them (torch's ``amax`` does as JAX does)."""
    ident = (-torch.inf if data.dtype.is_floating_point
             else torch.iinfo(data.dtype).min)
    out = torch.full((num_segments + 1, *data.shape[1:]), ident,
                     dtype=data.dtype, device=data.device)
    idx = _spare(segment_ids, num_segments).reshape(
        -1, *(1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax",
                              include_self=False)[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean of ``data``'s rows by segment id: the segment sum over
    ``max(count, 1)``, so an empty segment holds 0."""
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones(segment_ids.shape, dtype=data.dtype,
                                 device=data.device),
                      segment_ids, num_segments)
    cnt = torch.clamp(cnt, min=1)
    return tot / cnt[..., None] if data.dim() > 1 else tot / cnt


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within each segment (GAT's edge
    softmax).  The segment maxima and sums are read back through
    :func:`take_rows`, JAX's clamped gather, and the denominator is clamped
    at 1e-20, as in the reference."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    ex = torch.exp(logits - take_rows(seg_max, segment_ids))
    den = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(take_rows(den, segment_ids), min=1e-20)


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


def coalesce_edges(src: torch.Tensor, dst: torch.Tensor, n: int):
    """Edges sorted by destination, then source, for locality: ``(src,
    dst, order)``.  The key ``dst * n + src`` is int64 for any ``n`` (see
    the module's docstring) and the sort is stable."""
    key = dst.long() * n + src.long()
    order = torch.argsort(key, stable=True)
    return src[order], dst[order], order
