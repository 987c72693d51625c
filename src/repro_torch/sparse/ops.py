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

On DTensors (a mesh's sharded layout) :func:`take_rows` and
:func:`segment_sum` keep the work sharded.  A lookup into a table whose
rows are sharded (``Shard(0)``) is a masked gather from each rank's own
rows into a result that is partial over those mesh dimensions, reduced
where the caller asks for a layout (the way DTensor shards
``aten.embedding``): the table is never gathered whole, only the ids are
replicated over the row-sharding dimensions.  A table of fewer rows than a
rank would look up masked is gathered whole first and read locally
(SchNet's node states).  A segment sum over messages sharded along their rows adds each
rank's own messages into a full (num_segments, ...) buffer, a result
partial over the sharding dimensions: the reference's all-reduce that
GSPMD inserts after its ``segment_sum``, never a replication of the
messages.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import shard_range, wrap_local


def _is_row_shard(p) -> bool:
    return isinstance(p, Shard) and p.dim == 0


def _as_dtensor(x, mesh):
    if isinstance(x, DTensor):
        return x
    return wrap_local(x, mesh, (Replicate(),) * mesh.ndim, x.shape)


def _take_rows_sharded(table: DTensor, ids) -> DTensor:
    """:func:`take_rows` of a DTensor table (see the module's docstring)."""
    mesh = table.device_mesh
    ids = _as_dtensor(ids, mesh)
    rows = table.shape[0]
    row_bytes = table.numel() // max(rows, 1) * table.element_size()
    sharded = [_is_row_shard(p) for p in table.placements]
    # rows a rank would read masked: its ids, replicated over the
    # row-sharding dimensions
    looked_up = ids.numel()
    for i, p in enumerate(ids.placements):
        if isinstance(p, Shard) and not sharded[i]:
            looked_up //= mesh.size(i)
    if rows <= looked_up:
        want_t = (Replicate(),) * mesh.ndim     # a small table: gather it
    else:
        want_t = tuple(p if r else Replicate()
                       for p, r in zip(table.placements, sharded))
    if tuple(table.placements) != want_t:
        table = table.redistribute(mesh, want_t)
    row = [_is_row_shard(p) for p in want_t]
    want_i = tuple(Replicate() if r else p
                   for p, r in zip(ids.placements, row))
    if tuple(ids.placements) != want_i:
        ids = ids.redistribute(mesh, want_i)
    # a rank's rows get the gradient of its own ids: partial over the mesh
    # dimensions where the ids differ from rank to rank
    loc = table.to_local(grad_placements=tuple(
        t if r else (Partial() if isinstance(i, Shard) else Replicate())
        for t, i, r in zip(want_t, want_i, row)))
    lo, n = shard_range(rows, mesh, want_t, 0)
    raw = ids.to_local().long()
    raw = torch.where(raw < 0, raw + rows, raw)
    tail = (1,) * (loc.dim() - 1)
    inside = ((raw >= 0) & (raw < rows)).reshape(*raw.shape, *tail)
    cid = raw.clamp(0, rows - 1)
    mine = ((cid >= lo) & (cid < lo + n))
    out = loc[torch.where(mine, cid - lo, 0)]
    if any(row):
        out = torch.where(mine.reshape(*mine.shape, *tail), out, 0)
    if out.requires_grad:
        out.register_hook(lambda g: g * inside)
    out_pl = [Partial() if r else p for p, r in zip(want_i, row)]
    return wrap_local(out, mesh, out_pl, (*ids.shape, *table.shape[1:]))


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with JAX's clamped gather: (*ids.shape, D).  An id
    out of range reads a clamped row and sends it no gradient.  A DTensor
    table is read where its rows lie (see the module's docstring)."""
    if isinstance(table, DTensor):
        return _take_rows_sharded(table, ids)
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
    so nothing waits for the device to count them).  DTensor messages are
    added where they lie (see the module's docstring)."""
    if isinstance(data, DTensor):
        return _segment_sum_sharded(data, segment_ids, num_segments)
    out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, _spare(segment_ids, num_segments),
                          data)[:num_segments]


def _segment_sum_sharded(data: DTensor, segment_ids,
                         num_segments: int) -> DTensor:
    """Each rank's own rows of ``data`` summed into a full buffer: partial
    over the mesh dimensions that shard ``data``'s rows (and over those
    where ``data`` is itself partial), the ids laid out as the rows."""
    mesh = data.device_mesh
    ids = _as_dtensor(segment_ids, mesh)
    want_i = tuple(Shard(0) if _is_row_shard(p) else Replicate()
                   for p in data.placements)
    if tuple(ids.placements) != want_i:
        ids = ids.redistribute(mesh, want_i)
    out = segment_sum(data.to_local(), ids.to_local(), num_segments)
    out_pl = [Partial() if _is_row_shard(p) else p for p in data.placements]
    return wrap_local(out, mesh, out_pl, (num_segments, *data.shape[1:]))


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
