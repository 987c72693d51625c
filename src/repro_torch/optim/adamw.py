"""Optimizers over pytrees of tensors, updated in place.

Ported from the JAX package's ``src/repro/optim/adamw.py``: AdamW with
decoupled weight decay and global-norm clipping, and row-wise Adagrad for
huge embedding tables (one float32 scalar of state per row).  The states
are NamedTuples of tensors laid out as the parameters, so the checkpoint
manager saves them beside the parameters in the reference's leaf order.

What differs from the reference, and why:

* **In place.**  :func:`adamw_update` and :func:`row_adagrad_update` write
  the new parameters and moments into the tensors they are given and
  return those same tensors.  A functional update of llama3.2-3b at full
  width would need a second copy of the parameters and the float32 moments
  (7.2 + 28.9 GB) that the card does not have.
* **A slice at a time.**  Each leaf is updated in slices of at most
  ``SLICE`` elements for its device (a layer of a stacked (L, ...) leaf,
  or a block of an embedding's rows), so the float32 temporaries of the
  update stay a slice's size.  The arithmetic is elementwise, so the slicing changes no
  bit of the result.
* **The step counter** is a 0-d int32 tensor on the parameters' device,
  incremented there: no update waits for the host.
* Leaves are visited in JAX's order (dict keys sorted, :mod:`..tree`), so
  :func:`global_norm` adds the leaves' sums of squares in the reference's
  order.  Each leaf's own sum is PyTorch's reduction, another order than
  XLA's, so the norms agree to float32 rounding, not bit for bit.

DTensor leaves (a mesh's cell, ``configs.common``): :func:`adamw_init`
gives moments with the parameters' placements and a replicated step
counter; :func:`adamw_update` lays each gradient out as its parameter
(reducing a partial one) and works on each rank's local shards, which is
exact since parameters, gradients and moments then share placements; and
:func:`global_norm` adds each leaf's local sum of squares over the mesh
dimensions that shard it, so every rank holds the global norm.

The update's arithmetic is the reference's: the gradient scaled by
``min(1, max_norm / max(norm, 1e-9))`` in float32, the moments upcast to
float32 for the update and cast back to their own dtype, bias correction by
``1 - b**t`` with t the new step as float32, and the parameter computed in
float32 and cast back to its dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import tree

#: most elements of one slice of a leaf in an update or a norm: 32 Mi on
#: the card (128 MB float32 temporaries from the caching allocator, ~15
#: launches a slice), 4 Mi on the CPU (16 MB temporaries stay below
#: glibc's mmap threshold and are reused; larger ones are mapped and
#: zero-filled by the kernel each time, 3x slower)
SLICE = {"cuda": 1 << 25, "cpu": 1 << 22}


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


def adamw_init(params, state_dtype: torch.dtype = torch.float32
               ) -> AdamWState:
    """Zero moments of ``state_dtype`` (bfloat16 halves the moments'
    memory, PaLM-style; the update still runs in float32) and a zero step
    counter on the first leaf's device."""
    mu = tree.tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype),
                       params)
    nu = tree.tree_map(torch.zeros_like, mu)
    first = tree.leaves(params)[0]
    if isinstance(first, DTensor):
        mesh = first.device_mesh
        step = DTensor.from_local(
            torch.zeros((), dtype=torch.int32, device=first.device), mesh,
            (Replicate(),) * mesh.ndim, run_check=False)
    else:
        step = torch.zeros((), dtype=torch.int32, device=first.device)
    return AdamWState(step=step, mu=mu, nu=nu)


def _slices(t: torch.Tensor, limit: int | None = None):
    """Views of ``t`` that tile it, each of at most ``limit`` (default
    ``SLICE`` of its device) elements where ``t`` has a leading dimension
    to cut along."""
    if limit is None:
        limit = SLICE.get(t.device.type, SLICE["cuda"])
    if t.numel() <= limit or t.dim() < 2:
        yield t
        return
    row = t.numel() // t.shape[0]
    if row > limit:
        for r in t:
            yield from _slices(r, limit)
        return
    yield from torch.split(t, limit // row)


def _local_square_sum(g: DTensor) -> torch.Tensor:
    """The sum of a DTensor's squares over the whole tensor, on every
    rank: its local shard's sum added over the mesh dimensions that shard
    it (a partial gradient is reduced first)."""
    mesh = g.device_mesh
    if any(isinstance(p, Partial) for p in g.placements):
        g = g.redistribute(mesh, tuple(Replicate() if isinstance(p, Partial)
                                       else p for p in g.placements))
    total = None
    for part in _slices(g.to_local()):
        s = part.float().square().sum()
        total = s if total is None else total + s
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=g.device)
    pl = tuple(Partial() if isinstance(p, Shard) else Replicate()
               for p in g.placements)
    if all(isinstance(p, Replicate) for p in pl):
        return total
    return DTensor.from_local(total, mesh, pl, run_check=False).redistribute(
        mesh, (Replicate(),) * mesh.ndim).to_local()


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, the leaves
    added in JAX's order (the first sum is the start, as ``0 + s`` is in
    the reference's Python ``sum``: no host tensor goes to the card).  A
    DTensor leaf adds its whole tensor's sum (see
    :func:`_local_square_sum`); the norm is then a plain tensor, the same
    on every rank."""
    total = None
    for g in tree.leaves(grads):
        if isinstance(g, DTensor):
            s = _local_square_sum(g)
            total = s if total is None else total + s
            continue
        for part in _slices(g):
            s = part.float().square().sum()
            total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm).
    A new tree, as the reference's: each leaf is promoted to float32 by the
    float32 scale, as JAX promotes a bfloat16 leaf times a float32 array."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree.tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, torch.float32)) * scale,
        grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """One AdamW step, in place: returns ``(params, state, gnorm)``, the
    same parameter and state tensors it was given, updated, and the
    gradient's global norm before clipping (a 0-d float32 tensor).  ``lr``
    is a float or a 0-d tensor (a schedule of ``state.step``)."""
    flat_p = tree.leaves(params)
    flat_g = tree.leaves(grads)
    flat_m = tree.leaves(state.mu)
    flat_v = tree.leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in leaves")
    # a DTensor gradient laid out as its parameter (a partial one reduced)
    flat_g = [g.redistribute(p.device_mesh, p.placements)
              if isinstance(p, DTensor) and g.placements != p.placements
              else g for p, g in zip(flat_p, flat_g)]
    gnorm = global_norm(flat_g)
    scale = _clip_scale(gnorm, max_grad_norm)
    state.step.add_(1)
    step = state.step
    t = (step.to_local() if isinstance(step, DTensor) else step).to(
        torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if isinstance(p, DTensor):
            if not p.placements == m.placements == v.placements:
                raise ValueError("a DTensor leaf's parameter and moments "
                                 "differ in placements")
            p, g, m, v = (x.to_local() for x in (p, g, m, v))
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                  _slices(v)):
            # the reference's expressions, with in-place steps where a
            # temporary is not needed again (the same bits, fewer
            # allocations)
            gf = gs.float() * scale
            mf = ms.float() * b1
            mf += (1 - b1) * gf
            vf = vs.float() * b2
            vf += (1 - b2) * gf.square_()
            ms.copy_(mf)
            vs.copy_(vf)
            delta = (mf.div_(bc1)).div_(vf.div_(bc2).sqrt_().add_(eps))
            pf = ps.float()
            delta += weight_decay * pf
            ps.copy_(pf - lr * delta)
    return params, state, gnorm


class RowAdagradState(NamedTuple):
    accum: torch.Tensor  # (rows,) one float32 scalar per embedding row


def row_adagrad_init(table: torch.Tensor) -> RowAdagradState:
    return RowAdagradState(accum=torch.zeros(table.shape[0],
                                             dtype=torch.float32,
                                             device=table.device))


@torch.no_grad()
def row_adagrad_update(table: torch.Tensor, grad: torch.Tensor,
                       state: RowAdagradState, lr: float = 0.01,
                       eps: float = 1e-8):
    """Row-wise Adagrad, in place: accumulate each row's mean square
    gradient (dense gradient form); returns ``(table, state)``, the same
    tensors, updated."""
    g = grad.float()
    state.accum.add_(g.square().mean(-1))
    scale = lr / (torch.sqrt(state.accum) + eps)
    table.copy_(table.float() - scale[:, None] * g)
    return table, state
