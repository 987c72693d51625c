"""Sharding rules: logical-axis -> mesh-axis mapping per architecture family.

Ported from the JAX package's ``src/repro/distributed/sharding.py`` onto
``torch.distributed.tensor``: a mesh is a ``DeviceMesh`` with named
dimensions (``launch/mesh.py``: ("data", "model") single pod, ("pod",
"data", "model") multi-pod) and a sharded tensor a ``DTensor``.  Policy,
as the reference's:

  * LM dense: FSDP, every weight matrix shards its d_model-sized dim over
    "data" and its heads/ff/vocab dim over "model" (tensor parallel,
    Megatron-style pairing of in/out projections).  The "pod" axis extends
    data parallelism.
  * LM MoE: experts shard over "model"; within-expert weights over "data".
  * Embedding tables: the LM vocab over "model", pairing with the final
    projection.
  * Activations: batch over ("pod", "data").

A spec is the reference's ``PartitionSpec`` as a tuple: per tensor
dimension a mesh-axis name, a tuple of names, or None.  Rules map regexes
over a leaf's path (keys, indices and NamedTuple fields joined by ``/``,
as the reference names them; see ``tree.path_names``) to specs, resolved
against a mesh with absent axes filtered out.  DTensor states the same
layout the other way round, as placements: one per *mesh* dimension,
``Shard(d)`` where the spec names that mesh dimension for tensor dimension
``d`` and ``Replicate()`` elsewhere (:func:`placements`).

Helpers the models use on DTensors (plain tensors pass through, so a
model called with ``mesh=None`` computes what it did before):
:func:`local_slice` cuts the i-th of n slices out of each rank's own shard
(a microbatch or an edge chunk that stays sharded), and :func:`replicate`
gathers a tensor whole on every rank where no sharded formulation exists,
naming why in the notes that :func:`record_redistributes` collects.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from contextvars import ContextVar

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from .. import tree as _tree

#: the notes of :func:`replicate` calls, while :func:`record_redistributes`
#: collects them
_NOTES: ContextVar[list | None] = ContextVar("redistribute_notes",
                                             default=None)


def _mesh_axes(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _axes(mesh, *names) -> tuple:
    """Filter mesh-axis names to those present (pod optional)."""
    have = _mesh_axes(mesh)
    got = []
    for n in names:
        if isinstance(n, tuple):
            sub = tuple(x for x in n if x in have)
            got.append(sub if sub else None)
        else:
            got.append(n if n in have else None)
    return tuple(got)


def lm_param_rules(mesh) -> list[tuple[str, tuple]]:
    """(regex, spec) table for transformer parameter paths."""
    d, m = "data", "model"

    def P(*names):
        return _axes(mesh, *names)

    return [
        (r"embed", P(m, d)),                       # (V, D)
        (r"(wq|wk|wv)$", P(None, d, m)),           # (L, D, H*dh)
        (r"wo$", P(None, m, d)),                   # (L, H*dh, D)
        (r"(w_gate|w_up)$", P(None, d, m)),        # (L, D, F)
        (r"w_down$", P(None, m, d)),               # (L, F, D)
        (r"router$", P(None, d, None)),            # (L, D, E)
        (r"(moe_w_gate|moe_w_up)$", P(None, m, d, None)),   # (L, E, D, F)
        (r"moe_w_down$", P(None, m, None, d)),     # (L, E, F, D)
        (r"(norm|scale|ln)", P(None)),             # (L, D) / (D,)
        (r"out_proj$", P(d, m)),                   # (D, V)
        (r".*", P()),
    ]


def spec_for(path: str, rules) -> tuple:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()


def placements(spec, ndim: int, mesh) -> tuple:
    """The DTensor placements of ``spec`` for a tensor of ``ndim``
    dimensions on ``mesh``: a spec longer than ``ndim`` is cut to it, as
    the reference drops the axes a leaf cannot take, and absent axes are
    filtered.  A tensor dimension over several mesh axes, such as
    ("pod", "data"), is split over them major to minor in the order the
    spec lists them, as JAX splits it; DTensor splits in mesh order, so
    the spec must list them in the mesh's order (the reference's rules
    do), and a spec that does not raises."""
    names = _mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        idx = [names.index(a) for a in
               (entry if isinstance(entry, tuple) else (entry,))
               if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} named twice in "
                                 f"{spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def tree_shardings(params, mesh, rules) -> list:
    """Each leaf's placements on ``mesh`` under ``rules``, in flatten
    order (``params``' leaves are tensors, meta tensors too)."""
    return [placements(spec_for(name, rules), leaf.dim(), mesh)
            for name, leaf in zip(_tree.path_names(params),
                                  _tree.leaves(params))]


def constrain(x, mesh, *spec):
    """The reference's sharding constraint: a DTensor is redistributed to
    ``spec`` on ``mesh`` (absent axes filtered); a plain tensor, which has
    one device's layout only, is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec, x.dim(), mesh))


def batch_axes(mesh) -> tuple:
    """The data-parallel axes tuple: ("pod", "data") when multi-pod."""
    return tuple(a for a in ("pod", "data") if a in _mesh_axes(mesh))


def remesh(tree, new_mesh, rules):
    """Elastic re-scaling: move a tree of DTensors (or plain tensors, the
    same on every rank) onto ``new_mesh``, the same rule table resolved
    against it.  Each leaf is gathered whole and distributed again, so
    every value is kept; every rank of both meshes takes part."""
    leaves, treedef = _tree.flatten(tree)
    out = []
    for x, pl in zip(leaves, tree_shardings(tree, new_mesh, rules)):
        full = x.full_tensor() if isinstance(x, DTensor) else x
        out.append(distribute_tensor(full, new_mesh, pl))
    return _tree.unflatten(treedef, out)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def wrap_local(local: torch.Tensor, mesh, pl, shape) -> DTensor:
    """``local`` as one rank's shard of a contiguous DTensor of ``shape``
    with placements ``pl`` (no collective, no check).  In the backward
    pass the gradient is laid out as ``pl`` again, a partial placement
    taking the replicated gradient as it is, so each rank's local
    gradient is the whole gradient of its partial value."""
    shape = torch.Size(tuple(int(n) for n in shape))
    return DTensor.from_local(local, mesh, tuple(pl), run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def local_slice(x, n: int, i: int):
    """The i-th of ``n`` slices of ``x`` along dimension 0.  A plain
    tensor gives ``x[i*s:(i+1)*s]`` (s = rows // n).  A DTensor gives, on
    every rank, the i-th of ``n`` nearly equal slices of its OWN shard
    (the first ``L % n`` slices one row longer, L rows a shard), wrapped
    with ``x``'s placements: the slice stays sharded and no rank receives
    another's rows.  Globally the slice then holds rows ``r*L + start_i``
    onwards of each shard r, not a contiguous block, so an accumulation
    over the slices adds the same rows in other groups than a plain split
    would.  Every rank must hold as many rows (dimension 0 split evenly
    over its shards)."""
    if not isinstance(x, DTensor):
        s = x.shape[0] // n
        return x[i * s:(i + 1) * s]
    loc = x.to_local()
    L = loc.shape[0]
    if L == 0 or x.shape[0] % L:
        raise ValueError(f"{x.shape[0]} rows are not split evenly into "
                         f"shards of {L}")
    base, extra = divmod(L, n)
    start = i * base + min(i, extra)
    size = base + (i < extra)
    return wrap_local(loc[start:start + size], x.device_mesh, x.placements,
                      (x.shape[0] // L * size, *x.shape[1:]))


@contextmanager
def record_redistributes():
    """Collects the notes of the :func:`replicate` calls made in the body:
    yields the list they are appended to (each note once)."""
    box: list = []
    token = _NOTES.set(box)
    try:
        yield box
    finally:
        _NOTES.reset(token)


def replicate(x, why: str, dim: int | None = None):
    """``x`` gathered whole on every rank of its mesh, or along dimension
    ``dim`` alone (a plain tensor is returned as it is).  For an op
    without a sharded formulation; ``why`` is appended to the notes
    :func:`record_redistributes` collects."""
    if not isinstance(x, DTensor):
        return x
    box = _NOTES.get()
    if box is not None and why not in box:
        box.append(why)
    mesh = x.device_mesh
    want = tuple(Replicate() if dim is None or (isinstance(p, Shard)
                                                and p.dim == dim) else p
                 for p in x.placements)
    return x.redistribute(mesh, want)


def splits_evenly(x, dim: int, n: int) -> bool:
    """Whether the mesh dimensions that shard ``x``'s dimension ``dim``
    divide ``n`` (True for a plain tensor)."""
    if not isinstance(x, DTensor):
        return True
    k = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            k *= x.device_mesh.size(i)
    return n % k == 0


def spec_of(pl, ndim: int, mesh) -> tuple:
    """The reference's ``PartitionSpec`` of placements ``pl`` on ``mesh``
    for a tensor of ``ndim`` dimensions, as a tuple: per dimension the
    mesh axis that shards it, a tuple of axes in mesh order, or None,
    trailing Nones dropped (the inverse of :func:`placements`)."""
    names = _mesh_axes(mesh)
    out = []
    for d in range(ndim):
        axes = tuple(n for n, p in zip(names, pl)
                     if isinstance(p, Shard) and p.dim == d)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def local_cat(parts: list):
    """The inverse of :func:`local_slice` over all its slices: plain
    tensors concatenated along dimension 0; DTensors (of one placement)
    joined on every rank from their local shards, so each rank's rows stay
    its own and in order."""
    if not isinstance(parts[0], DTensor):
        return torch.cat(parts)
    first = parts[0]
    loc = torch.cat([p.to_local() for p in parts])
    return wrap_local(loc, first.device_mesh, first.placements,
                      (sum(p.shape[0] for p in parts), *first.shape[1:]))


def shard_range(size: int, mesh, pl, dim: int) -> tuple[int, int]:
    """(first index, length) of this rank's shard of a dimension of
    ``size`` under placements ``pl``: DTensor's split (ceil-sized chunks,
    mesh dimensions in order), from the rank's mesh coordinate alone, so
    that no tensor op runs (under a fake mode none could be read)."""
    coord = mesh.get_coordinate()
    lo, n = 0, int(size)
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            k = mesh.size(i)
            chunk = -(-n // k)
            start = min(coord[i] * chunk, n)
            lo, n = lo + start, max(0, min(chunk, n - start))
    return lo, n
