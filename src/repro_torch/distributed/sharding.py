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
"""

from __future__ import annotations

import re

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from .. import tree as _tree


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
