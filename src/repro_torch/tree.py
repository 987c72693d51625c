"""Pytrees of tensors in JAX's flatten order.

The optimizer sums the gradient's leaves and the checkpoint manager numbers
its files in the order in which ``jax.tree.flatten`` visits a tree: dict
entries by sorted key, tuple, list and NamedTuple entries in order, ``None``
as a node without leaves, anything else (a tensor, an array, a number) as a
leaf.  ``torch.utils._pytree`` keeps a dict's insertion order instead, so
the port keeps this small copy of JAX's rules: with it the two packages
read each other's checkpoints, and a global norm adds its leaves in the
reference's order.

A treedef is a nested tuple: ``("leaf",)``, ``("none",)``,
``("dict", keys, children)``, ``("tuple", None, children)``,
``("list", None, children)`` or ``("namedtuple", cls, children)``.
:func:`treedef_str` renders one as ``str(jax.tree.structure(...))`` does.
"""

from __future__ import annotations

_LEAF = ("leaf",)
_NONE = ("none",)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def flatten(tree) -> tuple[list, tuple]:
    """(leaves, treedef), the leaves in JAX's order."""
    leaves: list = []

    def walk(x):
        if x is None:
            return _NONE
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", tuple(keys), tuple(walk(x[k]) for k in keys))
        if _is_namedtuple(x):
            return ("namedtuple", type(x), tuple(walk(c) for c in x))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, None, tuple(walk(c) for c in x))
        leaves.append(x)
        return _LEAF

    treedef = walk(tree)
    return leaves, treedef


def path_names(tree) -> list[str]:
    """Each leaf's path in flatten order, named as the reference names one
    from ``jax.tree_util.tree_flatten_with_path``: its keys, indices and
    NamedTuple fields (``.name``) joined by ``/``, e.g. ``.mu/layers/wq``
    or ``inter/filt1/w``."""
    names: list = []

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], (*path, str(k)))
        elif _is_namedtuple(x):
            for f, c in zip(type(x)._fields, x):
                walk(c, (*path, f".{f}"))
        elif isinstance(x, (tuple, list)):
            for i, c in enumerate(x):
                walk(c, (*path, str(i)))
        else:
            names.append("/".join(path))

    walk(tree, ())
    return names


def leaves(tree) -> list:
    return flatten(tree)[0]


def unflatten(treedef: tuple, leaves) -> object:
    """The tree of ``treedef`` holding ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        _, meta, children = node
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(meta, built))
        if kind == "namedtuple":
            return meta(*built)
        return tuple(built) if kind == "tuple" else built

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn, tree):
    """The tree of ``fn`` of each leaf of ``tree``."""
    flat, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in flat])


def treedef_str(treedef: tuple) -> str:
    """``str(jax.tree.structure(tree))`` for the tree of ``treedef``."""

    def show(node):
        kind = node[0]
        if kind == "leaf":
            return "*"
        if kind == "none":
            return "None"
        _, meta, children = node
        parts = [show(c) for c in children]
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {p}"
                                   for k, p in zip(meta, parts)) + "}"
        if kind == "namedtuple":
            return (f"CustomNode(namedtuple[{meta.__name__}], ["
                    + ", ".join(parts) + "])")
        if kind == "list":
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + (",)" if len(parts) == 1 else ")")

    return f"PyTreeDef({show(treedef)})"
