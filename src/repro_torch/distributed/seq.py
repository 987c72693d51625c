"""Scheduling serialization for unrolled chunk loops.

In the JAX package (``src/repro/distributed/seq.py``) an unrolled Python
chunk loop leaves its chunk bodies data-independent, so XLA may schedule
them concurrently and keep every chunk's temporaries alive at once;
``serialize_after`` threads a fake data dependency through
``lax.optimization_barrier`` so that chunk i+1 cannot start before chunk
i's output exists.

Eager PyTorch has no such scheduler: each operation is issued in program
order on one stream, and a chunk's temporaries are freed when the last
reference to them goes.  So the barrier has no counterpart, and
:func:`serialize_after` returns ``tree`` unchanged.
"""

from __future__ import annotations


def serialize_after(tree, dep):
    """Return ``tree``; eager operations already run after ``dep``."""
    del dep
    return tree
