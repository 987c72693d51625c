"""Public entry point of the sorted-list membership op.

:func:`intersect_sorted` is the conjunctive AND core of the kernel backend
(``engine/backends.py``): the shortest list's docids are tested against
all further lists of a query in one call (``offsets`` bounding them in one
concatenated ``b``), or against one list ``b``.  CUDA tensors launch the
kernel (``kernel.py``) and raise if it cannot run; CPU tensors run the
plain version (``ref.py``).

The reference pads both lists to tiles of 512 with INT32_MAX and takes one
list a call; the port needs no padding and returns the same flags for the
unpadded ``a``, as the AND over the lists of the reference's one-list
calls.
"""

from __future__ import annotations

import torch

from .kernel import intersect_kernel
from .ref import PAD, intersect_all_ref, intersect_ref


def intersect_sorted(a: torch.Tensor, b: torch.Tensor,
                     offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Membership flags of sorted int32 list ``a`` in sorted list ``b``,
    or, with ``offsets`` ((n + 1,) int32 bounds, on ``b``'s device), in
    every one of the n sorted lists concatenated in ``b``."""
    if a.is_cuda:
        return intersect_kernel(a, b, offsets)
    if offsets is None:
        return intersect_ref(a, b)
    return intersect_all_ref(a, b, offsets)


from .. import registry  # noqa: E402

registry.register(registry.KernelSpec(
    name="intersect", fn=intersect_sorted, modes=("conjunctive",),
    description="sorted-list membership against all further lists of a "
                "query in one launch: per 256-docid tile of a, a 32-ary "
                "warp search for each list's window, the window staged in "
                f"shared memory and binary-searched (PAD = {PAD} never "
                "matches)"))
