"""Public entry point of the sorted-list membership op.

:func:`intersect_sorted` is the conjunctive AND core of the kernel backend
(``engine/backends.py``): the shortest list's docids are tested against
each further list in turn.  CUDA tensors launch the kernel (``kernel.py``)
and raise if it cannot run; CPU tensors run the plain version (``ref.py``).

The reference pads both lists to tiles of 512 with INT32_MAX; the port
needs no tiles and returns the same flags for the unpadded ``a``.
"""

from __future__ import annotations

import torch

from .kernel import intersect_kernel
from .ref import PAD, intersect_ref


def intersect_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Membership flags of sorted int32 list ``a`` in sorted list ``b``."""
    if a.is_cuda:
        return intersect_kernel(a, b)
    return intersect_ref(a, b)


from .. import registry  # noqa: E402

registry.register(registry.KernelSpec(
    name="intersect", fn=intersect_sorted, modes=("conjunctive",),
    description="sorted-list membership, one CUDA thread per element of a "
                f"binary-searching b (PAD = {PAD} never matches)"))
