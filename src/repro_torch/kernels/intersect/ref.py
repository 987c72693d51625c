"""Plain PyTorch versions of the sorted-list membership kernel.

:func:`intersect_ref` computes, for every element of the sorted int32
docid vector ``a``, whether it occurs in the sorted int32 vector ``b``;
:func:`intersect_all_ref`, which the CUDA kernel (``csrc/intersect.cu``)
computes, whether it occurs in every one of several sorted lists
concatenated in ``b``: the AND of :func:`intersect_ref` over them.  Both
may be padded with :data:`PAD` (INT32_MAX), which never matches.  They run
on the CPU for the tests and the kernel backend of a CPU-resident engine,
and on CUDA tensors only where ``chip_smoke.py`` holds the kernel against
them.
"""

from __future__ import annotations

import torch

PAD = torch.iinfo(torch.int32).max


def intersect_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """flags[i] = a[i] ∈ b via searchsorted (sorted b, PAD-padded)."""
    if b.numel() == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    idx = torch.searchsorted(b, a).clamp(max=b.shape[0] - 1)
    return (b[idx] == a) & (a != PAD)


def intersect_all_ref(a: torch.Tensor, b: torch.Tensor,
                      offsets) -> torch.Tensor:
    """flags[i] = a[i] ∈ b[offsets[j]:offsets[j + 1]] for every list j:
    the AND of :func:`intersect_ref` over the n >= 1 lists that
    ``offsets`` (n + 1 non-decreasing bounds into ``b``) marks out."""
    bounds = (offsets.tolist() if isinstance(offsets, torch.Tensor)
              else [int(x) for x in offsets])
    if len(bounds) < 2:
        raise ValueError("offsets must bound at least one list")
    flags = intersect_ref(a, b[bounds[0]:bounds[1]])
    for lo, hi in zip(bounds[1:-1], bounds[2:]):
        flags &= intersect_ref(a, b[lo:hi])
    return flags
