"""Plain PyTorch version of the sorted-list membership kernel.

:func:`intersect_ref` computes what the CUDA kernel (``csrc/intersect.cu``)
computes: for every element of the sorted int32 docid vector ``a``, whether
it occurs in the sorted int32 vector ``b``.  Both may be padded with
:data:`PAD` (INT32_MAX), which never matches.  It runs on the CPU for the
tests and the kernel backend of a CPU-resident engine, and on CUDA tensors
only where ``chip_smoke.py`` holds the kernel against it.
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
