"""Wrapper of the CUDA ``intersect`` kernel (``csrc/intersect.cu``).

:func:`intersect_kernel` takes the arguments of the plain version
:func:`..ref.intersect_ref`, checks them, allocates the flags with
``torch.empty`` and launches the kernel on the current CUDA stream.  It
never falls back to the plain version: a tensor off the card, a failed
build or a refused launch raises.  An empty ``a`` needs no launch.

``launches`` counts the kernel launches made through this wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..cuda_args import check, raise_on_error, require_cuda

#: kernel launches made through :func:`intersect_kernel`
launches = 0


def _lib():
    fn = build.load("intersect").ix_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def intersect_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (len a,) bool flags of a[i] ∈ b."""
    global launches
    device = require_cuda(a, "intersect_kernel")
    check(a, "a", torch.int32, (a.numel(),), device)
    check(b, "b", torch.int32, (b.numel(),), device)
    flags = torch.empty(a.shape, dtype=torch.bool, device=device)
    if a.numel() == 0:
        return flags
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(a.data_ptr(), a.numel(), b.data_ptr(), b.numel(),
                flags.data_ptr(), stream)
    raise_on_error(rc, "intersect")
    launches += 1
    return flags
