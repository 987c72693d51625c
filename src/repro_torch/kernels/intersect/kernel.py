"""Wrapper of the CUDA ``intersect`` kernel (``csrc/intersect.cu``).

:func:`intersect_kernel` takes the arguments of the plain versions
(:func:`..ref.intersect_ref` for one list, :func:`..ref.intersect_all_ref`
for several concatenated ones), checks them, allocates the flags with
``torch.empty`` and launches the kernel once on the current CUDA stream,
for all the lists.  It never falls back to the plain version: a tensor off
the card, a failed build or a refused launch raises.  An empty ``a`` needs
no launch.

``launches`` counts the kernel launches made through this wrapper;
:func:`empty_launch` (the launch floor, an empty kernel on the same grid)
does not count.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..cuda_args import check, raise_on_error, require_cuda

#: kernel launches made through :func:`intersect_kernel`
launches = 0


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ix_launch.argtypes = [p, i, p, p, i, i, p, p]
    lib.ix_launch.restype = ctypes.c_int
    lib.ix_empty_launch.argtypes = [i, p]
    lib.ix_empty_launch.restype = ctypes.c_int


def _lib():
    return build.load("intersect", _declare)


def intersect_kernel(a: torch.Tensor, b: torch.Tensor,
                     offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel: (len a,) bool flags of a[i] in every list of
    ``b``.  ``offsets`` (n + 1,) int32 on the card bounds n >= 1 lists
    concatenated in ``b`` (non-decreasing, within [0, len b]); None means
    ``b`` is one list."""
    global launches
    device = require_cuda(a, "intersect_kernel")
    check(a, "a", torch.int32, (a.numel(),), device)
    check(b, "b", torch.int32, (b.numel(),), device)
    nlists = 1
    if offsets is not None:
        check(offsets, "offsets", torch.int32, (offsets.numel(),), device)
        nlists = offsets.numel() - 1
        if nlists < 1:
            raise ValueError("offsets must bound at least one list")
    flags = torch.empty(a.shape, dtype=torch.bool, device=device)
    if a.numel() == 0:
        return flags
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ix_launch(a.data_ptr(), a.numel(), b.data_ptr(),
                           None if offsets is None else offsets.data_ptr(),
                           nlists, b.numel(), flags.data_ptr(), stream)
    raise_on_error(rc, "intersect")
    launches += 1
    return flags


def empty_launch(na: int, device) -> None:
    """Launch an empty kernel on the grid :func:`intersect_kernel` takes
    for ``na`` elements of ``a``: the floor under its device time."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        raise_on_error(lib.ix_empty_launch(int(na), stream), "empty")
