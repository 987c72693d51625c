"""Wrapper of the CUDA ``retrieval_dot`` kernel (``csrc/retrieval_dot.cu``).

:func:`retrieval_dot_kernel` takes the float32 arguments of the plain
version :func:`..ref.retrieval_dot_ref`, checks them, allocates the (q, n)
output with ``torch.empty`` and launches the kernel on the current CUDA
stream.  It never falls back to the plain version: a tensor off the card, a
failed build or a refused launch raises.  An empty ``q`` or ``cand`` needs
no launch.

``launches`` counts the kernel launches made through this wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..cuda_args import check, raise_on_error, require_cuda

#: kernel launches made through :func:`retrieval_dot_kernel`
launches = 0


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rd_launch.argtypes = [p, i, p, ctypes.c_longlong, i, p, p]
    lib.rd_launch.restype = ctypes.c_int


def _lib():
    return build.load("retrieval_dot", _declare).rd_launch


def retrieval_dot_kernel(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (q, n) float32 scores q @ cand^T."""
    global launches
    device = require_cuda(q, "retrieval_dot_kernel")
    if q.dim() != 2 or cand.dim() != 2:
        raise ValueError("q must be (q, d) and cand (n, d)")
    (Q, D), N = q.shape, cand.shape[0]
    check(q, "q", torch.float32, (Q, D), device)
    check(cand, "cand", torch.float32, (N, D), device)
    out = torch.empty((Q, N), dtype=torch.float32, device=device)
    if Q == 0 or N == 0:
        return out
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(q.data_ptr(), Q, cand.data_ptr(), N, D, out.data_ptr(),
                stream)
    raise_on_error(rc, "retrieval_dot")
    launches += 1
    return out
