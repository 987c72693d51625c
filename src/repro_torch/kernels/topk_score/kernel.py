"""Wrapper of the CUDA ``topk_score`` kernel (``csrc/topk_score.cu``).

:func:`score_kernel` takes the arguments of the plain version
:func:`..ref.score_ref` with the segment bounds as an int32 tensor on the
card, checks them, allocates the (n_docs,) output with ``torch.empty`` and
launches the kernel on the current CUDA stream.  It never falls back to the
plain version: a tensor off the card, a failed build or a refused launch
raises.  ``n_docs == 0`` needs no launch.

``launches`` counts the kernel launches made through this wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..cuda_args import check, raise_on_error, require_cuda

#: kernel launches made through :func:`score_kernel`
launches = 0


def _lib():
    fn = build.load("topk_score").ts_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def score_kernel(docids: torch.Tensor, weights: torch.Tensor, n_docs: int,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: (n_docs,) float32 scores, out[0] = 0.

    ``offsets`` (S+1,) int32 splits the postings into segments of distinct
    ascending docids, added in order."""
    global launches
    device = require_cuda(docids, "score_kernel")
    M = docids.numel()
    check(docids, "docids", torch.int32, (M,), device)
    check(weights, "weights", torch.float32, (M,), device)
    check(offsets, "offsets", torch.int32, (offsets.numel(),), device)
    if offsets.numel() < 1:
        raise ValueError("offsets needs at least one bound")
    out = torch.empty(n_docs, dtype=torch.float32, device=device)
    if n_docs == 0:
        return out
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(docids.data_ptr(), weights.data_ptr(), offsets.data_ptr(),
                offsets.numel() - 1, out.data_ptr(), n_docs, stream)
    raise_on_error(rc, "topk_score")
    launches += 1
    return out
