"""Wrapper of the CUDA ``fused_query`` kernel (``csrc/fused_query.cu``).

:func:`fused_query_kernel` takes exactly the arguments of the plain version
:func:`..ref.fused_tile` — packed image parts plus the per-batch tensors —
checks them, allocates the outputs and the (Q, cap+1) accumulator scratch
with ``torch.empty``, and launches the kernel on the current CUDA stream.
It never falls back to the plain version: a tensor off the card, a failed
build or a refused launch raises.

``launches`` counts the kernel launches made through this wrapper, so a run
can show that its main path really went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..cuda_args import check, raise_on_error, require_cuda

#: kernel launches made through :func:`fused_query_kernel`
launches = 0

_MODE_CODES = {"conjunctive": 0, "ranked_tfidf": 1, "bm25": 2}
_PART_DTYPES = (torch.uint8, torch.int32, torch.int32, torch.int32,
                torch.int32, torch.int32, torch.float32)


def _lib():
    lib = build.load("fused_query")
    fn = lib.fq_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, p, p, i, p, p, p, p, p, p,
                       p]
        fn.restype = ctypes.c_int
    return fn


def fused_query_kernel(parts, nterms, doclens, bm25_norm, *, mode: str,
                       k: int, F: int, cap: int, alive=None):
    """Launch the fused kernel; returns what ``ref.fused_tile`` returns."""
    global launches
    if mode not in _MODE_CODES:
        raise ValueError(f"unsupported fused mode {mode!r}")
    if not 1 <= len(parts) <= 2:
        raise ValueError("the kernel takes one or two image parts")
    device = require_cuda(parts[0][0], "fused_query_kernel")
    Q, _, B = parts[0][0].shape
    ptrs, pbs = [], []
    for pi, part in enumerate(parts):
        if len(part) != 7:
            raise ValueError("a part is (gat, start, end, seg, lastd0, "
                             "dnum0, widf)")
        PB = part[0].shape[1]
        for j, (t, dt) in enumerate(zip(part, _PART_DTYPES)):
            shape = (Q, PB, B) if j == 0 else (Q, PB)
            check(t, f"parts[{pi}][{j}]", dt, shape, device)
            ptrs.append(t.data_ptr())
        pbs.append(PB)
    check(nterms, "nterms", torch.int32, (Q,), device)
    check(doclens, "doclens", torch.float32, None, device)
    check(bm25_norm, "bm25_norm", torch.float32, (2,), device)
    if alive is not None:
        check(alive, "alive", torch.int32, ((cap + 1 + 31) // 32,), device)
    kk = min(k, cap + 1)
    conj = mode == "conjunctive"
    acc = torch.empty((Q, cap + 1),
                      dtype=torch.int32 if conj else torch.float32,
                      device=device)
    if conj:
        matches = torch.empty((Q, cap + 1), dtype=torch.bool, device=device)
        top_d = top_s = None
    else:
        matches = None
        top_d = torch.empty((Q, kk), dtype=torch.int32, device=device)
        top_s = torch.empty((Q, kk), dtype=torch.float32, device=device)
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_int * len(pbs))(*pbs), len(parts), Q, B, F, cap,
                _MODE_CODES[mode], kk, nterms.data_ptr(), doclens.data_ptr(),
                doclens.shape[0], bm25_norm.data_ptr(),
                None if alive is None else alive.data_ptr(), acc.data_ptr(),
                None if matches is None else matches.data_ptr(),
                None if top_d is None else top_d.data_ptr(),
                None if top_s is None else top_s.data_ptr(), stream)
    raise_on_error(rc, "fused_query")
    launches += 1
    if conj:
        return matches
    return top_d, top_s
