"""Wrapper of the CUDA ``fused_query`` kernel (``csrc/fused_query.cu``).

:func:`fused_query_kernel` takes exactly the arguments of the plain version
:func:`..ref.fused_tile` — packed image parts plus the per-batch tensors —
checks them, allocates the outputs and the scratch (each docid range's top
kk and a ticket counter per query) with ``torch.empty``, and launches the
kernel on the current CUDA stream.  It never falls back to the plain
version: a tensor off the card, a failed build or a refused launch raises.

The kernel splits each query's cap+1 docid columns into R ranges of W
(:func:`ranges_for`), one CUDA block per (range, query), with the range's
accumulator in shared memory.

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

#: shared memory a range's 4-byte accumulator may take: two CUDA blocks of
#: the kernel, each with ~29 KB of other shared memory, share an SM's 228 KB
ACC_BYTES = 80 * 1024
#: CUDA blocks per SM that a launch aims to give the card
BLOCKS_PER_SM = 2
_PART_DTYPES = (torch.uint8, torch.int32, torch.int32, torch.int32,
                torch.int32, torch.int32, torch.float32)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fq_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p, p, i, p, p,
                              p, p, p, p, p, p, p]
    lib.fq_launch.restype = ctypes.c_int


def _lib():
    return build.load("fused_query", _declare).fq_launch


def ranges_for(Q: int, cap: int, n_sm: int) -> tuple[int, int]:
    """(R, W): the docid ranges per query and the columns per range.

    Range r holds docids [r·W, min((r+1)·W, cap+1)).  R is as many ranges
    as let the Q·R CUDA blocks fill ``BLOCKS_PER_SM`` per SM of ``n_sm`` in
    one wave, raised until a range's 4-byte accumulator fits
    ``ACC_BYTES``.  W is ⌈(cap+1)/R⌉ rounded up to a multiple of 32, and R
    is then cut to ⌈(cap+1)/W⌉, so that no range is empty; the last may
    be short."""
    cols = cap + 1
    ranges = max(BLOCKS_PER_SM * n_sm // max(Q, 1),
                 -(-cols // (ACC_BYTES // 4)), 1)
    W = 32 * -(-cols // (32 * ranges))
    return -(-cols // W), W


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    R, W = ranges_for(Q, cap, _sm_count(device))
    if conj:
        matches = torch.empty((Q, cap + 1), dtype=torch.bool, device=device)
        top_d = top_s = cand_d = cand_s = ticket = None
    else:
        matches = None
        top_d = torch.empty((Q, kk), dtype=torch.int32, device=device)
        top_s = torch.empty((Q, kk), dtype=torch.float32, device=device)
        cand_d = torch.empty((Q, R, kk), dtype=torch.int32, device=device)
        cand_s = torch.empty((Q, R, kk), dtype=torch.float32, device=device)
        ticket = torch.empty((Q,), dtype=torch.int32, device=device)
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_int * len(pbs))(*pbs), len(parts), Q, B, F, cap,
                _MODE_CODES[mode], kk, R, W, nterms.data_ptr(),
                doclens.data_ptr(), doclens.shape[0], bm25_norm.data_ptr(),
                *(None if t is None else t.data_ptr()
                  for t in (alive, matches, top_d, top_s, cand_d, cand_s,
                            ticket)), stream)
    raise_on_error(rc, "fused_query")
    launches += 1
    if conj:
        return matches
    return top_d, top_s
