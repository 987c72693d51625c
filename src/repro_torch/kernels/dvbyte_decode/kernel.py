"""Wrapper of the CUDA ``dvbyte_decode`` kernel (``csrc/dvbyte_decode.cu``).

:func:`dvbyte_decode_kernel` takes the arguments of the plain version
:func:`..ref.decode_blocks`, checks them, allocates the three (NB, B)
outputs with ``torch.empty`` and launches the kernel on the current CUDA
stream.  It never falls back to the plain version: a tensor off the card, a
failed build or a refused launch raises, and so does a block wider than
:data:`MAX_B` bytes (the kernel keeps one bit per byte position in a
64-bit mask).  ``NB == 0`` needs no launch.

``launches`` counts the kernel launches made through this wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..cuda_args import check, raise_on_error, require_cuda

#: kernel launches made through :func:`dvbyte_decode_kernel`
launches = 0
#: widest block the kernel decodes (bytes)
MAX_B = 64


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dv_launch.argtypes = [p, p, p, i, i, i, p, p, p, p]
    lib.dv_launch.restype = ctypes.c_int


def _lib():
    return build.load("dvbyte_decode", _declare).dv_launch


def dvbyte_decode_kernel(blocks: torch.Tensor, start: torch.Tensor,
                         end: torch.Tensor, F: int):
    """Launch the kernel: (g int32, f int32, valid bool), each (NB, B)."""
    global launches
    device = require_cuda(blocks, "dvbyte_decode_kernel")
    if blocks.dim() != 2:
        raise ValueError("blocks must be (NB, B)")
    NB, B = blocks.shape
    if not 1 <= B <= MAX_B:
        raise ValueError(f"blocks of {B} bytes: the kernel takes 1 to "
                         f"{MAX_B}")
    check(blocks, "blocks", torch.uint8, (NB, B), device)
    check(start, "start", torch.int32, (NB,), device)
    check(end, "end", torch.int32, (NB,), device)
    g = torch.empty((NB, B), dtype=torch.int32, device=device)
    f = torch.empty((NB, B), dtype=torch.int32, device=device)
    valid = torch.empty((NB, B), dtype=torch.bool, device=device)
    if NB == 0:
        return g, f, valid
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(blocks.data_ptr(), start.data_ptr(), end.data_ptr(), NB, B,
                int(F), g.data_ptr(), f.data_ptr(), valid.data_ptr(), stream)
    raise_on_error(rc, "dvbyte_decode")
    launches += 1
    return g, f, valid
