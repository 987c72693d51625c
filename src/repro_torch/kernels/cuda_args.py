"""Argument checks shared by the ctypes wrappers of the CUDA kernels.

A wrapper hands raw device pointers to a plain C function, so everything
the kernel assumes — device, dtype, shape, contiguity — is checked here
first, and a tensor that does not fit raises instead of reaching the card.
"""

from __future__ import annotations

import torch


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` lies on ``device`` with ``dtype``, ``shape``
    (None: any) and a contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(t: torch.Tensor, kernel: str) -> torch.device:
    """The CUDA device of ``t``; raises for a tensor off the card."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {t.device}")
    return t.device


def raise_on_error(rc: int, kernel: str) -> None:
    """A non-zero return of a launch function is a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
