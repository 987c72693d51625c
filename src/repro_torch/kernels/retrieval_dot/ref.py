"""Plain PyTorch version of the two-tower candidate-scoring kernel.

:func:`retrieval_dot_ref` computes what the CUDA kernel
(``csrc/retrieval_dot.cu``) computes: the (q, n) float32 scores of query
embeddings Q (q, d) against candidate embeddings C (n, d), both cast to
float32.  It runs on the CPU for the tests and for a caller on the CPU, and
on CUDA tensors only where ``chip_smoke.py`` holds the kernel against it.
"""

from __future__ import annotations

import torch


def retrieval_dot_ref(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """scores (q, n) = q @ cand^T in float32."""
    return torch.einsum("qd,nd->qn", q.float(), cand.float())
