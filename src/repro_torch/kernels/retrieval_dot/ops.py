"""Public entry point of the two-tower candidate-scoring op.

:func:`candidate_scores` is stage 2 of hybrid retrieval
(``examples/hybrid_retrieval_torch.py``): the dense scores of a user
embedding against the embeddings of the candidates the live index found.
CUDA tensors launch the kernel (``kernel.py``) and raise if it cannot run;
CPU tensors run the plain version (``ref.py``).  bf16 inputs are cast to
float32 first, as the reference's ``_dot_tile`` does (bf16 products are
exact in float32).

The reference's ``tile_q``/``tile_n``/``tile_d`` arguments sized its TPU
grid; the kernel picks its own blocking, so the port drops them.
"""

from __future__ import annotations

import torch

from .kernel import retrieval_dot_kernel
from .ref import retrieval_dot_ref


def candidate_scores(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Two-tower scores (q, n) = q @ cand^T (float32 accumulation)."""
    if not q.is_cuda:
        return retrieval_dot_ref(q, cand)
    return retrieval_dot_kernel(q.float().contiguous(),
                                cand.float().contiguous())


from .. import registry  # noqa: E402

registry.register(registry.KernelSpec(
    name="retrieval_dot", fn=candidate_scores, modes=(),
    description="dense two-tower candidate scoring, 16 lanes per candidate "
                "row with four 16-byte loads in flight per lane; outside "
                "the term-query path (hybrid retrieval's stage 2)"))
