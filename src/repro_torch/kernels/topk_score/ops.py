"""Public entry point of the score-accumulation op.

:func:`score_accumulate` is the scoring core of the kernel backend's ranked
modes (``engine/backends.py``): the dense score vector over the docid
space, from which the backend selects the top k.  CUDA tensors launch the
kernel (``kernel.py``) and raise if it cannot run; CPU tensors run the
plain version (``ref.py``).  The reference accumulates by a one-hot matrix
product per tile on the TPU; the port scatters, deterministically.
"""

from __future__ import annotations

import torch

from .kernel import score_kernel
from .ref import score_ref, segment_offsets


def score_accumulate(docids: torch.Tensor, weights: torch.Tensor,
                     n_docs: int, offsets=None) -> torch.Tensor:
    """Dense float32 score vector from decoded postings (docid 0 = padding).

    The postings are a run of segments of distinct ascending docids (one
    per query term); each docid's weights are summed in input order.
    ``offsets`` are the segments' bounds [0, ..., M] on the host, where the
    caller knows them; None finds them from the data (the maximal
    ascending runs, which costs a device-to-host copy on the card)."""
    if offsets is None:
        offsets = segment_offsets(docids)
    if not docids.is_cuda:
        return score_ref(docids, weights, n_docs, offsets)
    bounds = torch.tensor(offsets, dtype=torch.int32).to(docids.device)
    return score_kernel(docids, weights, n_docs, bounds)


from .. import registry  # noqa: E402

registry.register(registry.KernelSpec(
    name="topk_score", fn=score_accumulate, modes=("ranked_tfidf", "bm25"),
    description="deterministic scatter-add of posting weights into the dense "
                "docid score vector, one CUDA block per 512-docid tile"))
