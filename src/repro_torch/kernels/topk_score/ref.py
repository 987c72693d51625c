"""Plain PyTorch version of the score-accumulation kernel.

:func:`score_ref` builds the dense float32 score vector over docids
[0, n_docs) from (docid, weight) postings, with docid 0 the padding bucket
(zeroed) and docids outside the range dropped — what the CUDA kernel
(``csrc/topk_score.cu``) computes, bit for bit.

The input is a run of *segments*, each holding distinct docids in
ascending order: the kernel backend concatenates its query terms' postings
lists, one segment per term.  Both versions add segment by segment, in
input order, so every docid's weights are summed in the same order and the
results agree exactly; within a segment no docid repeats, so each pass is
order-free.  :func:`segment_offsets` finds the segments as the maximal
ascending runs: any split into runs of distinct docids sums each docid in
input order, so every split gives the same bits.

It runs on the CPU for the tests and the kernel backend of a CPU-resident
engine, and on CUDA tensors only where ``chip_smoke.py`` holds the kernel
against it.
"""

from __future__ import annotations

import torch


def segment_offsets(docids: torch.Tensor) -> list[int]:
    """Bounds [0, ..., M] of the maximal strictly ascending runs."""
    n = docids.numel()
    brk = torch.nonzero(docids[1:] <= docids[:-1]).flatten() + 1
    return [0, *brk.tolist(), n]


def score_ref(docids: torch.Tensor, weights: torch.Tensor, n_docs: int,
              offsets=None) -> torch.Tensor:
    """Dense scores: ``out[d] = Σ weights at d`` in input order, out[0] = 0,
    added one segment at a time: between the bounds ``offsets``, or
    between those :func:`segment_offsets` finds."""
    out = torch.zeros(n_docs, dtype=torch.float32, device=docids.device)
    bounds = segment_offsets(docids) if offsets is None else \
        [int(b) for b in offsets]
    for s, e in zip(bounds[:-1], bounds[1:]):
        d = docids[s:e].long()
        keep = (d >= 0) & (d < n_docs)
        out.index_add_(0, d[keep], weights[s:e][keep])
    if n_docs:
        out[0] = 0.0
    return out
