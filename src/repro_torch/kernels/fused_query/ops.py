"""Public entry point of the fused decode→score→top-k query op.

:func:`fused_query` answers a whole query batch against one or more
device-resident images (the frozen :class:`DeviceIndex` plus the post-freeze
:class:`DeltaIndex`) in a single launch per (mode, k) group:

  1. *prep* (:func:`prepare`, torch gathers and prefix sums on the images'
     device): per image, every query's live terms' chain blocks are packed
     term-major into a (Q, PB_i, B) *part* whose slots carry the owning
     term's segment id, docid-chaining bases and idf weight.  Each image
     keeps its own packed capacity PB_i, sized by the caller to the batch's
     largest per-query block total, so nobody pays for the vocabulary's
     longest chain;
  2. *fused compute*: decode → docids → score → select in one launch of the
     CUDA kernel (``kernel.py``) when the images live on a CUDA device, or
     the plain PyTorch version (``ref.py``) when they live on the CPU.

Merging images inside the launch is exact: frozen and delta docid spaces
are disjoint and both sides weight postings with the same f_t.
"""

from __future__ import annotations

import torch

from ...core.blockstore import H
from ...core.device_index import DeltaIndex
from .kernel import fused_query_kernel
from .ref import BM25_B, BM25_K1, fused_tile

#: Modes the fused op serves (positional modes need word positions, which
#: device images do not model).
FUSED_MODES = ("conjunctive", "ranked_tfidf", "bm25")


def _prep_image(image, qterms, qmask, Ns, max_blocks: int, mode: str):
    """Pack one image's chain blocks: (Q, PB, B) slots + per-slot metadata."""
    Q, T = qterms.shape
    PB = max_blocks
    B = image.blocks.shape[1]
    dev = image.blocks.device
    flat = qterms.reshape(-1).long()
    slot = image.term_slot[flat].reshape(Q, T)
    nblk = torch.where(qmask, image.term_nblk[flat].reshape(Q, T), 0)
    skip = image.term_skip[flat].reshape(Q, T)
    nx = image.term_nx[flat].reshape(Q, T)
    # term-major packing: slot s of query q belongs to the last term whose
    # exclusive block offset is <= s (empty terms yield no slots)
    off = torch.cumsum(nblk, dim=1, dtype=torch.int32) - nblk
    total = off[:, -1] + nblk[:, -1]
    s = torch.arange(PB, dtype=torch.int32, device=dev)[None, :]
    t_of = ((s[:, :, None] >= off[:, None, :]).sum(dim=2) - 1).long()
    within = s - torch.gather(off, 1, t_of)
    valid = s < total[:, None]
    slot_s = torch.gather(slot, 1, t_of)
    nblk_s = torch.gather(nblk, 1, t_of)
    bidx = torch.where(valid, slot_s + within, 0)
    gat = image.blocks[bidx.reshape(-1).long()].reshape(Q, PB, B)
    is_head = within == 0
    is_tail = within == nblk_s - 1
    start = torch.where(is_head, torch.gather(skip, 1, t_of), H)
    end = torch.where(is_tail, torch.gather(nx, 1, t_of), B)
    end = torch.where(valid, end, 0)
    seg = torch.where(valid, t_of.to(torch.int32), T)   # pad slots: own seg
    if isinstance(image, DeltaIndex):
        lastd0 = image.term_lastd0[flat].reshape(Q, T)
        dnum0 = image.term_dnum0[flat].reshape(Q, T)
        lastd0_s = torch.gather(lastd0, 1, t_of)
        dnum0_s = torch.gather(dnum0, 1, t_of)
    else:
        # frozen segments: absolute chains — the -1 sentinel makes the
        # decoder use the head block's own first gap as the b-gap base
        lastd0_s = torch.zeros((Q, PB), dtype=torch.int32, device=dev)
        dnum0_s = torch.full((Q, PB), -1, dtype=torch.int32, device=dev)
    if mode == "conjunctive":
        widf_s = torch.zeros((Q, PB), dtype=torch.float32, device=dev)
    else:
        ft = torch.clamp(image.term_ft[flat], min=1).to(torch.float32)
        if mode == "bm25":
            widf = torch.log1p((Ns - ft + 0.5) / (ft + 0.5))
        else:
            widf = torch.log1p(Ns / ft)
        widf = (widf * qmask.reshape(-1)).reshape(Q, T)
        widf_s = torch.where(valid, torch.gather(widf, 1, t_of), 0.0)
    return tuple(x.contiguous() for x in
                 (gat, start, end, seg, lastd0_s, dnum0_s, widf_s))


def prepare(images, qterms, qmask, *, mode: str, max_blocks,
            doclens=None, n_stat: float | None = None,
            avg_stat: float | None = None, alive=None) -> dict:
    """Everything the fused compute consumes, on the images' device:
    ``parts``, ``nterms``, ``doclens``, ``bm25_norm``, ``alive`` plus the
    static ``F`` and ``cap`` — the keyword arguments of both
    :func:`ref.fused_tile` and :func:`kernel.fused_query_kernel`."""
    if mode not in FUSED_MODES:
        raise ValueError(f"unsupported fused mode {mode!r}")
    head = images[0]
    cap: int = head.num_docs      # the images' docid capacity, a host int
    dev = head.blocks.device
    if isinstance(max_blocks, int):
        max_blocks = (max_blocks,) * len(images)
    f32 = dict(dtype=torch.float32, device=dev)
    Ns = torch.tensor(float(cap if n_stat is None else n_stat), **f32)
    qterms = qterms.to(dev)
    qmask = qmask.to(dev)
    parts = tuple(_prep_image(img, qterms, qmask, Ns, mb, mode)
                  for img, mb in zip(images, max_blocks))
    nterms = qmask.sum(dim=1).to(torch.int32)
    if mode == "bm25":
        dl = doclens.to(**f32)
        avgdl = (torch.clamp(dl[1:].sum() / Ns, min=1e-9) if avg_stat is None
                 else torch.clamp(torch.tensor(float(avg_stat), **f32),
                                  min=1e-9))
        norm = torch.stack([torch.tensor(BM25_K1 * (1.0 - BM25_B), **f32),
                            BM25_K1 * BM25_B / avgdl])
    else:
        norm = torch.zeros(2, **f32)
        dl = torch.zeros(1, **f32)
    return dict(parts=parts, nterms=nterms, doclens=dl.contiguous(),
                bm25_norm=norm, alive=alive, F=head.F, cap=cap)


def fused_query(images, qterms, qmask, *, mode: str = "ranked_tfidf",
                k: int = 10, max_blocks: int | tuple = 64,
                doclens: torch.Tensor | None = None,
                n_stat: int | None = None,
                avg_stat: float | None = None,
                alive: torch.Tensor | None = None):
    """One fused launch answering ``qterms``/``qmask`` against ``images``.

    Args:
      images: tuple of :class:`DeviceIndex`/:class:`DeltaIndex` on one
        device, sharing one docid capacity (``num_docs``) and vocab padding.
      qterms: (Q, T) int padded term ids; qmask: (Q, T) bool.
      mode: one of :data:`FUSED_MODES`.
      max_blocks: per-image packed block capacity (slots per query), a
        tuple aligned with ``images`` (an int is broadcast).
      doclens: (cap+1,) float32 document lengths (bm25 only).
      n_stat / avg_stat: collection statistics for idf / avgdl; default to
        the image capacity / the doclens mean.
      alive: optional (ceil((cap+1)/32),) int32 packed liveness bitmask.

    Returns ``matches (Q, cap+1) bool`` for conjunctive, else
    ``(top_d (Q, kk) int32, top_s (Q, kk) float32)`` in canonical order.
    The images' device picks the compute: CUDA launches the kernel (and
    raises if it cannot), the CPU runs the plain version.
    """
    args = prepare(images, qterms, qmask, mode=mode, max_blocks=max_blocks,
                   doclens=doclens, n_stat=n_stat, avg_stat=avg_stat,
                   alive=alive)
    if images[0].blocks.is_cuda:
        return fused_query_kernel(mode=mode, k=k, **args)
    return fused_tile(mode=mode, k=k, **args)


from .. import registry  # noqa: E402

registry.register(registry.KernelSpec(
    name="fused_query", fn=fused_query, modes=FUSED_MODES,
    description="single-launch decode→score→top-k over resident "
                "frozen+delta images, one CUDA block per docid range "
                "of each query"))
