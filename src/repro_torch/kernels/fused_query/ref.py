"""Plain PyTorch version of the fused decode→score→top-k query kernel.

:func:`fused_tile` computes, for a batch of queries over a tuple of packed
image *parts* (frozen, then delta), exactly what the CUDA kernel
(``csrc/fused_query.cu``) computes:

  1. Double-VByte decode of every packed chain block
     (``core.device_index.decode_blocks``, Algorithm 2's escape pairing in
     closed form);
  2. docid reconstruction: in-block d-gap sums plus segmented sums of each
     block's leading b-gap along its term segment; frozen segments carry
     the ``dnum0 = -1`` sentinel (absolute chains), delta segments start
     from ``lastd0``/``dnum0``;
  3. weights ``log1p(f)·widf`` or BM25 (k1 = 0.9, b = 0.4);
  4. accumulation into a dense ``(Q, cap+1)`` array, one term segment at a
     time (term-major, the kernel's order too, so both add the same floats
     in the same order);
  5. tombstone masking by select, then the top ``kk = min(k, cap+1)``
     entries in canonical order (score descending, docid ascending), or the
     conjunctive bitmap.

It runs on the CPU for the tests and a CPU-resident engine, and on CUDA
tensors only where ``chip_smoke.py`` holds the kernel against it.
"""

from __future__ import annotations

import torch

from ...core.device_index import _cumsum32, _shift_right, decode_blocks

BM25_K1 = 0.9
BM25_B = 0.4


def _part_postings(part, F: int):
    """Decode one packed image part into per-posting (docid, f, valid, widf).

    ``part`` is (gat, start, end, seg, lastd0, dnum0, widf): gat (Q, PB, B)
    packed chain blocks (term-major per query), seg (Q, PB) the owning
    term's segment id (pad slots carry their own id), lastd0/dnum0/widf
    (Q, PB) the owning term's chaining bases and idf weight per slot.
    """
    gat, start, end, seg, lastd0, dnum0, widf = part
    Q, PB, B = gat.shape
    g, f, valid = decode_blocks(
        gat.reshape(Q * PB, B), start.reshape(-1), end.reshape(-1), F)
    g = g.reshape(Q, PB, B)
    f = f.reshape(Q, PB, B)
    valid = valid.reshape(Q, PB, B)
    gv = torch.where(valid, g, 0)
    within = _cumsum32(gv, 2)
    vcum = _cumsum32(valid.to(torch.int32), 2)
    first_gap = torch.where(vcum == 1, gv, 0).amax(dim=2)       # (Q, PB)
    # segments are contiguous runs of slots: the head is where seg changes
    is_head = seg != _shift_right(seg, -1)
    slot = torch.arange(PB, device=seg.device).expand(Q, PB)
    head = torch.cummax(torch.where(is_head, slot, -1), dim=1).values
    fg_head = torch.clamp(torch.gather(first_gap, 1, head), min=0)
    csum = _cumsum32(first_gap, 1)
    s_cum = csum - torch.gather(_shift_right(csum, 0), 1, head)
    dnum_eff = torch.where(dnum0 < 0, fg_head, dnum0)
    block_first = torch.where(is_head, lastd0 + first_gap,
                              dnum_eff + (s_cum - fg_head))
    docid = block_first[:, :, None] + (within - first_gap[:, :, None])
    docid = torch.where(valid, docid, 0)
    seg_post = seg[:, :, None].expand(Q, PB, B)
    return docid, f, valid, widf, seg_post


def _unpack_alive(alive: torch.Tensor, cap: int) -> torch.Tensor:
    """(words,) int32 little-endian liveness bitmask → (cap+1,) bool: bit
    ``d & 31`` of word ``d >> 5`` is document ``d``'s liveness (the int32
    sign extension of ``>>`` leaves the extracted bit unchanged)."""
    idx = torch.arange(cap + 1, dtype=torch.int32, device=alive.device)
    return ((alive[(idx >> 5).long()] >> (idx & 31)) & 1) != 0


def _accumulate(acc: torch.Tensor, docid, vals, seg_post) -> None:
    """Add ``vals`` at ``docid`` one term segment at a time, segments in
    order.  Within a segment every docid is distinct, so each pass is
    order-free, and across passes the adds run term-major — deterministic
    on any device, and the order the CUDA kernel adds in."""
    Q = acc.shape[0]
    d = docid.reshape(Q, -1).long()
    s = seg_post.reshape(Q, -1)
    v = vals.reshape(Q, -1)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    for t in torch.unique(s).tolist():
        acc.scatter_add_(1, d, torch.where(s == t, v, zero))


def fused_tile(parts, nterms, doclens, bm25_norm, *, mode: str, k: int,
               F: int, cap: int, alive=None):
    """Decode → docids → score → select for a batch of queries.

    Args:
      parts: per-image tuples (gat, start, end, seg, lastd0, dnum0, widf) —
        gat (Q, PB_i, B) uint8, start/end/seg/lastd0/dnum0 (Q, PB_i) int32,
        widf (Q, PB_i) float32.
      nterms: (Q,) int32 — live terms per query (conjunctive only).
      doclens: (cap+1,) float32 document lengths (bm25), else shape (1,).
      bm25_norm: (2,) float32 — (k1*(1-b), k1*b/avgdl) (bm25 only).
      mode: "conjunctive" | "ranked_tfidf" | "bm25".
      alive: optional (ceil((cap+1)/32),) int32 packed liveness bitmask.

    Returns ``matches (Q, cap+1) bool`` for conjunctive, else
    ``(top_d (Q, kk) int32, top_s (Q, kk) float32)`` with kk = min(k, cap+1)
    in canonical order (score descending, docid ascending).
    """
    Q = parts[0][0].shape[0]
    dev = parts[0][0].device
    if mode == "conjunctive":
        hits = torch.zeros((Q, cap + 1), dtype=torch.int32, device=dev)
        for part in parts:
            docid, _f, valid, _w, _s = _part_postings(part, F)
            hits.scatter_add_(1, docid.reshape(Q, -1).long(),
                              valid.reshape(Q, -1).to(torch.int32))
        nt = nterms[:, None]
        matches = (hits == nt) & (nt > 0)
        if alive is not None:
            matches = matches & _unpack_alive(alive, cap)[None, :]
        matches[:, 0] = False
        return matches
    score = torch.zeros((Q, cap + 1), dtype=torch.float32, device=dev)
    for part in parts:
        docid, f, valid, widf, seg_post = _part_postings(part, F)
        fv = torch.where(valid, f, 0).to(torch.float32)
        if mode == "bm25":
            dl = doclens[docid.long()]
            tf = (fv * (BM25_K1 + 1.0)) / (
                fv + bm25_norm[0] + bm25_norm[1] * dl)
            w = tf * widf[:, :, None]
        else:
            w = torch.log1p(fv) * widf[:, :, None]
        w = torch.where(valid, w, 0.0)
        _accumulate(score, docid, w, seg_post)
    if alive is not None:
        # mask by select, not multiply: inf * 0 would poison with nan
        score = torch.where(_unpack_alive(alive, cap)[None, :], score, 0.0)
    # a stable descending sort keeps the smaller docid first among equal
    # scores: the canonical order (torch.topk promises no tie order)
    top_s, top_d = torch.sort(score, dim=1, descending=True, stable=True)
    kk = min(k, cap + 1)
    return top_d[:, :kk].to(torch.int32), top_s[:, :kk].contiguous()
