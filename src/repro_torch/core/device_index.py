"""Device-resident images of the immediate-access index, as torch tensors.

The collated index array (§5.5 makes every chain contiguous) is uploaded as
flat tensors on an explicit ``torch.device``; the fused query kernel
(``kernels/fused_query``) then gathers each query term's chain blocks from it
and decodes, scores and selects in one launch.

Two images cooperate (``engine/device_backend.py``):

  * :class:`DeviceIndex` — the frozen collated snapshot, uploaded once per
    freeze (``Engine.collate_now``);
  * :class:`DeltaIndex` — only the blocks appended (or still filling) since
    that freeze, rebuilt per refresh at a cost proportional to the delta.

Docids are ordinal and each document's postings are written before the next
document starts, so docs <= the freeze's N live wholly in the frozen image
and newer docs wholly in the delta: the two docid spaces are disjoint and
merging them inside one accumulator is exact.

Delta change detection compares *append-only* per-term counts (the store's
head-block f_t, or the engine's append counter) against the freeze
baseline's store f_t.  The live f_t, which deletes decrement, must never be
used for it: a term whose deletes and adds cancel out would look unchanged
and its new postings would never reach the device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .blockstore import _OFF_NPTR, H
from .collate import is_collated
from .dvbyte import dvbyte_decode_from
from .index import DynamicIndex


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; asking for CUDA where there is none raises
    instead of silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device is CUDA but no CUDA device is available; pass "
            "device='cpu' to run the device path's plain version on the CPU")
    return dev


def _i32(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)


@dataclass
class DeviceIndex:
    """Flat-tensor snapshot of a collated doc-level dynamic index."""

    blocks: torch.Tensor      # (NB, B) uint8 — the index array I
    term_slot: torch.Tensor   # (V,) i32 — first slot of each term's chain
    term_nblk: torch.Tensor   # (V,) i32 — chain length in blocks
    term_skip: torch.Tensor   # (V,) i32 — byte offset of postings in head
    term_nx: torch.Tensor     # (V,) i32 — tail write cursor (bytes)
    term_ft: torch.Tensor     # (V,) i32 — document frequency f_t
    num_docs: int             # docid capacity
    F: int                    # fold threshold

    @property
    def device(self) -> torch.device:
        return self.blocks.device


def build_device_image(index: DynamicIndex, vocab: list[bytes],
                       pad_blocks: int | None = None,
                       device=None) -> DeviceIndex:
    """Snapshot a *collated, Const-mode, doc-level* index onto ``device``
    (None means the card; see :func:`resolve_device`)."""
    device = resolve_device(device)
    store = index.store
    if not store.const_mode:
        raise ValueError("device images require Const blocks (B-addressable)")
    if index.word_level:
        raise ValueError("device images are doc-level")
    if not is_collated(index):
        raise ValueError("collate() the index before snapshotting (§5.5)")
    B = store.B
    V = len(vocab)
    slot = np.zeros(V, np.int32)
    nblk = np.zeros(V, np.int32)
    skip = np.zeros(V, np.int32)
    nxs = np.zeros(V, np.int32)
    fts = np.zeros(V, np.int32)
    for i, t in enumerate(vocab):
        h_ptr = index.lookup(t)
        if h_ptr is None:
            continue
        hb = h_ptr * B
        # collated: the chain is the contiguous run [h_ptr, t_ptr]
        slot[i] = h_ptr
        nblk[i] = store.get_tptr(hb) - h_ptr + 1
        skip[i] = store.head_fixed + int(store.I[hb + store.head_fixed - 1])
        nxs[i] = store.get_nx(hb)
        fts[i] = store.get_ft(hb)
    nb = store.nblocks
    if pad_blocks is not None:
        nb = max(nb, pad_blocks)
    blocks = np.zeros((nb, B), np.uint8)
    blocks[: store.nblocks] = store.I[: store.nblocks * B].reshape(-1, B)
    return DeviceIndex(
        blocks=torch.from_numpy(blocks).to(device),
        term_slot=_i32(slot, device), term_nblk=_i32(nblk, device),
        term_skip=_i32(skip, device), term_nx=_i32(nxs, device),
        term_ft=_i32(fts, device), num_docs=index.num_docs, F=index.F)


@dataclass
class DeltaBaseline:
    """Per-term tail state captured at freeze time (host-side numpy).

    For each term id the delta decoder later needs: which block was the tail
    at the freeze (``tail_slot``), where its write cursor stood (``nx``), the
    last docid coded (``lastd`` — new in-tail postings are plain d-gaps from
    it), the tail block's first docid (``dnum`` — blocks appended later code
    their leading b-gap against it), and the store-level ``ft`` (append-only,
    so refresh can detect which terms gained postings).
    """

    tail_slot: np.ndarray   # (Vf,) i64
    nx: np.ndarray          # (Vf,) i64
    lastd: np.ndarray       # (Vf,) i64
    dnum: np.ndarray        # (Vf,) i64
    ft: np.ndarray          # (Vf,) i64
    num_docs: int           # N at freeze time
    nblocks: int            # store.nblocks at freeze time

    @property
    def vocab_size(self) -> int:
        return len(self.tail_slot)


def capture_delta_baseline(index: DynamicIndex,
                           vocab: list[bytes]) -> DeltaBaseline:
    """Record every term's tail state so later appends can be snapshotted
    incrementally.  Called at the same moment the frozen image is built."""
    store = index.store
    if not store.const_mode:
        raise ValueError("delta images require Const blocks")
    if index.word_level:
        raise ValueError("delta images are doc-level")
    V = len(vocab)
    B = store.B
    out = DeltaBaseline(
        tail_slot=np.zeros(V, np.int64), nx=np.zeros(V, np.int64),
        lastd=np.zeros(V, np.int64), dnum=np.zeros(V, np.int64),
        ft=np.zeros(V, np.int64), num_docs=index.num_docs,
        nblocks=store.nblocks)
    for i, t in enumerate(vocab):
        h_ptr = index.lookup(t)
        if h_ptr is None:
            continue
        hb = h_ptr * B
        t_ptr = store.get_tptr(hb)
        out.tail_slot[i] = t_ptr
        out.nx[i] = store.get_nx(hb)
        out.lastd[i] = store.get_lastd(hb)
        # slot 0 of the tail block is d_num while the block IS the tail
        out.dnum[i] = store._get_u32(t_ptr * B + _OFF_NPTR)
        out.ft[i] = store.get_ft(hb)
    return out


@dataclass
class DeltaIndex:
    """Flat-tensor snapshot of postings appended since a DeltaBaseline.

    Shares the block layout of :class:`DeviceIndex` plus two per-term docid
    bases: the first delta posting of a term is a d-gap from
    ``term_lastd0`` if it lands in the old tail block, while blocks appended
    after the freeze code b-gaps chained from ``term_dnum0`` (the old tail's
    first docid).
    """

    blocks: torch.Tensor       # (ND, B) uint8 — compacted delta blocks
    term_slot: torch.Tensor    # (V,) i32 — first delta block per term
    term_nblk: torch.Tensor    # (V,) i32 — delta chain length (0 = unchanged)
    term_skip: torch.Tensor    # (V,) i32 — start byte inside the first block
    term_nx: torch.Tensor      # (V,) i32 — tail write cursor (bytes)
    term_ft: torch.Tensor      # (V,) i32 — f_t used for idf
    term_lastd0: torch.Tensor  # (V,) i32 — last docid coded before the freeze
    term_dnum0: torch.Tensor   # (V,) i32 — first docid of the first delta block
    num_docs: int              # docid-space capacity (not live N)
    F: int                     # fold threshold

    @property
    def device(self) -> torch.device:
        return self.blocks.device


def build_delta_image(index: DynamicIndex, vocab: list[bytes],
                      baseline: DeltaBaseline, *, num_docs: int,
                      pad_vocab: int | None = None,
                      pad_blocks: int | None = None,
                      store_ft: np.ndarray | None = None,
                      device=None) -> DeltaIndex:
    """Snapshot only the blocks appended (or still filling) since ``baseline``
    onto ``device`` (None means the card; see :func:`resolve_device`).

    Cost is proportional to the delta, not the index: unchanged terms
    contribute nothing; changed terms copy their old tail block plus any
    blocks allocated after the freeze, compacted into a fresh block array.

    ``store_ft`` is an APPEND-ONLY per-term-id posting count (the engine's
    append counter, equal to each head's store f_t).  When given, changed
    terms are short-listed with one vectorized comparison against
    ``baseline.ft``; without it, every term pays a lookup and a head read.
    Never pass live (deletion-decremented) counts here.
    """
    device = resolve_device(device)
    store = index.store
    if not store.const_mode:
        raise ValueError("delta images require Const blocks")
    if index.word_level:
        raise ValueError("delta images are doc-level")
    B = store.B
    V = len(vocab)
    Vp = max(V, pad_vocab or 0)
    Vf = baseline.vocab_size
    slot = np.zeros(Vp, np.int32)
    nblk = np.zeros(Vp, np.int32)
    skip = np.zeros(Vp, np.int32)
    nxs = np.zeros(Vp, np.int32)
    fts = np.zeros(Vp, np.int32)
    lastd0 = np.zeros(Vp, np.int32)
    dnum0 = np.zeros(Vp, np.int32)
    if store_ft is not None:
        store_ft = np.asarray(store_ft)
        fts[:V] = store_ft[:V]
        changed = np.flatnonzero(
            np.concatenate([store_ft[:min(Vf, V)] != baseline.ft[:V],
                            np.ones(V - min(Vf, V), bool)]))
        candidates = [(int(i), vocab[int(i)]) for i in changed]
    else:
        candidates = list(enumerate(vocab))
    chunks: list[np.ndarray] = []
    write = 0
    for i, t in candidates:
        h_ptr = index.lookup(t)
        if h_ptr is None:
            continue
        hb = h_ptr * B
        cur_ft = store.get_ft(hb)
        fts[i] = cur_ft
        if i < Vf and cur_ft == baseline.ft[i]:
            continue  # no postings since the freeze
        if i < Vf and baseline.ft[i] > 0:
            first_slot = int(baseline.tail_slot[i])
            skip[i] = int(baseline.nx[i])
            lastd0[i] = int(baseline.lastd[i])
            dnum0[i] = int(baseline.dnum[i])
        else:
            # term born after the freeze: the delta is its whole chain and
            # the head's leading code is an absolute docid (lastd starts 0)
            first_slot = h_ptr
            skip[i] = store.head_fixed + int(store.I[hb + store.head_fixed - 1])
            lastd0[i] = 0
            (g, _), _ = dvbyte_decode_from(store.I, hb + skip[i], store.F)
            dnum0[i] = g  # d_num of the head = its first docid
        # walk old-tail -> current tail via n_ptr links
        t_ptr = store.get_tptr(hb)
        chain = [first_slot]
        p = first_slot
        while p != t_ptr:
            p = store._get_u32(p * B + _OFF_NPTR)
            chain.append(p)
        slot[i] = write
        nblk[i] = len(chain)
        nxs[i] = store.get_nx(hb)
        for ptr in chain:
            chunks.append(store.I[ptr * B:(ptr + 1) * B])
        write += len(chain)
    nd = max(write, pad_blocks or 0, 1)
    blocks = np.zeros((nd, B), np.uint8)
    if chunks:
        blocks[:write] = np.stack(chunks)
    return DeltaIndex(
        blocks=torch.from_numpy(blocks).to(device),
        term_slot=_i32(slot, device), term_nblk=_i32(nblk, device),
        term_skip=_i32(skip, device), term_nx=_i32(nxs, device),
        term_ft=_i32(fts, device), term_lastd0=_i32(lastd0, device),
        term_dnum0=_i32(dnum0, device), num_docs=num_docs, F=index.F)


def with_global_stats(image: DeviceIndex, term_ft: np.ndarray,
                      num_docs: int, pad_vocab: int | None = None
                      ) -> DeviceIndex:
    """Rebase a frozen image's scoring statistics to the LIVE collection.

    Merged frozen+delta querying is only exact if both sides weight postings
    with the same f_t and N; the frozen block tensor stays untouched — only
    the per-term metadata is re-uploaded (and zero-padded so term ids minted
    after the freeze gather empty chains instead of running off the end).
    """
    V = image.term_slot.shape[0]
    Vp = max(V, pad_vocab or 0)

    def pad(x):
        return torch.nn.functional.pad(x, (0, Vp - x.shape[0]))

    ft = np.zeros(Vp, np.int32)
    ft[:min(len(term_ft), Vp)] = term_ft[:Vp]
    return replace(image, term_slot=pad(image.term_slot),
                   term_nblk=pad(image.term_nblk),
                   term_skip=pad(image.term_skip),
                   term_nx=pad(image.term_nx),
                   term_ft=_i32(ft, image.device), num_docs=num_docs)


# --------------------------------------------------------------------------
# the split query path: chain gather, block decode, query_step
# --------------------------------------------------------------------------


_I32_MIN = torch.iinfo(torch.int32).min


def _shift_right(x: torch.Tensor, fill, dim: int = 1) -> torch.Tensor:
    """Shift ``x`` right by one along ``dim``, filling the head."""
    head = torch.full_like(x.narrow(dim, 0, 1), fill)
    return torch.cat([head, x.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def _cumsum32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 prefix sum with int32 wrap-around (torch promotes to int64)."""
    return torch.cumsum(x, dim=dim, dtype=torch.int32)


def decode_blocks(blocks: torch.Tensor, start: torch.Tensor,
                  end: torch.Tensor, F: int):
    """Decode a batch of B-byte blocks of Double-VByte postings.

    Args:
      blocks: (NB, B) uint8
      start:  (NB,) int — first payload byte (head skip or H)
      end:    (NB,) int — one past the last payload byte (nx or B)
      F:      fold threshold
    Returns (g, f, valid), each (NB, B): ``valid[i, j]`` marks byte position
    j as the terminator of a *primary* code in block i, with g/f its decoded
    pair (the first valid pair of each block keeps its b-gap meaning — the
    caller chains docids); g and f are zero wherever ``valid`` is False, and
    a block with ``end <= start`` is all zero.

    Algorithm 2's escape pairing in closed form: a value is *consumed* (it
    completes its predecessor's escape, f = F + v - 1) iff the run of raw
    escape values (v % F == 0) immediately before it has odd length.  This
    is the plain version of the ``dvbyte_decode`` kernel and of the fused
    op's decode.
    """
    b = blocks.to(torch.int32)
    NB, B = b.shape
    pos = torch.arange(B, dtype=torch.int32, device=b.device).expand(NB, B)
    start = start.reshape(NB, 1)
    end = end.reshape(NB, 1)
    inside = (pos >= start) & (pos < end)
    term = ((b & 0x80) == 0) & inside
    prev_term = torch.cummax(torch.where(term, pos, -1), dim=1).values
    code_start = torch.maximum(_shift_right(prev_term, -1) + 1, start)
    pos_in_code = torch.clamp(pos - code_start, 0, 4)
    payload = torch.where(inside, (b & 0x7F) << (7 * pos_in_code), 0)
    csum = _cumsum32(payload, 1)
    prev_csum = torch.cummax(torch.where(term, csum, _I32_MIN), dim=1).values
    prev_csum = torch.clamp(_shift_right(prev_csum, 0), min=0)
    value = torch.where(term, csum - prev_csum, 0)
    is_value = term & (value > 0)
    mod = value % F
    # Algorithm 2 unfold, run-length-parity form
    rank = _cumsum32(is_value.to(torch.int32), 1)
    non_esc = is_value & (mod != 0)
    last_ne = torch.cummax(torch.where(non_esc, rank, 0), dim=1).values
    last_ne = torch.clamp(_shift_right(last_ne, 0), min=0)
    consumed = is_value & (((rank - 1 - last_ne) & 1) == 1)
    primary = is_value & ~consumed
    g = torch.where(primary,
                    torch.where(mod > 0, 1 + value // F, value // F), 0)
    f = torch.where(primary & (mod > 0), mod, 0)
    # a consumed value holds F + v - 1 and completes the escape of the
    # nearest primary before it: patch from the nearest positive at-or-right
    fpatch = torch.where(consumed, F + value - 1, 0)
    nxt = torch.where(fpatch > 0, pos, B)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    held = torch.where(
        nxt < B, torch.gather(fpatch, 1, nxt.clamp(max=B - 1).long()), 0)
    f = torch.where(primary & (f == 0), held, f)
    return g, f, primary


MAX_BLOCKS = 64  # per-term chain-length cap for the gather (pad/truncate)


def gather_chains(image, qterms: torch.Tensor, qmask: torch.Tensor,
                  max_blocks: int):
    """Step 1 of :func:`query_step`: the first ``max_blocks`` blocks of each
    query term's chain (collation makes the chain a contiguous slice).

    Returns ``(blocks (Q·T·max_blocks, B) uint8, start, end)`` with the
    int32 payload bounds of each gathered block: the head starts at the
    term's skip, later blocks after the link pointer; the tail ends at the
    write cursor; blocks past the chain or of masked terms are empty
    (``end = 0``)."""
    B = image.blocks.shape[1]
    dev = image.blocks.device
    flat = qterms.reshape(-1).long()
    slot = image.term_slot[flat]
    nblk = image.term_nblk[flat]
    ar = torch.arange(max_blocks, dtype=torch.int32, device=dev)[None, :]
    bvalid = (ar < nblk[:, None]) & qmask.reshape(-1)[:, None]
    bidx = torch.where(bvalid, slot[:, None] + ar, 0)
    gathered = image.blocks[bidx.reshape(-1).long()]
    start = torch.where(ar == 0, image.term_skip[flat][:, None], H)
    end = torch.where(ar == (nblk - 1)[:, None], image.term_nx[flat][:, None],
                      B)
    end = torch.where(bvalid, end, 0)
    return (gathered, start.reshape(-1).to(torch.int32),
            end.reshape(-1).to(torch.int32))


def _top_k(scores: torch.Tensor, k: int):
    """The top ``k`` of each row in canonical order: score descending, then
    lower index first — a stable descending sort (``torch.topk`` promises
    no tie order)."""
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_s[:, :k].contiguous(), top_i[:, :k]


def query_step(image, qterms: torch.Tensor, qmask: torch.Tensor,
               k: int = 10, mode: str = "ranked",
               max_blocks: int = MAX_BLOCKS, decode_fn=None,
               doclens: torch.Tensor | None = None, n_stat=None,
               avg_stat=None):
    """Batched query execution against one device image (the split path).

    Args:
      image: a :class:`DeviceIndex` or :class:`DeltaIndex`; the only
        difference is docid reconstruction, which chains from the delta's
        per-term bases instead of zero.
      qterms: (Q, T) int term ids (padded);  qmask: (Q, T) bool.
      mode: "ranked" (top-k TF×IDF, dense accumulator), "ranked_sparse"
        (top-k TF×IDF, sort-based), "bm25" (top-k BM25, sort-based —
        requires ``doclens`` (N+1,) float32), or "conjunctive" (hit
        bitmap).
      max_blocks: per-term chain cap of the gather.
      decode_fn: ``decode_fn(blocks, start, end, F) -> (g, f, valid)``.
        None takes the ``dvbyte_decode`` op: its CUDA kernel for an image on
        the card, :func:`decode_blocks` for one on the CPU.
      n_stat: collection size for idf/avgdl (default ``image.num_docs``).
      avg_stat: average document length for BM25 (default
        ``doclens[1:].sum() / n_stat``).

    Returns ``(top docids (Q, k') int32, top scores (Q, k') float32)`` in
    canonical order (score descending, docid ascending) for ranked modes,
    or ``(matches (Q, N) bool, counts (Q,))`` for conjunctive mode; matches
    column j is docid j + 1.

    Mode "ranked" is not bit-reproducible on the card: its dense
    accumulation is a scatter-add with float atomics, which sum a docid's
    weights in a different order from run to run.  Callers compare its
    scores with a tolerance.  The sort-based modes fix the order (a stable
    sort), and the CPU is deterministic in every mode.
    """
    dev = image.blocks.device
    qterms = qterms.to(dev)
    qmask = qmask.to(dev)
    B = image.blocks.shape[1]
    Q, T = qterms.shape
    QT = Q * T
    # ---- step 1: contiguous chain gather ----
    gathered, start, end = gather_chains(image, qterms, qmask, max_blocks)
    # ---- step 2: block decode ----
    if decode_fn is None:
        from ..kernels.dvbyte_decode.ops import dvbyte_decode_blocks
        decode_fn = dvbyte_decode_blocks
    g, f, valid = decode_fn(gathered, start, end, image.F)
    g = g.reshape(QT, max_blocks, B)
    f = f.reshape(QT, max_blocks, B)
    valid = valid.reshape(QT, max_blocks, B)
    # ---- step 3: docid reconstruction ----
    gv = torch.where(valid, g, 0)
    within = _cumsum32(gv, 2)                        # in-block gap sums
    # each block's leading value is a b-gap (the head's is absolute, as
    # last_d starts at 0): chain first-docids = prefix sums of first gaps
    first_gap = torch.where(_cumsum32(valid.to(torch.int32), 2) == 1, gv,
                            0).amax(dim=2)           # (QT, MB)
    flat = qterms.reshape(-1).long()
    if isinstance(image, DeltaIndex):
        # the first delta block's leading code is a d-gap from lastd0 (it
        # continues the old tail); later blocks chain b-gaps from dnum0
        cum = _cumsum32(first_gap, 1)
        bf0 = image.term_lastd0[flat][:, None] + first_gap[:, :1]
        bfr = image.term_dnum0[flat][:, None] + (cum - first_gap[:, :1])
        block_first = torch.cat([bf0, bfr[:, 1:]], dim=1)
    else:
        block_first = _cumsum32(first_gap, 1)        # absolute first docids
    docid = block_first[:, :, None] + (within - first_gap[:, :, None])
    docid = torch.where(valid, docid, 0)             # (QT, MB, B)
    # ---- step 4: scoring ----
    N = image.num_docs
    f32 = dict(dtype=torch.float32, device=dev)
    Ns = torch.tensor(float(N if n_stat is None else n_stat), **f32)
    flat_docs = docid.reshape(Q, -1)
    if mode == "conjunctive":
        hits = torch.zeros((Q, N + 1), dtype=torch.int32, device=dev)
        hits.scatter_add_(1, flat_docs.long(),
                          valid.reshape(Q, -1).to(torch.int32))
        nterms = qmask.sum(dim=1)
        matches = (hits[:, 1:] == nterms[:, None]) & (nterms[:, None] > 0)
        return matches, matches.sum(dim=1)
    ft = torch.clamp(image.term_ft[flat], min=1).to(torch.float32)
    qmf = qmask.reshape(-1).to(torch.float32)
    fv = torch.where(valid, f, 0).to(torch.float32)
    if mode == "bm25":
        # Okapi BM25 (k1 = 0.9, b = 0.4): saturated tf, length-normalised
        k1, b = 0.9, 0.4
        idf = (torch.log1p((Ns - ft + 0.5) / (ft + 0.5)) * qmf).reshape(Q, T)
        dl = doclens.to(**f32)[flat_docs.long()]           # (Q, P)
        avgdl = (torch.clamp(doclens[1:].to(**f32).sum() / Ns, min=1e-9)
                 if avg_stat is None
                 else torch.clamp(torch.tensor(float(avg_stat), **f32),
                                  min=1e-9))
        fv = fv.reshape(Q, -1)
        tf = (fv * (k1 + 1.0)) / (fv + k1 * (1.0 - b + b * dl / avgdl))
        w = (tf.reshape(Q, T, max_blocks, B)
             * idf[:, :, None, None]).reshape(Q, -1)
    else:
        idf = (torch.log1p(Ns / ft) * qmf).reshape(Q, T)
        w = torch.log1p(fv).reshape(Q, T, max_blocks, B)
        w = (w * idf[:, :, None, None]).reshape(Q, -1)
    if mode in ("ranked_sparse", "bm25"):
        # sort-based sparse aggregation: O(P log P) on the P posting slots
        # instead of a (Q, N) accumulator.  A stable sort keeps each docid's
        # postings in term order; each run is summed exactly (float64 prefix
        # sums of float32 weights) and rounded once
        d_s, order = torch.sort(flat_docs, dim=1, stable=True)
        w_s = torch.gather(w, 1, order)
        csum = torch.cumsum(w_s.to(torch.float64), dim=1)
        P = d_s.shape[1]
        is_end = d_s != _shift_right(d_s.flip(1), -1).flip(1)   # run ends
        pos = torch.arange(P, device=dev).expand(Q, P)
        prev_end = _shift_right(torch.cummax(
            torch.where(is_end, pos, -1), dim=1).values, -1)
        prev_csum = torch.where(
            prev_end >= 0, torch.gather(csum, 1, prev_end.clamp(min=0)), 0.0)
        run_score = torch.where(is_end & (d_s > 0),
                                (csum - prev_csum).to(torch.float32),
                                float("-inf"))
        # k may exceed the slot count: distinct scored docids never do
        top_s, pos_k = _top_k(run_score, min(k, P))
        return torch.gather(d_s, 1, pos_k).to(torch.int32), top_s
    scores = torch.zeros((Q, N + 1), **f32)
    scores.scatter_add_(1, flat_docs.long(), w)
    scores[:, 0] = float("-inf")
    top_s, top_d = _top_k(scores, min(k, N + 1))
    return top_d.to(torch.int32), top_s
