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

from .blockstore import _OFF_NPTR
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
