"""Device backend: resident frozen image + incrementally refreshed delta.

Re-running ``collate()`` + ``build_device_image()`` on every ingest would be
stop-the-world and break the paper's immediate-access property.  The
:class:`ResidentImageManager` instead keeps, on the engine's device:

  * a **resident frozen image**: the collated snapshot from the last full
    collation (``Engine.collate_now``), uploaded ONCE per freeze epoch —
    its block tensor stays on the device across queries and refreshes; only
    the per-term statistics are rebased to the live collection at each
    refresh (``with_global_stats``);
  * a **delta image**: a :class:`~repro_torch.core.device_index.DeltaIndex`
    of only the blocks appended since the freeze, kept by a
    :class:`~repro_torch.core.device_index.DeltaBuilder` that walks on only
    the chains an ingest moved since the last refresh (host cost ∝ the
    terms touched, plus one gather of the delta's blocks);

and :class:`DeviceBackend` answers each (mode, k) group of queries with ONE
launch of the fused decode→score→top-k op (``kernels/fused_query``) over
both images.  The op runs the CUDA kernel when the engine lives on the card
and its plain PyTorch version when it lives on the CPU.  Frozen and delta
docid spaces are disjoint, so merging them inside one accumulator is exact.

Delta change detection reads the engine's APPEND-ONLY per-term counts
(``Engine._appended_fts``), never the live f_t that deletes decrement: a
term whose deletes and adds cancel out since the freeze must still ship its
new postings.

**Delta-compaction policy** (fragmentation threshold): a refresh whose
*projected* delta — new blocks since the freeze plus one copied tail block
per changed term — exceeds both an absolute floor and a fraction of the
store falls back to a full collation first, since past that point a
collation costs less than carrying the delta.

Capacities are bucketed (vocabulary and docid capacity round up to powers
of two), so the frozen image's metadata is re-padded only when a bucket
grows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device_index import (
    DeltaBuilder,
    DeviceIndex,
    build_device_image,
    capture_delta_baseline,
    query_step,
    with_global_stats,
)
from ..kernels import registry
from .backends import Backend, UnsupportedQueryError
from .types import POSITIONAL_MODES, Query, QueryResult


def _pow2(n: int, floor: int = 1) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


class ResidentImageManager:
    """Owns the device-resident (frozen, delta) image pair for one engine.

    ``frozen_uploads`` bumps only at freeze (collation) time while
    ``batches_served`` bumps per fused launch — steady-state serving shows
    many batches per upload.  ``decode_fn`` is the block decode of the
    split path (``DeviceBackend(use_fused=False)``); None takes the
    ``dvbyte_decode`` op.
    """

    def __init__(self, engine, decode_fn=None):
        self.engine = engine
        self.decode_fn = decode_fn
        self._frozen_raw: DeviceIndex | None = None   # as built at freeze
        self._frozen_nblk: np.ndarray | None = None   # host copy, per term
        self._baseline = None                          # DeltaBaseline
        self._builder = None                           # DeltaBuilder
        self._frozen = None     # writer_only — stats-rebased frozen image
        self._delta = None              # writer_only — DeltaIndex
        self._doclens = None            # (cap+1,) f32 on the device
        self._alive = None              # packed int32 liveness bits or None
        self._n_stat = None
        self._avg_stat = None
        self._synced_version = -1       # writer_only
        self._nblk_np = None    # writer_only — host (frozen, delta)
        #                         chain sizes
        self._frozen_mb = 1             # split path's chain cap, frozen
        self._delta_mb = 1              # split path's chain cap, delta
        self._doc_cap = 1024
        self._vocab_cap = 64
        self.epoch = 0                  # freeze epochs seen
        self.frozen_uploads = 0         # resident-image uploads
        self.batches_served = 0         # fused launches

    # ------------------------------------------------------------------
    # image lifecycle
    # ------------------------------------------------------------------

    def freeze(self, collated=None) -> None:
        """Adopt a collated image of the engine's index as the frozen image
        and rebase the delta to empty — the ONLY point at which the full
        block array is uploaded.  ``collated`` None takes the engine's own
        index, just collated by ``Engine.collate_now``; a snapshot restore
        passes a collated copy and keeps the restored layout live.  The
        delta baseline is always captured from the live index."""
        eng = self.engine
        self._frozen_raw = build_device_image(
            eng.index if collated is None else collated, eng.vocab,
            device=eng.device)
        self._frozen_nblk = self._frozen_raw.term_nblk.cpu().numpy()
        self._frozen_mb = _pow2(int(self._frozen_nblk.max())
                                if len(self._frozen_nblk) else 1)
        self._baseline = capture_delta_baseline(eng.index, eng.vocab)
        self._builder = DeltaBuilder(eng.index, self._baseline)
        self._nblk_np = None       # the delta is empty until the next refresh
        self._frozen = None        # stale metadata: rebuild from _frozen_raw
        self._synced_version = -1  # force a refresh before the next query
        self.epoch += 1
        self.frozen_uploads += 1
        eng.stats_counters.resident_uploads += 1

    def _projected_delta_blocks(self, appended: np.ndarray) -> int:
        """Upper bound of the delta a refresh would build: blocks allocated
        since the freeze + one copied tail block per changed term."""
        base = self._baseline
        store = self.engine.index.store
        Vf = min(base.vocab_size, len(appended))
        changed = int(np.count_nonzero(appended[:Vf] != base.ft[:Vf]))
        changed += int(np.count_nonzero(appended[Vf:] > 0))
        return (store.nblocks - base.nblocks) + changed

    def _maybe_compact(self, appended: np.ndarray) -> bool:
        """Fall back to a full collation when the projected delta exceeds
        both the absolute block floor and the store fraction."""
        eng = self.engine
        frac = eng.delta_compact_frac
        if frac is None or self._baseline is None:
            return False
        projected = self._projected_delta_blocks(appended)
        total = max(1, eng.index.store.nblocks)
        if (projected <= eng.delta_compact_min_blocks
                or projected <= frac * total):
            return False
        eng.collate_now()          # re-freezes: baseline + resident image
        eng.stats_counters.delta_compactions += 1
        return True

    def refresh(self) -> bool:
        """Incremental device-image refresh: snapshot only post-freeze
        blocks.  Returns True if anything was rebuilt."""
        eng = self.engine
        if self._synced_version == eng.version:
            return False
        if not eng.device_capable:
            raise UnsupportedQueryError(
                "device images need a Const-mode doc-level index")
        dev = eng.device
        if self._baseline is None:
            # never collated: an empty baseline makes the delta cover the
            # whole index, so the device path works before any collation
            self._frozen_raw = _empty_image(eng)
            self._frozen_nblk = np.zeros(0, np.int32)
            self._baseline = capture_delta_baseline(eng.index, [])
            self._builder = DeltaBuilder(eng.index, self._baseline)
        appended = np.asarray(eng._appended_fts, dtype=np.int64)
        self._maybe_compact(appended)
        N = eng.index.num_docs
        doc_cap = max(self._doc_cap, _pow2(N + 1))
        vocab_cap = max(self._vocab_cap, _pow2(len(eng.vocab)))
        # scoring statistics: in a fleet, N, f_t and avgdl are the
        # COLLECTION's (the fleet's stats provider); with tombstones
        # outstanding they are the engine's live counters — either way
        # both images must weight their postings with the SAME f_t (exact
        # merge).  Change detection above and below reads ``appended``
        # alone: the fleet's f_t moves with every fleet ingest and delete,
        # and the live local f_t with every delete (a term whose deletes
        # and adds cancel would look unchanged)
        stats = eng.ranking_stats()
        fts = eng.global_fts()
        if (self._frozen is None or doc_cap != self._doc_cap
                or vocab_cap != self._vocab_cap):
            self._frozen = with_global_stats(self._frozen_raw, fts, doc_cap,
                                             pad_vocab=vocab_cap)
        else:
            self._frozen = with_global_stats(self._frozen, fts, doc_cap)
        self._doc_cap, self._vocab_cap = doc_cap, vocab_cap
        delta = self._builder.build(eng.vocab, appended, num_docs=doc_cap,
                                    pad_vocab=vocab_cap, device=dev)
        if stats is not None:
            # fleet or deletion-aware mode: the collection-wide / live f_t
            # replaces the baked store f_t
            ftp = np.zeros(int(delta.term_ft.shape[0]), np.int32)
            ftp[:min(len(fts), len(ftp))] = fts[:len(ftp)]
            delta.term_ft = torch.from_numpy(ftp).to(dev)
        self._delta = delta
        # host copies of both images' per-term chain sizes: fused_execute
        # sizes each launch's packed block pool from the batch's chains
        frozen_nblk = np.zeros(vocab_cap, np.int32)
        frozen_nblk[:len(self._frozen_nblk)] = self._frozen_nblk
        self._nblk_np = (frozen_nblk, delta.term_nblk.cpu().numpy())
        self._delta_mb = _pow2(int(self._nblk_np[1].max())
                               if len(self._nblk_np[1]) else 1)
        dl = np.zeros(doc_cap + 1, np.float32)
        dl[1:N + 1] = eng.doclens_array()[1:N + 1]
        self._doclens = torch.from_numpy(dl).to(dev)
        # liveness mask: tombstoned docids score 0 inside the fused op's
        # accumulator; None (no deletes) skips masking entirely.  Packed 1
        # bit/docid in little-endian 32-bit words
        dead = eng.index.tombstones
        if dead:
            al = np.zeros(doc_cap + 1, bool)
            al[1:N + 1] = True
            al[np.fromiter(dead, np.int64, count=len(dead))] = False
            bits = np.packbits(al, bitorder="little")
            if bits.nbytes % 4:
                bits = np.pad(bits, (0, 4 - bits.nbytes % 4))
            self._alive = torch.from_numpy(bits.view(np.int32).copy()).to(dev)
        else:
            self._alive = None
        # the fleet's live N reaches only the score (idf, avgdl): the docid
        # bounds above are this engine's own ``doc_cap``
        if stats is None:
            self._n_stat, self._avg_stat = N, None
        else:
            self._n_stat, self._avg_stat = stats.num_docs, stats.avg_doclen
        self._synced_version = eng.version
        eng.stats_counters.delta_refreshes += 1
        return True

    @property
    def delta_blocks(self) -> int:
        """Live delta size in blocks."""
        if self._nblk_np is None:
            return 0
        return int(self._nblk_np[1].sum())

    @property
    def images(self):
        """The resident (frozen, delta) pair the fused op merges."""
        return (self._frozen, self._delta)

    @property
    def max_blocks(self) -> tuple:
        """Per-image chain caps of the split path, aligned with
        :attr:`images`: the longest chain, rounded up to a power of two, so
        the delta keeps its own small cap."""
        return (self._frozen_mb, self._delta_mb)


def pack_queries(engine, resident: ResidentImageManager,
                 batch: list[Query], mode: str):
    """Resolve one (mode, k) group's terms against the resident images.

    Returns ``(live, qterms, qmask, max_blocks)``: the indices of the
    queries that need the device (conjunctive queries with an unknown term
    are decided empty without it), their padded (Qn, T) term ids and mask
    on the engine's device, and each image's packed pool size — the
    batch's largest per-query total block count, pow2-bucketed.  ``live``
    is empty when nothing needs a launch.
    """
    eng = engine
    tids: list[list[int] | None] = []
    for q in batch:
        ids = [eng.term_id(t) for t in q.terms]
        if mode == "conjunctive" and (None in ids or not ids):
            tids.append(None)
        else:
            tids.append([i for i in ids if i is not None])
    live = [i for i, ids in enumerate(tids) if ids]
    if not live:
        return live, None, None, None
    Qn = _pow2(len(live))
    T = _pow2(max(len(tids[i]) for i in live), floor=4)
    qt = np.zeros((Qn, T), np.int32)
    qm = np.zeros((Qn, T), bool)
    for row, i in enumerate(live):
        ids = tids[i]
        qt[row, :len(ids)] = ids
        qm[row, :len(ids)] = True
    if resident._nblk_np is None:
        resident.refresh()
    caps = []
    for nblk in resident._nblk_np:
        V = nblk.shape[0]
        tot = max((sum(int(nblk[t]) for t in tids[i] if t < V)
                   for i in live), default=0)
        caps.append(_pow2(max(tot, 1), floor=8))
    dev = eng.device
    return (live, torch.from_numpy(qt).to(dev), torch.from_numpy(qm).to(dev),
            tuple(caps))


def serve_groups(resident: ResidentImageManager, queries: list[Query],
                 run) -> list[QueryResult]:
    """Refresh the resident images, then answer ``queries`` one (mode, k)
    group at a time: ``run(batch, mode, k)`` returns the batch's results in
    order.  Positional modes need a word-level index and are refused."""
    if any(q.mode in POSITIONAL_MODES for q in queries):
        raise UnsupportedQueryError(
            "the device images serve no positional query mode")
    # the one place the images refresh: on the thread that executes
    # queries (a service's flush, after its ingest pipeline's drain, or a
    # fleet's fan-out pool inside that flush); ingest writer threads touch
    # host state only
    resident.refresh()
    out: list[QueryResult | None] = [None] * len(queries)
    groups: dict[tuple[str, int], list[int]] = {}
    for i, q in enumerate(queries):
        groups.setdefault((q.mode, q.k), []).append(i)
    for (mode, k), idxs in groups.items():
        for i, r in zip(idxs, run([queries[i] for i in idxs], mode, k)):
            out[i] = r
    return out  # type: ignore[return-value]


def fused_execute(engine, resident: ResidentImageManager,
                  batch: list[Query], mode: str, k: int, *,
                  name: str = "device") -> list[QueryResult]:
    """Answer one (mode, k) query group with a single fused launch over the
    resident images."""
    N = engine.index.num_docs
    results = [QueryResult.empty(mode, name) for _ in batch]
    live, qt, qm, caps = pack_queries(engine, resident, batch, mode)
    if not live:
        return results
    spec = registry.get("fused_query")
    out = spec.fn(resident.images, qt, qm, mode=mode, k=k, max_blocks=caps,
                  doclens=resident._doclens if mode == "bm25" else None,
                  n_stat=resident._n_stat, avg_stat=resident._avg_stat,
                  alive=resident._alive)
    resident.batches_served += 1
    if mode == "conjunctive":
        matches = out.cpu().numpy()
        for row, i in enumerate(live):
            d = np.flatnonzero(matches[row, 1:]) + 1
            results[i] = QueryResult(d[d <= N].astype(np.int64), None, name)
        return results
    alld, alls = out[0].cpu().numpy(), out[1].cpu().numpy()
    for row, i in enumerate(live):
        d, s = alld[row], alls[row]
        keep = (s > 0) & (d > 0)   # already in canonical order
        results[i] = QueryResult(d[keep].astype(np.int64),
                                 s[keep].astype(np.float64), name)
    return results


class DeviceBackend(Backend):
    """The device path over the engine's resident frozen+delta images.

    ``use_fused=True`` (the default) answers each (mode, k) group with one
    ``fused_query`` launch over both images.  ``use_fused=False`` takes the
    split path: one :func:`~repro_torch.core.device_index.query_step` per
    image (its block decode is the ``dvbyte_decode`` kernel on the card),
    merged on the host — the counterpart of the reference's legacy path."""

    name = "device"

    def __init__(self, engine, resident: ResidentImageManager,
                 use_fused: bool = True):
        super().__init__(engine)
        self.resident = resident
        self.use_fused = use_fused

    def execute(self, query: Query) -> QueryResult:
        return self.execute_many([query])[0]

    def execute_many(self, queries: list[Query]) -> list[QueryResult]:
        run = self._run_group_fused if self.use_fused else \
            self._run_group_split
        return serve_groups(self.resident, queries, run)

    def _run_group_fused(self, batch: list[Query], mode: str,
                         k: int) -> list[QueryResult]:
        return fused_execute(self.engine, self.resident, batch, mode, k,
                             name=self.name)

    def _run_group_split(self, batch: list[Query], mode: str,
                         k: int) -> list[QueryResult]:
        """One ``query_step`` per image, merged on the host."""
        eng = self.engine
        mgr = self.resident
        if eng.index.tombstones:
            # each image's top k is cut BEFORE any tombstone mask could
            # apply, so a dead doc could evict a live one from an image's
            # k; the fused path masks inside the accumulator — delegate to
            # it whenever deletes are outstanding
            return fused_execute(eng, mgr, batch, mode, k, name=self.name)
        N = eng.index.num_docs
        results = [QueryResult.empty(mode, self.name) for _ in batch]
        live, qt, qm, _caps = pack_queries(eng, mgr, batch, mode)
        if not live:
            return results
        kw = dict(decode_fn=mgr.decode_fn, n_stat=mgr._n_stat,
                  avg_stat=mgr._avg_stat)
        if mode == "conjunctive":
            mf, md = (query_step(img, qt, qm, k=1, mode="conjunctive",
                                 max_blocks=mb, **kw)[0]
                      for img, mb in zip(mgr.images, mgr.max_blocks))
            matches = (mf | md).cpu().numpy()
            for row, i in enumerate(live):
                d = np.flatnonzero(matches[row]) + 1
                results[i] = QueryResult(d[d <= N].astype(np.int64), None,
                                         self.name)
            return results
        qmode = "bm25" if mode == "bm25" else "ranked"
        dl = mgr._doclens if mode == "bm25" else None
        parts = [query_step(img, qt, qm, k=k, mode=qmode, max_blocks=mb,
                            doclens=dl, **kw)
                 for img, mb in zip(mgr.images, mgr.max_blocks)]
        alld = torch.cat([p[0] for p in parts], dim=1).cpu().numpy()
        alls = torch.cat([p[1] for p in parts], dim=1).cpu().numpy()
        for row, i in enumerate(live):
            d, s = alld[row], alls[row]
            keep = (s > 0) & (d > 0)
            d, s = d[keep], s[keep]
            order = np.argsort(-s, kind="stable")[:k]
            results[i] = QueryResult(d[order].astype(np.int64),
                                     s[order].astype(np.float64), self.name)
        return results


def _empty_image(engine) -> DeviceIndex:
    """A zero-term frozen image (pre-first-collation state)."""
    dev = engine.device
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    return DeviceIndex(
        blocks=torch.zeros((1, engine.index.store.B), dtype=torch.uint8,
                           device=dev),
        term_slot=z, term_nblk=z, term_skip=z, term_nx=z, term_ft=z,
        num_docs=0, F=engine.index.F)
