"""The Engine: one ingest+query front door over the host, device, kernel
and tiered backends.

Owns the live :class:`~repro_torch.core.index.DynamicIndex`, the
document-length array (BM25 state the paper places outside the core index,
§3.6), the term-id vocabulary shared with the device images, the planner
and, once tiering is enabled, the static-tier lifecycle.  The device images
and the kernel backend's tensors live on ``Engine.device``: the card by
default, the CPU when the caller asks for it (then every op runs its plain
PyTorch version).  ``snapshot``/``restore`` persist and rebuild the engine
(``core/persist.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.collate import collate
from ..core.device_index import resolve_device
from ..core.index import DynamicIndex, group_occurrences
from ..core.lifecycle import FreezeManager, FreezePolicy
from ..core.prepare import prepare_batch
from ..core.query import CollectionStats, TermStats
from .backends import (
    HostBackend,
    KernelBackend,
    TieredBackend,
    UnsupportedQueryError,
)
from .device_backend import DeviceBackend, ResidentImageManager
from .planner import Planner, PlannerConfig
from .types import POSITIONAL_MODES, EngineStats, Query, QueryResult


class _LiveFtMap:
    """Read-only term-bytes → LIVE document frequency, backed directly by
    the engine's incrementally-maintained counters (no dict materialized).
    Plugged into :class:`CollectionStats` when the engine synthesizes
    deletion-aware statistics."""

    __slots__ = ("_tid", "_dfs")

    def __init__(self, tid: dict, dfs: list):
        self._tid = tid
        self._dfs = dfs

    def get(self, tb, default=0):
        t = self._tid.get(tb)
        if t is None:
            return default
        return self._dfs[t]


class Engine:
    """Planner/executor over the host, device, kernel and tiered backends.

    Parameters
    ----------
    B, growth, F, word_level:
        forwarded to :class:`DynamicIndex` (``index`` may be passed instead
        to adopt an existing one — it must not be shared with other writers).
    planner / force_backend:
        routing configuration; ``force_backend`` pins every query.
    auto_collate_delta_frac:
        if set, a batch that finds the device delta (as of its last
        refresh) larger than this fraction of the store's blocks runs a
        full collation first — bounding delta size, and so the cost of a
        device query, without ever collating on the query path for small
        deltas.
    delta_compact_frac / delta_compact_min_blocks:
        fragmentation-threshold compaction for the device refresh itself
        (see ``device_backend``); None disables.
    device:
        where the device images live and the ops run: None means
        ``torch.device("cuda")`` (raises if there is no CUDA device); pass
        ``"cpu"`` to run the plain versions on the CPU.
    decode_fn:
        the block decode of the device backend's split path
        (``DeviceBackend(use_fused=False)``); None takes the
        ``dvbyte_decode`` op.
    tier_policy:
        enable the tiered static lifecycle (``core.lifecycle``): a
        :class:`~repro_torch.core.lifecycle.FreezeManager` converts the
        frozen docid prefix into a compressed :class:`StaticIndex` tier on
        a background thread per this policy, and the tiered backend serves
        the prefix from it.  Each freeze also collates and re-uploads the
        frozen device image on the caller's thread.
    """

    def __init__(self, B: int = 64, growth: str = "const",
                 F: int | None = None, word_level: bool = False,
                 index: DynamicIndex | None = None,
                 planner: PlannerConfig | None = None,
                 force_backend: str | None = None,
                 auto_collate_delta_frac: float | None = None,
                 delta_compact_frac: float | None = 0.25,
                 delta_compact_min_blocks: int = 512,
                 device=None, decode_fn=None,
                 tier_policy: FreezePolicy | None = None):
        self.device = resolve_device(device)
        self.index = index if index is not None else DynamicIndex(
            B=B, growth=growth, F=F, word_level=word_level)
        self.planner = Planner(planner, force_backend)
        self.auto_collate_delta_frac = auto_collate_delta_frac
        self.delta_compact_frac = delta_compact_frac
        self.delta_compact_min_blocks = delta_compact_min_blocks
        self.version = 0      # published — bumps per ingested/deleted doc
        # when this engine is one shard of a document-partitioned fleet,
        # the fan-out layer installs a callable returning the fleet-wide
        # CollectionStats — every ranked scorer and device-image refresh
        # then rebases (N, f_t, avgdl) to the full collection, making
        # shard results merge-exact.  None = this engine IS the collection.
        self.stats_provider = None
        self.vocab: list[bytes] = []      # tid -> term bytes
        self._tid: dict[bytes, int] = {}
        # tid -> LIVE f_t (doc-level: document frequency; word-level:
        # occurrence count) — incremented at ingest, decremented at delete
        self._fts: list[int] = []
        # tid -> postings ever appended (the store's head f_t): incremented
        # at ingest, NEVER decremented — device delta change detection
        self._appended_fts: list[int] = []
        # tid -> LIVE document frequency on word-level engines
        self._doc_dfs: list[int] = []
        self._doclens: list[int] = [0]    # 1-indexed via position-0 pad
        # forward index: docid -> [(tid, occurrences)] per unique term
        # (None once deleted)
        self._doc_tids: list = [None]
        self._deleted_tokens = 0          # Σ doclen over tombstoned docs
        self._group_scratch: list = []    # per-batch grouping scratch
        self.stats_counters = EngineStats()
        # one resident image manager shared by the device and kernel
        # backends: a mixed stream pays for at most one frozen upload and
        # one delta rebuild per engine version
        self.resident = ResidentImageManager(self, decode_fn=decode_fn)
        self.backends = {
            "host": HostBackend(self),
            "device": DeviceBackend(self, self.resident),
            "kernel": KernelBackend(self, resident=self.resident),
            "tiered": TieredBackend(self),
        }
        self.lifecycle: FreezeManager | None = None
        if tier_policy is not None:
            self.enable_tiering(tier_policy)
        if index is not None:
            self._adopt_existing()

    def enable_tiering(self, policy: FreezePolicy | None = None
                       ) -> FreezeManager:
        """Attach (or reconfigure) the static-tier lifecycle (doc-level and
        word-level engines alike — word-level tiers keep positions, so
        phrase queries serve from the compressed tier too)."""
        self.lifecycle = FreezeManager(self, policy)
        return self.lifecycle

    def static_tier(self):
        """The published :class:`~repro_torch.core.lifecycle.StaticTier`
        (or None); swapped atomically by the lifecycle's background
        freeze."""
        return self.lifecycle.tier if self.lifecycle is not None else None

    def _adopt_existing(self) -> None:
        """Register terms/doclens of a pre-built index (doclens are
        reconstructed as Σ f per doc — exact for doc-level indexes), plus
        the forward index and live per-term statistics."""
        word = self.index.word_level
        store = self.index.store
        dl = np.zeros(self.index.num_docs + 1, np.int64)
        for term, h_ptr in self.index.terms():
            tid = self._intern(term)
            self._appended_fts[tid] = store.get_ft(h_ptr * store.B)
            d, f = self.index.postings(term)
            np.add.at(dl, d, f if not word else 1)
        self._doclens = dl.tolist()
        self._rebuild_forward()
        self._fts = [0] * len(self.vocab)
        for d in range(1, self.index.num_docs + 1):
            entry = self._doc_tids[d]
            if entry is None:
                continue
            for tid, occ in entry:
                self._fts[tid] += occ if word else 1
        self.version += 1

    def _rebuild_forward(self) -> None:
        """Derive the forward index, live word-level document frequencies
        and the deleted-token total from the inverted chains + tombstone
        set.  Used by ``_adopt_existing`` and snapshot restore — the chains
        and live ``_fts`` are the persisted state of record."""
        word = self.index.word_level
        doc_tids: list = [[] for _ in range(self.index.num_docs + 1)]
        for term, h_ptr in self.index.terms():
            tid = self._tid[term]
            d, f = self.index.store.decode_postings(h_ptr)
            ud, cnt = group_occurrences(d) if word else (d, f)
            for dd, cc in zip(ud.tolist(), cnt.tolist()):
                doc_tids[dd].append((tid, cc))
        self._doc_dfs = [0] * len(self.vocab)
        self._deleted_tokens = 0
        dead = self.index.tombstones
        for d in range(1, self.index.num_docs + 1):
            if d in dead:
                self._deleted_tokens += int(self._doclens[d])
                doc_tids[d] = None
                continue
            if word:
                for tid, _occ in doc_tids[d]:
                    self._doc_dfs[tid] += 1
        doc_tids[0] = None
        self._doc_tids = doc_tids

    # ------------------------------------------------------------------
    # vocabulary / statistics
    # ------------------------------------------------------------------

    def _intern(self, tb: bytes) -> int:
        tid = self._tid.get(tb)
        if tid is None:
            tid = len(self.vocab)
            self._tid[tb] = tid
            self.vocab.append(tb)
            self._fts.append(0)
            self._appended_fts.append(0)
            self._doc_dfs.append(0)
        return tid

    def term_id(self, term) -> int | None:
        tb = term.encode() if isinstance(term, str) else term
        return self._tid.get(tb)

    def ranking_stats(self):
        """The :class:`~repro_torch.core.query.CollectionStats` to score
        with, or None when this engine's own statistics are exact (a
        single engine without tombstones).  Under a fleet provider they
        are the fleet's.  Otherwise, with tombstones outstanding,
        deletion-aware statistics are synthesized from the live counters:
        N minus the dead, avgdl over live tokens, per-term LIVE document
        frequency."""
        if self.stats_provider is not None:
            return self.stats_provider()
        dead = self.index.tombstones
        if not dead:
            return None
        live_n = self.index.num_docs - len(dead)
        avg = ((self.index.num_words - self._deleted_tokens) / live_n
               if live_n else 0.0)
        dfs = self._doc_dfs if self.index.word_level else self._fts
        return CollectionStats(live_n, avg, _LiveFtMap(self._tid, dfs))

    def global_fts(self) -> np.ndarray:
        """Current scoring f_t per term id: under a fleet stats provider
        the COLLECTION-wide document frequency per local term id, else the
        live local counts.  Scoring only: the delta build's change
        detection reads the append-only ``_appended_fts``, never this."""
        stats = self.ranking_stats()
        if stats is not None:
            return stats.fts_for(self.vocab)
        return np.asarray(self._fts, dtype=np.int64)

    def doclens_array(self) -> np.ndarray:
        return np.asarray(self._doclens, dtype=np.float64)

    @property
    def device_capable(self) -> bool:
        return self.index.store.const_mode and not self.index.word_level

    @property
    def kernel_capable(self) -> bool:
        # the kernel backend decodes postings on the host, so any growth
        # policy works; word-level lists (w-gap payloads, repeated docids)
        # do not fit the kernels
        return not self.index.word_level

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def add_document(self, terms) -> int:
        """Ingest one document; it is queryable on every backend the moment
        this returns (the device backend refreshes its delta lazily)."""
        t0 = time.perf_counter()
        d = self.index.add_document(terms)
        tbs = [t.encode() if isinstance(t, str) else t for t in terms]
        entry: list[tuple[int, int]] = []
        if self.index.word_level:
            occ: dict[int, int] = {}
            for tb in tbs:  # §5.1: one posting (and one f_t tick) per occurrence
                tid = self._intern(tb)
                self._fts[tid] += 1
                self._appended_fts[tid] += 1
                occ[tid] = occ.get(tid, 0) + 1
            for tid, n in occ.items():  # first-occurrence order
                self._doc_dfs[tid] += 1
                entry.append((tid, n))
        else:
            counts: dict[int, int] = {}
            for tb in tbs:
                tid = self._intern(tb)
                counts[tid] = counts.get(tid, 0) + 1
            for tid, f in counts.items():  # dedupe, first-occurrence order
                self._fts[tid] += 1
                self._appended_fts[tid] += 1
                entry.append((tid, f))
        self._doc_tids.append(entry)
        self._doclens.append(len(terms))
        self.version += 1
        sc = self.stats_counters
        sc.ingest_docs += 1
        sc.ingest_batches += 1
        sc.ingest_time_s += time.perf_counter() - t0
        if self.lifecycle is not None:
            self.lifecycle.maybe_freeze()
        return d

    def add_documents(self, docs) -> list[int]:
        """Batched ingest: returns the assigned docids, ascending; every
        document is queryable the moment this returns.

        Answer-identical to a per-document :meth:`add_document` loop (same
        docids, term ids, forward-index entries and decoded chains), but
        the index append is the grouped per-term run path
        (:meth:`DynamicIndex.add_runs`) and the bookkeeping runs batch-wise.
        """
        t0 = time.perf_counter()
        word = self.index.word_level
        prepared = prepare_batch(docs, word)
        tid_of = self._tid
        vocab = self.vocab
        fts = self._fts
        appended = self._appended_fts
        doc_dfs = self._doc_dfs
        doc_tids = self._doc_tids
        doclens = self._doclens
        getid = tid_of.__getitem__
        if word:
            # word-level: the index groups the occurrence streams itself
            dids = self.index.add_prepared(prepared)
            for p in prepared:
                uniq = p.uniq
                try:
                    tids = [*map(getid, uniq)]      # all-known fast path
                except KeyError:
                    for tb in uniq:                 # first-occurrence order
                        if tb not in tid_of:
                            self._intern(tb)
                    tids = [*map(getid, uniq)]
                for tid, f in zip(tids, p.counts):
                    fts[tid] += f
                    appended[tid] += f
                    doc_dfs[tid] += 1
                doc_tids.append([*zip(tids, p.counts)])
                doclens.append(p.doclen)
        else:
            # doc-level fused path: the interning/bookkeeping pass also
            # groups the batch's <d, f> postings per term; ``touched`` keeps
            # first-occurrence order, so head creation matches sequential
            # ingest
            by_tid: list = self._group_scratch
            touched: list[int] = []
            ta = touched.append
            d = self.index.num_docs
            base = d
            nwords = npostings = 0
            for p in prepared:
                uniq = p.uniq
                try:
                    tids = [*map(getid, uniq)]      # all-known fast path
                except KeyError:
                    for tb in uniq:                 # first-occurrence order
                        if tb not in tid_of:
                            self._intern(tb)
                    tids = [*map(getid, uniq)]
                if len(by_tid) < len(vocab):
                    by_tid.extend([None] * (len(vocab) - len(by_tid)))
                d += 1
                cs = p.counts
                for tid, f in zip(tids, cs):
                    run = by_tid[tid]
                    if run is None:
                        by_tid[tid] = run = []
                        ta(tid)
                    run.append((d, f))
                doc_tids.append([*zip(tids, cs)])
                doclens.append(p.doclen)
                nwords += p.doclen
                npostings += len(tids)
            self.index.add_runs(
                d - base, nwords, npostings,
                ((vocab[tid], by_tid[tid]) for tid in touched))
            for tid in touched:     # df ticks per TERM, then reset scratch
                n = len(by_tid[tid])
                fts[tid] += n
                appended[tid] += n
                by_tid[tid] = None
            dids = list(range(base + 1, d + 1))
        self.version += len(prepared)
        sc = self.stats_counters
        sc.ingest_docs += len(prepared)
        sc.ingest_batches += 1
        sc.ingest_time_s += time.perf_counter() - t0
        if self.lifecycle is not None:
            self.lifecycle.maybe_freeze()
        return dids

    def delete_document(self, docid: int) -> list[tuple[int, int]]:
        """Tombstone one document.

        Every term the document contained has its live f_t (and, word-level,
        document frequency) decremented, and the live token total drops by
        the document's length — so every ranked scorer and device image
        weights as if the document was never ingested.  The append counts
        stay: the postings remain in the store, masked at serve time.
        Returns the document's ``(tid, occurrences)`` pairs."""
        self.index.delete_document(docid)   # validates range + double delete
        entry = self._doc_tids[docid]
        word = self.index.word_level
        for tid, n in entry:
            self._fts[tid] -= n if word else 1
            if word:
                self._doc_dfs[tid] -= 1
        self._deleted_tokens += self._doclens[docid]
        self._doc_tids[docid] = None
        self.version += 1
        return entry

    def update_document(self, docid: int, terms) -> int:
        """Revise a document: tombstone the old docid, ingest the new
        content under a FRESH ordinal docid (returned)."""
        self.delete_document(docid)
        return self.add_document(terms)

    def collate_now(self) -> None:
        """Full collation (§5.5): stop-the-world chain compaction, then the
        device backend adopts the result as its frozen image and the delta
        rebases to empty."""
        self.index = collate(self.index)
        self.stats_counters.collations += 1
        if self.device_capable:
            self.resident.freeze()

    def _maybe_auto_collate(self) -> None:
        frac = self.auto_collate_delta_frac
        if frac is None:
            return
        total = max(1, self.index.store.nblocks)
        if self.resident.delta_blocks > frac * total:
            self.collate_now()

    # ------------------------------------------------------------------
    # query execution
    # ------------------------------------------------------------------

    def execute(self, query: Query) -> QueryResult:
        return self.execute_many([query])[0]

    def execute_many(self, queries: list[Query]) -> list[QueryResult]:
        """Plan and run a batch; results align with ``queries``."""
        if not queries:
            return []
        t0 = time.perf_counter()
        self._maybe_auto_collate()
        plans = []
        for q in queries:
            stats = [TermStats(self._fts[tid], 0)
                     if (tid := self.term_id(t)) is not None else TermStats()
                     for t in q.terms]
            plans.append(self.planner.plan(
                q, len(queries), stats, device_capable=self.device_capable,
                kernel_capable=self.kernel_capable,
                tiered_available=self.static_tier() is not None,
                # the tiered backend serves every mode; positional modes
                # additionally need word positions (as does the host path)
                tiered_capable=(self.index.word_level
                                if q.mode in POSITIONAL_MODES else True)))
        out: list[QueryResult | None] = [None] * len(queries)
        by_backend: dict[str, list[int]] = {}
        for i, p in enumerate(plans):
            by_backend.setdefault(p.backend, []).append(i)
        for name, idxs in by_backend.items():
            backend = self.backends[name]
            res = backend.execute_many([queries[i] for i in idxs])
            for i, r in zip(idxs, res):
                r.reason = plans[i].reason
                out[i] = r
        sc = self.stats_counters
        sc.queries += len(queries)
        sc.query_batches += 1
        sc.query_time_s += time.perf_counter() - t0
        for p in plans:
            sc.by_backend[p.backend] = sc.by_backend.get(p.backend, 0) + 1
        return out  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # persistence (core/persist.py)
    # ------------------------------------------------------------------

    def snapshot(self, root: str, *, keep: int = 3,
                 quiesce: bool = False) -> str:
        """Persist this engine under ``root`` (crash-atomic: staged write,
        manifest last, one rename — see ``core.persist``).  Returns the
        published snapshot dir.  Runs on the writer thread; safe while a
        background freeze is encoding (the snapshot captures the currently
        PUBLISHED tier plus the full dynamic image, which restores
        byte-identically at any horizon).  ``quiesce=True`` first joins an
        in-flight encode so the newest tier lands in the snapshot."""
        from ..core import persist
        if quiesce and self.lifecycle is not None:
            self.lifecycle.quiesce()
        return persist.save_engine(self, root, keep=keep)

    @classmethod
    def restore(cls, path_or_root: str, **engine_kwargs) -> "Engine":
        """Rebuild an engine from a snapshot dir (or the newest snapshot
        under a root).  ``engine_kwargs`` forwards runtime knobs (device,
        planner, force_backend, decode_fn, ...); index shape and freeze
        policy come from the manifest.  Like the constructor, the device
        images go to the card unless ``device`` says otherwise; a
        device-capable engine's frozen image is uploaded here."""
        from ..core import persist
        return persist.restore_engine(path_or_root, **engine_kwargs)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def stats(self) -> EngineStats:
        s = self.stats_counters
        s.num_docs = self.index.num_docs
        s.deleted_docs = len(self.index.tombstones)
        s.num_postings = self.index.num_postings
        s.num_words = self.index.num_words
        s.vocab_size = len(self.vocab)
        if self.lifecycle is not None:
            s.freezes = self.lifecycle.freezes
            s.tier_epoch = self.lifecycle.epoch
            s.tombstones_compacted = self.lifecycle.tombstones_compacted
        return s


__all__ = ["Engine", "Query", "QueryResult", "UnsupportedQueryError",
           "resolve_device"]
