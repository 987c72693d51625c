"""Host-level fleet: :class:`ShardedEngine`, a document-partitioned
fan-out of per-shard :class:`~repro_torch.engine.Engine` s with fleet-wide
ranking statistics, coordinated freezes and fleet snapshots.

Each shard's device images live on its ``Engine.device``: the card unless
``device="cpu"`` is passed through ``engine_kwargs``.  The device-mesh
query step (one program across cards) is not here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class _FleetCounts:
    """Fleet-wide ingest counters, published as ONE immutable snapshot so a
    pool-thread reader (ranked scoring mid-fan-out) always sees a mutually
    consistent (version, N, total_tokens) triple — three separate counter
    fields could be observed mid-update between stores."""

    version: int        # bumps per ingested/deleted document (cache key)
    num_docs: int       # docid HORIZON (includes tombstoned — round-robin
    #                     assignment arithmetic must never renumber)
    total_tokens: int   # LIVE token total (decremented at delete)
    deleted_docs: int = 0   # tombstoned fleet-wide (live N = num_docs - this)


class ShardedEngine:
    """Document-partitioned fan-out of per-shard query engines — a
    first-class Engine: exact, parallel, and freeze-coordinated.

    Documents are assigned round-robin; each shard runs a full
    ``repro_torch.engine.Engine`` (its planner may independently pick host,
    device, kernel, or tiered execution, and its device image refreshes
    incrementally — each shard owns a
    :class:`~repro_torch.engine.device_backend.ResidentImageManager`, so its
    frozen block array uploads once per shard freeze and batched fan-out
    queries reuse the per-shard resident images across flushes).  Queries
    fan out to every shard — on a thread pool, so fan-out wall-clock is
    the max over shards, not the sum — and results fuse:

      * boolean modes (conjunctive / phrase / proximity) — per-shard docid
        lists are globalized and concatenated (docid spaces are disjoint,
        no dedup needed);
      * ranked modes — per-shard top-k lists merge under the canonical tie
        order (higher score, then lower global docid).

    **Docid arithmetic** — round-robin assignment is pure arithmetic, no
    per-document maps: global docid ``g`` lives on shard ``(g-1) % S`` as
    local docid ``(g-1) // S + 1``; local ``l`` on shard ``s`` globalizes
    to ``(l-1)*S + s + 1``.  Globalization is one vectorized affine map and
    the engine carries O(1) routing state regardless of collection size.
    The map is strictly monotone per shard, so per-shard canonical tie
    order IS global canonical tie order — which is what makes the top-k
    merge exact at tied boundaries.

    **Exact global ranked statistics** — the fan-out maintains the
    collection-wide document frequencies, N, and total token count at
    ingest and hands every shard a :class:`~repro_torch.core.query.
    CollectionStats` provider (the same rebasing seam the device
    frozen+delta path uses).  Shards therefore weight postings with exactly
    the numbers a single-engine oracle over the full stream would use, and
    the merged top-k is byte-identical to that oracle (same doubles, same
    canonical tie order) — no shard-local IDF approximation remains.

    **Coordinated freezes** — per-shard static-tier lifecycles register
    with one :class:`~repro_torch.core.lifecycle.FreezeCoordinator`; at most
    ``max_in_flight`` background encodes run fleet-wide, and refused
    shards retry on any later fleet ingest (every queued shard is pumped
    per ingest — see the coordinator docstring) or via
    :meth:`drain_freezes`.

    **Serving integration** — ``version`` (bumps per ingested document) and
    ``lifecycle.epoch`` (composite tier epoch, bumps on any shard's swap)
    give ``serve.QueryService`` the same cache-key components a single
    engine exposes, so result caching and invalidation work unchanged.
    """

    def __init__(self, num_shards: int = 2, engine_factory=None,
                 max_in_flight: int = 1, parallel: bool = True,
                 **engine_kwargs):
        from ..engine import Engine
        from .lifecycle import FreezeCoordinator
        if engine_factory is None:
            def engine_factory():
                return Engine(**engine_kwargs)
        self.engines = [engine_factory() for _ in range(num_shards)]
        self.num_shards = len(self.engines)
        self._counts = _FleetCounts(0, 0, 0)            # published
        # term -> global DOCUMENT frequency
        self._ft: dict[bytes, int] = {}                 # gil_shared
        # per-shard global-f_t arrays aligned to each shard's term ids
        # (keyed by the identity of the engine's append-only vocab list),
        # value-updated incrementally at ingest and suffix-extended at read
        # time — a device-image refresh never re-walks the vocabulary
        self._gft_cache: dict[int, np.ndarray] = {}   # gil_shared
        # every shard scores with the fleet's collection-wide statistics
        for e in self.engines:
            e.stats_provider = self.collection_stats
        # fleet freeze scheduling: one coordinator owns every shard lifecycle
        self.coordinator = FreezeCoordinator(max_in_flight=max_in_flight)
        for e in self.engines:
            if getattr(e, "lifecycle", None) is not None:
                self.coordinator.register(e.lifecycle)
        self._pool = None
        if parallel and self.num_shards > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_shards,
                thread_name_prefix="shard-fanout")

    def close(self) -> None:
        """Release the fan-out thread pool and join in-flight freezes.
        Idempotent; the engine degrades to serial fan-out afterwards —
        transient fleets (benchmarks, resize/rebuild cycles) should close
        rather than leak ``num_shards`` worker threads until exit."""
        for e in self.engines:
            if getattr(e, "lifecycle", None) is not None:
                e.lifecycle.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "ShardedEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # collection statistics (the exactness seam)
    # ------------------------------------------------------------------

    def collection_stats(self):
        """Fleet-wide (N, avg doclen, f_t) — what every ranked scorer and
        device-image refresh rebases with.  ``avg`` is total tokens over N,
        which equals the oracle's ``doclens[1:N+1].mean()`` bit-for-bit
        (integer sums below 2**53 are exact in float64)."""
        from .query import CollectionStats
        c = self._counts
        live = c.num_docs - c.deleted_docs
        return CollectionStats(
            num_docs=live,
            avg_doclen=c.total_tokens / live if live else 0.0,
            ft=self._ft,
            fts_cache=self._gft_cache)

    @property
    def version(self) -> int:
        """Bumps per ingested document (serving cache-key component)."""
        return self._counts.version

    @property
    def num_docs(self) -> int:
        return self._counts.num_docs

    @property
    def deleted_docs(self) -> int:
        return self._counts.deleted_docs

    @property
    def num_postings(self) -> int:
        return sum(e.index.num_postings for e in self.engines)

    @property
    def lifecycle(self):
        """The fleet coordinator: exposes the composite ``epoch`` the
        serving cache keys on (duck-compatible with a single engine's
        ``FreezeManager`` for that purpose)."""
        return self.coordinator

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def add_document(self, terms) -> int:
        """Ingest one document (single front-door thread — queries and
        ingest are serialized by the caller, the same one-writer model as
        ``Engine``/``QueryService``; the fan-out pool is only ever busy
        INSIDE ``execute_many``, never concurrently with an ingest)."""
        c = self._counts
        g = c.num_docs + 1
        shard = (g - 1) % self.num_shards
        # global stats BEFORE the shard ingest, so the maybe_freeze hooks
        # that fire inside it already see statistics covering this doc
        tbs = [t.encode() if isinstance(t, str) else t for t in terms]
        # resolve each shard's materialized aligned-f_t array once per doc
        # (most fleets have none until a device query materializes them)
        live = [(e._tid, arr) for e in self.engines
                if (arr := self._gft_cache.get(id(e.vocab))) is not None]
        for tb in dict.fromkeys(tbs):
            df = self._ft.get(tb, 0) + 1
            self._ft[tb] = df
            # keep the materialized per-shard aligned f_t arrays current
            # (terms a shard interns later are picked up by the suffix
            # extension in CollectionStats.fts_for)
            for tid_map, arr in live:
                tid = tid_map.get(tb)
                if tid is not None and tid < len(arr):
                    arr[tid] = df
        self._counts = _FleetCounts(c.version + 1, g,
                                    c.total_tokens + len(terms),
                                    c.deleted_docs)
        local = self.engines[shard].add_document(terms)
        assert local == (g - 1) // self.num_shards + 1
        # a global ingest changes every shard's scoring state (N, f_t, avg
        # all moved): bump the non-owner versions too so their device
        # images re-rebase statistics on the next refresh
        for s, e in enumerate(self.engines):
            if s != shard:
                e.version += 1
        # pump deferred freezes fleet-wide: the fleet shares ONE writer
        # thread (this method), so a shard whose encode-slot request was
        # refused may retry on ANY ingest — not only its own — which keeps
        # the coordinator's FIFO live even if routing ever skews away from
        # the queue head
        if self.coordinator.pending:
            for s, e in enumerate(self.engines):
                if s != shard and getattr(e, "lifecycle", None) is not None:
                    e.lifecycle.maybe_freeze()
        return g

    @property
    def word_level(self) -> bool:
        return self.engines[0].index.word_level

    def route_batch(self, prepared):
        """Assign global docids round-robin and update the fleet-wide
        statistics for a whole batch of
        :class:`~repro_torch.core.prepare.PreparedDoc` records — WITHOUT
        touching any shard engine.  Returns ``(gids, per_shard, extra_bumps)``:

          * ``gids`` — the global docids, in submission order;
          * ``per_shard[s]`` — the sub-batch shard ``s`` owns, in local
            docid order (round-robin arithmetic: global ``g`` lands on
            shard ``(g-1) % S`` as local ``(g-1)//S + 1``);
          * ``extra_bumps[s]`` — the number of batch documents shard ``s``
            does NOT own.  A global ingest changes every shard's scoring
            state (N, f_t, avgdl all move), so each shard's version must
            advance by the FULL batch size: its own ingest bumps it by
            ``len(per_shard[s])``, and whoever applies the sub-batch adds
            ``extra_bumps[s]`` on top.  Splitting it this way keeps each
            shard engine's ``version`` written by exactly one thread in
            the pipelined path (its writer), never the router.

        This is the router half of the pipelined write path
        (``serve.ingest_pipeline``): it runs on the submitting thread —
        fleet counters and the global df map stay single-writer — while
        per-shard writer threads apply the returned sub-batches.  Global
        statistics are published BEFORE any shard ingest (one
        ``_FleetCounts`` store), so freeze hooks firing inside a shard's
        apply already see statistics covering the whole batch — the same
        order ``add_document`` uses.
        """
        c = self._counts
        S = self.num_shards
        base = c.num_docs
        gids = list(range(base + 1, base + len(prepared) + 1))
        per_shard: list[list] = [[] for _ in range(S)]
        df_delta: dict[bytes, int] = {}
        tokens = 0
        for i, p in enumerate(prepared):
            per_shard[(base + i) % S].append(p)
            tokens += p.doclen
            for tb in p.uniq:
                df_delta[tb] = df_delta.get(tb, 0) + 1
        live = [(e._tid, arr) for e in self.engines
                if (arr := self._gft_cache.get(id(e.vocab))) is not None]
        for tb, dd in df_delta.items():
            df = self._ft.get(tb, 0) + dd
            self._ft[tb] = df
            for tid_map, arr in live:
                tid = tid_map.get(tb)
                if tid is not None and tid < len(arr):
                    arr[tid] = df
        self._counts = _FleetCounts(c.version + len(prepared),
                                    base + len(prepared),
                                    c.total_tokens + tokens,
                                    c.deleted_docs)
        extra = [len(prepared) - len(per_shard[s]) for s in range(S)]
        return gids, per_shard, extra

    def add_documents(self, docs) -> list[int]:
        """Batched fleet ingest (synchronous: same single front-door
        thread model as ``add_document``; the pipelined variant lives in
        ``serve.ingest_pipeline``).  Answer-identical to a per-document
        loop — same global docids, same fleet statistics, same per-shard
        chains."""
        from .prepare import prepare_batch
        prepared = prepare_batch(docs, self.word_level)
        gids, per_shard, extra = self.route_batch(prepared)
        for s, e in enumerate(self.engines):
            if per_shard[s]:
                e.add_documents(per_shard[s])
            if extra[s]:
                e.version += extra[s]
        # pump deferred freezes fleet-wide (see add_document): every queued
        # shard may retry on any ingest
        if self.coordinator.pending:
            for e in self.engines:
                if getattr(e, "lifecycle", None) is not None:
                    e.lifecycle.maybe_freeze()
        return gids

    def delete_document(self, docid: int) -> None:
        """Tombstone one document fleet-wide (same single-writer model as
        ``add_document``).  The global docid routes to its owner shard by
        the round-robin arithmetic — no per-document map — and the owner's
        returned ``(tid, occurrences)`` pairs mirror the document-frequency
        decrements into the fleet's global ``_ft`` (and every materialized
        per-shard aligned f_t array), so every shard immediately scores
        with statistics of a collection that never held the document."""
        c = self._counts
        if not 1 <= docid <= c.num_docs:
            raise ValueError(f"docid {docid} out of range 1..{c.num_docs}")
        shard = (docid - 1) % self.num_shards
        local = (docid - 1) // self.num_shards + 1
        eng = self.engines[shard]
        doclen = eng._doclens[local]
        entry = eng.delete_document(local)  # raises on double delete
        live = [(e._tid, arr) for e in self.engines
                if (arr := self._gft_cache.get(id(e.vocab))) is not None]
        for tid, _occ in entry:
            tb = eng.vocab[tid]
            df = self._ft.get(tb, 0) - 1
            self._ft[tb] = df
            for tid_map, arr in live:
                t = tid_map.get(tb)
                if t is not None and t < len(arr):
                    arr[t] = df
        # horizon stays put (docid arithmetic is append-only); live token
        # total and the tombstone count move — published as ONE snapshot
        self._counts = _FleetCounts(c.version + 1, c.num_docs,
                                    c.total_tokens - doclen,
                                    c.deleted_docs + 1)
        # a delete changes every shard's scoring state (N, f_t, avg): bump
        # the non-owner versions so their device images re-rebase
        for s, e in enumerate(self.engines):
            if s != shard:
                e.version += 1

    def update_document(self, docid: int, terms) -> int:
        """Atomic-from-the-caller's-view revision: tombstone ``docid`` and
        ingest ``terms`` as a NEW document (new global docid, returned) —
        the same delete+add semantics as ``Engine.update_document``."""
        self.delete_document(docid)
        return self.add_document(terms)

    def collate_now(self) -> None:
        for e in self.engines:
            e.collate_now()

    def drain_freezes(self) -> None:
        """Run every due-or-deferred freeze to completion (tests, shutdown,
        bulk-load tails).  No ingest may run concurrently — this pumps the
        writer-thread side of deferred freezes that would otherwise wait
        for the next document.  Bails out (rather than spinning) if an
        epoch fails to advance — a crashed encode thread must not wedge
        shutdown."""
        mgrs = [e.lifecycle for e in self.engines
                if getattr(e, "lifecycle", None) is not None]
        while True:
            for m in mgrs:
                m.wait()
            before = [m.epoch for m in mgrs]
            if not any([m.maybe_freeze() for m in mgrs]):
                break
            for m in mgrs:
                m.wait()
            if [m.epoch for m in mgrs] == before:
                break
        for m in mgrs:
            m.wait()

    # ------------------------------------------------------------------
    # query fan-out
    # ------------------------------------------------------------------

    def execute(self, query):
        return self.execute_many([query])[0]

    def _globalize(self, shard: int, docids) -> np.ndarray:
        """Vectorized round-robin globalization: (l-1)*S + shard + 1."""
        local = np.asarray(docids, dtype=np.int64)
        return (local - 1) * self.num_shards + shard + 1

    def execute_many(self, queries):
        """Fan a batch out to every shard engine (in parallel) and fuse per
        query.  Each shard result's docids are globalized arithmetically;
        the fused ``backend`` reports the SET of backends that actually
        served the shards (e.g. ``"host+tiered"``)."""
        from ..engine.types import QueryResult
        if self._pool is not None:
            per_shard = list(self._pool.map(
                lambda e: e.execute_many(queries), self.engines))
        else:
            per_shard = [e.execute_many(queries) for e in self.engines]
        out = []
        for qi, q in enumerate(queries):
            shard_res = [per_shard[s][qi] for s in range(self.num_shards)]
            backend = "+".join(sorted({r.backend for r in shard_res}))
            reason = f"sharded fan-out x{self.num_shards}"
            gids = np.concatenate([self._globalize(s, r.docids)
                                   for s, r in enumerate(shard_res)])
            if q.mode in ("conjunctive", "phrase", "proximity"):
                out.append(QueryResult(np.sort(gids), None, backend, reason))
            else:
                scores = np.concatenate([r.scores for r in shard_res])
                # canonical ranked tie order across shards: higher score
                # first, then lower GLOBAL docid (not shard arrival order)
                order = np.lexsort((gids, -scores))[:q.k]
                out.append(QueryResult(gids[order], scores[order],
                                       backend, reason))
        return out

    # ------------------------------------------------------------------
    # persistence (core/persist.py)
    # ------------------------------------------------------------------

    def snapshot(self, root: str, *, keep: int = 3,
                 quiesce: bool = False) -> str:
        """Persist the whole fleet under ``root`` — per-shard engine state
        plus the fleet counters and global term statistics, all published
        by ONE atomic rename (shards can never restore torn against each
        other).  Writer thread only.  ``quiesce=True`` joins in-flight
        shard encodes first so every shard's newest tier is captured."""
        from . import persist
        if quiesce:
            for e in self.engines:
                if getattr(e, "lifecycle", None) is not None:
                    e.lifecycle.quiesce()
        return persist.save_sharded(self, root, keep=keep)

    @classmethod
    def restore(cls, path_or_root: str, *, parallel: bool = True,
                max_in_flight: int | None = None,
                **engine_kwargs) -> "ShardedEngine":
        """Rebuild a fleet from a snapshot dir (or the newest under a
        root); per-shard ``engine_kwargs`` forward runtime knobs."""
        from . import persist
        return persist.restore_sharded(path_or_root, parallel=parallel,
                                       max_in_flight=max_in_flight,
                                       **engine_kwargs)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def stats(self):
        """One composite :class:`~repro_torch.engine.types.EngineStats` for
        the fleet (summed counters, merged backend histogram, composite tier
        epoch).  Per-shard detail remains available as
        ``[e.stats() for e in engine.engines]``."""
        from ..engine.types import EngineStats
        agg = EngineStats()
        for e in self.engines:
            s = e.stats()
            agg.deleted_docs += s.deleted_docs
            agg.tombstones_compacted += s.tombstones_compacted
            agg.num_postings += s.num_postings
            agg.num_words += s.num_words
            agg.queries += s.queries
            agg.query_batches += s.query_batches
            agg.query_time_s += s.query_time_s
            agg.ingest_docs += s.ingest_docs
            agg.ingest_batches += s.ingest_batches
            agg.ingest_time_s += s.ingest_time_s
            agg.collations += s.collations
            agg.delta_refreshes += s.delta_refreshes
            agg.delta_compactions += s.delta_compactions
            agg.resident_uploads += s.resident_uploads
            agg.freezes += s.freezes
            for k, v in s.by_backend.items():
                agg.by_backend[k] = agg.by_backend.get(k, 0) + v
        agg.num_docs = self.num_docs
        agg.vocab_size = len(self._ft)
        agg.tier_epoch = self.coordinator.epoch
        agg.num_shards = self.num_shards
        return agg


__all__ = ["ShardedEngine"]
