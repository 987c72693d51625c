"""Serving front door: request batching + mixed ingest/query streams.

Production traffic (ROADMAP north star) arrives as an interleaved stream of
document ingests and queries.  The service keeps the paper's immediate-access
contract — a query sees every document ingested before it — while batching
adjacent queries so the engine planner can route them to the batched device
path (``device_min_batch``): the classic serving trade of a tiny queueing
delay for much higher throughput.

Synchronous core, deliberately: one writer per index is the paper's (and
Asadi & Lin's) concurrency model, and a thread-safe wrapper can wrap
``submit``/``flush`` without touching engine internals.

**Result cache**: repeated queries between ingests are answered from a small
LRU keyed by ``(engine.version, static-tier epoch, query)``: every ingest or
delete bumps ``version`` and every lifecycle tier swap bumps the epoch, so
invalidation is free — a stale entry can never be returned, it simply stops
being addressable.  Entries are
bounded by ``cache_size`` (0 disables caching entirely).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ..engine.types import Query, QueryResult


@dataclass
class Ticket:
    """A pending query; ``result`` is filled at flush time."""

    query: Query
    result: QueryResult | None = None
    submitted_at: float = field(default_factory=time.perf_counter)
    latency_s: float | None = None

    @property
    def done(self) -> bool:
        return self.result is not None


class QueryService:
    """Batching executor over an :class:`~repro_torch.engine.Engine` (or
    anything with ``add_document``/``execute_many``)."""

    def __init__(self, engine, max_batch: int = 32, cache_size: int = 256):
        self.engine = engine
        self.max_batch = max_batch
        self._pending: list[Ticket] = []                # writer_only
        self.query_latencies: list[float] = []
        self.ingest_latencies: list[float] = []
        self.cache_size = cache_size
        self._cache: OrderedDict[tuple, QueryResult] \
            = OrderedDict()                             # writer_only
        self.cache_hits = 0
        self.cache_misses = 0

    # -- result cache ----------------------------------------------------

    def _cache_key(self, query: Query) -> tuple | None:
        """(version, tier epoch, query) — None when the engine exposes no
        version counter or caching is off.  The epoch is the lifecycle's
        published tier epoch (0 without tiering): a background freeze
        swaps the tier without an ingest, so the version alone would keep
        serving entries computed against the previous tier."""
        if self.cache_size <= 0:
            return None
        version = getattr(self.engine, "version", None)
        if version is None:
            return None
        lifecycle = getattr(self.engine, "lifecycle", None)
        epoch = lifecycle.epoch if lifecycle is not None else 0
        return (version, epoch, query)

    @staticmethod
    def _copy_result(r: QueryResult) -> QueryResult:
        """Results are mutable dataclasses over writable arrays; the cache
        stores and serves private copies so no caller's in-place edits can
        corrupt a later hit."""
        return QueryResult(r.docids.copy(),
                           None if r.scores is None else r.scores.copy(),
                           r.backend, r.reason)

    @property
    def hit_rate(self) -> float:
        """Result-cache hit rate over every CACHEABLE lookup so far (hits /
        (hits + misses)); 0.0 before any lookup.  Uncacheable submissions
        (caching disabled, or an engine without a version counter) count as
        neither hit nor miss — they never consulted the cache."""
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def cache_stats(self) -> dict:
        """Counters for dashboards and the traffic bench: cumulative hits /
        misses, the derived hit rate, and current entry count."""
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "hit_rate": self.hit_rate, "entries": len(self._cache)}

    # -- ingest ---------------------------------------------------------

    def ingest(self, terms) -> int:
        """Ingest one document.  Pending queries were submitted BEFORE this
        document, so they are NOT flushed first — immediate access only
        requires a query to see documents ingested before its submission."""
        t0 = time.perf_counter()
        d = self.engine.add_document(terms)
        self.ingest_latencies.append(time.perf_counter() - t0)
        return d

    def ingest_batch(self, docs) -> list[int]:
        """Ingest a batch of documents in one write-path pass (one chain-tail
        lookup and one contiguous encode per distinct term — see
        ``DynamicIndex.add_documents``).  Same flush semantics as
        ``ingest``: pending queries legally miss these documents."""
        t0 = time.perf_counter()
        dids = self.engine.add_documents(docs)
        self.ingest_latencies.append(time.perf_counter() - t0)
        return dids

    def delete(self, docid: int) -> None:
        """Tombstone one document.  Pending queries were submitted while it
        was still live, so they are FLUSHED first — the mirror image of
        ``ingest``'s no-flush rule: an ingest only adds visibility (pending
        queries may legally miss a later document), but a delete removes
        it, and a pending query must not miss a document that was alive at
        its submission.  The engine's version bump makes every cached
        result under the old version unaddressable (invalidation is free,
        same as ingest)."""
        self.flush()
        t0 = time.perf_counter()
        self.engine.delete_document(docid)
        self.ingest_latencies.append(time.perf_counter() - t0)

    def update(self, docid: int, terms) -> int:
        """Revise a document: tombstone ``docid``, ingest ``terms`` as a new
        document (new docid returned).  Flushes pending queries first, like
        ``delete`` — they must see the pre-revision state they were
        submitted against."""
        self.flush()
        t0 = time.perf_counter()
        d = self.engine.update_document(docid, terms)
        self.ingest_latencies.append(time.perf_counter() - t0)
        return d

    # -- querying -------------------------------------------------------

    def submit(self, query: Query) -> Ticket:
        """Queue a query; auto-flushes when the batch fills."""
        t = Ticket(query)
        self._pending.append(t)
        if len(self._pending) >= self.max_batch:
            self.flush()
        return t

    def flush(self) -> list[Ticket]:
        """Execute every pending query as one planned batch (cache-aware:
        hits are filled without touching the engine; one engine batch runs
        the misses).  Duplicate queries within a flush execute once — the
        engine batch carries unique queries only (the fused device path
        then decodes each term chain set once per flush), and duplicates
        are fanned back out as private result copies."""
        batch, self._pending = self._pending, []
        if not batch:
            return []
        # the key is computed ONCE per ticket and reused at store time: a
        # background freeze may bump lifecycle.epoch while execute_many
        # runs, and recomputing the key there would file the result under
        # an engine state it was never computed against (a later query at
        # the new epoch would then hit a stale entry)
        misses: list[tuple[Ticket, tuple | None]] = []
        for t in batch:
            key = self._cache_key(t.query)
            hit = self._cache.get(key) if key is not None else None
            if hit is not None:
                self._cache.move_to_end(key)
                self.cache_hits += 1
                t.result = self._copy_result(hit)
            else:
                self.cache_misses += key is not None
                misses.append((t, key))
        if misses:
            unique: dict = {}        # Query -> slot in the executed batch
            for t, _ in misses:
                unique.setdefault(t.query, len(unique))
            results = self.engine.execute_many(list(unique))
            handed: set[int] = set()
            for t, key in misses:
                slot = unique[t.query]
                r = results[slot]
                # the first ticket of each query takes the result object;
                # duplicates get copies (results are mutable arrays)
                t.result = r if slot not in handed else self._copy_result(r)
                handed.add(slot)
                if key is not None:
                    self._cache[key] = self._copy_result(r)
                    while len(self._cache) > self.cache_size:
                        self._cache.popitem(last=False)
        now = time.perf_counter()
        for t in batch:
            t.latency_s = now - t.submitted_at
            self.query_latencies.append(t.latency_s)
        return batch

    def query(self, query: Query) -> QueryResult:
        """Synchronous single query (flushes anything already queued so
        ordering against prior submissions is preserved)."""
        t = self.submit(query)
        self.flush()
        assert t.result is not None
        return t.result

    def phrase(self, terms, backend: str | None = None) -> QueryResult:
        """Synchronous phrase query over a word-level engine (served from
        the compressed static tier when one is published; results are
        cached under the same version/epoch key as every other mode)."""
        return self.query(Query(terms=tuple(terms), mode="phrase",
                                backend=backend))

    def proximity(self, terms, window: int,
                  backend: str | None = None) -> QueryResult:
        """Synchronous proximity query: documents where ``terms`` co-occur
        within ``window`` words (repeated terms bind distinct positions).
        ``window`` is part of the ``Query`` value, hence of the cache key —
        the same terms at different windows never collide."""
        return self.query(Query(terms=tuple(terms), mode="proximity",
                                window=window, backend=backend))

    # -- streams --------------------------------------------------------

    def run_stream(self, ops) -> list[Ticket]:
        """Drive a mixed stream of ("doc", terms) / ("docs", batch) /
        ("query", Query) / ("delete", docid) / ("update", (docid, terms))
        ops; returns every query ticket in submission order."""
        tickets = []
        for kind, payload in ops:
            if kind == "doc":
                self.ingest(payload)
            elif kind == "docs":
                self.ingest_batch(payload)
            elif kind == "query":
                tickets.append(self.submit(payload))
            elif kind == "delete":
                self.delete(payload)
            elif kind == "update":
                self.update(*payload)
            else:
                raise ValueError(f"unknown op {kind!r}")
        self.flush()
        return tickets

    # -- observability ---------------------------------------------------

    def latency_summary(self) -> dict:
        import numpy as np
        out = {}
        for name, xs in (("query", self.query_latencies),
                         ("ingest", self.ingest_latencies)):
            if xs:
                a = np.asarray(xs)
                out[name] = {"n": len(a), "mean_us": float(a.mean() * 1e6),
                             "p99_us": float(np.quantile(a, 0.99) * 1e6)}
        if self.cache_hits or self.cache_misses:
            out["cache"] = {"hits": self.cache_hits,
                            "misses": self.cache_misses,
                            "entries": len(self._cache)}
        return out
