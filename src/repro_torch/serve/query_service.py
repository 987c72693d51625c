"""Serving front door: request batching + mixed ingest/query streams.

Production traffic (ROADMAP north star) arrives as an interleaved stream of
document ingests and queries.  The service keeps the paper's immediate-access
contract — a query sees every document ingested before it — while batching
adjacent queries so the engine planner can route them to the batched device
path (``device_min_batch``): the classic serving trade of a tiny queueing
delay for much higher throughput.

Synchronous core, deliberately: one writer per shard is the paper's (and
Asadi & Lin's) concurrency model, and a thread-safe wrapper can wrap
``submit``/``flush`` without touching engine internals.  With
``pipelined=True`` the write path moves onto per-shard writer queues
(:class:`~repro_torch.serve.ingest_pipeline.IngestPipeline`): ``ingest`` /
``ingest_batch`` enqueue and return immediately, and the immediate-access
barrier moves to ``flush`` — which drains the pipeline before executing,
so a query still sees every document submitted before it.  The front door
itself stays a single thread; per-shard appends run in parallel behind it.

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
    """Batching executor over an :class:`~repro_torch.engine.Engine` (or a
    :class:`~repro_torch.core.sharded_index.ShardedEngine` — anything with
    ``add_document``/``execute_many``)."""

    def __init__(self, engine, max_batch: int = 32, cache_size: int = 256,
                 pipelined: bool = False, pipeline_queue: int = 8):
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
        self.pipeline = None
        if pipelined:
            from .ingest_pipeline import IngestPipeline
            self.pipeline = IngestPipeline(engine, max_queue=pipeline_queue)

    def close(self) -> None:
        """Drain and stop the ingest pipeline, if one is attached.  The
        service remains usable afterwards on the synchronous write path."""
        if self.pipeline is not None:
            self.pipeline.close()
            self.pipeline = None

    # -- result cache ----------------------------------------------------

    def _cache_key(self, query: Query) -> tuple | None:
        """(version, tier epoch, query) — None when the engine exposes no
        version counter or caching is off.  The epoch is the lifecycle's
        published tier epoch (0 without tiering): a background freeze
        swaps the tier without an ingest, so the version alone would keep
        serving entries computed against the previous tier.  Over a
        :class:`~repro_torch.core.sharded_index.ShardedEngine` the version
        is the fleet's and the lifecycle is its
        :class:`~repro_torch.core.lifecycle.FreezeCoordinator`, whose
        composite ``epoch`` bumps whenever ANY shard swaps its tier."""
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
        requires a query to see documents ingested before its submission.
        On the pipelined path this enqueues and returns the docid
        immediately; visibility is settled by ``flush``'s drain."""
        t0 = time.perf_counter()
        if self.pipeline is not None:
            d = self.pipeline.submit([terms])[0]
        else:
            d = self.engine.add_document(terms)
        self.ingest_latencies.append(time.perf_counter() - t0)
        return d

    def ingest_batch(self, docs) -> list[int]:
        """Ingest a batch of documents in one write-path pass (one chain-tail
        lookup and one contiguous encode per distinct term — see
        ``DynamicIndex.add_documents``).  Same flush semantics as
        ``ingest``: pending queries legally miss these documents."""
        t0 = time.perf_counter()
        if self.pipeline is not None:
            dids = self.pipeline.submit(docs)
        else:
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
        are fanned back out as private result copies.

        Pipelined mode: the in-flight ingest queues are DRAINED first —
        every pending query was submitted after those documents, so this
        one barrier honors every ticket's high-water mark at once, and
        after it the writer threads are idle, making the cache keys below
        (engine version) stable and the engine safe to fan out over."""
        if self.pipeline is not None:
            self.pipeline.drain()
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
