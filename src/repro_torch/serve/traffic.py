"""Open-loop traffic driver: tail latency, cache hit rate, availability.

Drives an :class:`~repro_torch.engine.Engine` or
:class:`~repro_torch.core.sharded_index.ShardedEngine` through a
:class:`~repro_torch.serve.query_service.QueryService` with a pre-generated
:mod:`~repro_torch.serve.workload` schedule, and reports what production cares
about and the mean-of-32-uniform-queries benches cannot show: p50/p99/p999
latency over a mixed Zipf ingest+query stream, result-cache hit rate, and
availability under freeze storms.

**Open-loop latency.**  Each event carries a scheduled arrival time; a
query's latency is its completion time minus the LATER-OF-NOTHING rule:

    latency = completion - min(scheduled_arrival, submit_time)

i.e. when the driver has fallen behind schedule (``submit > sched``) the
queueing delay counts against the system — the open-loop discipline that
makes tail percentiles honest (a closed loop would let a slow system slow
the arrival process and hide its own backlog).  When the driver runs ahead
of schedule (it never sleeps unless ``pace=True``), the event is charged
service time only.

**Determinism.**  The schedule is pure in its seed (see ``workload``), and
``clock`` is pluggable: tests pass a :class:`FakeClock` (fixed tick per
call) so the whole percentile report is bit-reproducible; benches use the
real ``time.perf_counter``.

**Availability.**  Every query is executed under a try/except; an exception
(or a missing result) counts into ``availability_gap``.  The zero-gap
acceptance criterion is exactly the lifecycle's promise: background freezes
swap tiers atomically, so no query ever fails or blocks on a swap.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .query_service import QueryService
from .workload import Event


class FakeClock:
    """Deterministic stand-in for ``time.perf_counter``: every call advances
    a fixed tick, so latencies (hence percentiles) are pure functions of
    the event schedule and call pattern."""

    def __init__(self, tick_s: float = 1e-6):
        self.tick_s = tick_s
        self.now = 0.0

    def __call__(self) -> float:
        self.now += self.tick_s
        return self.now


@dataclass(frozen=True)
class SLOSpec:
    """Service-level objectives the traffic report is judged against.
    ``None`` disables a bound.  Latency bounds are milliseconds;
    ``max_availability_gap`` is a count (production target: 0)."""

    p50_ms: float | None = None
    p99_ms: float | None = None
    p999_ms: float | None = None
    min_cache_hit_rate: float | None = None
    max_availability_gap: int | None = 0

    def evaluate(self, report: "TrafficReport") -> dict:
        """{"ok": bool, "violations": [human-readable strings]}."""
        v: list[str] = []
        for name, bound in (("p50_ms", self.p50_ms), ("p99_ms", self.p99_ms),
                            ("p999_ms", self.p999_ms)):
            got = getattr(report, name)
            if bound is not None and got > bound:
                v.append(f"{name} {got:.3f} > SLO {bound:.3f}")
        if (self.min_cache_hit_rate is not None
                and report.cache_hit_rate < self.min_cache_hit_rate):
            v.append(f"cache_hit_rate {report.cache_hit_rate:.3f} < "
                     f"SLO {self.min_cache_hit_rate:.3f}")
        if (self.max_availability_gap is not None
                and report.availability_gap > self.max_availability_gap):
            v.append(f"availability_gap {report.availability_gap} > "
                     f"SLO {self.max_availability_gap}")
        return {"ok": not v, "violations": v}

    def to_dict(self) -> dict:
        return {"p50_ms": self.p50_ms, "p99_ms": self.p99_ms,
                "p999_ms": self.p999_ms,
                "min_cache_hit_rate": self.min_cache_hit_rate,
                "max_availability_gap": self.max_availability_gap}


@dataclass
class TrafficReport:
    """Everything one traffic run measured.  ``to_dict`` is the payload a
    benchmark stores (the JAX package's ``BENCH_engine.json["traffic"]``
    shape)."""

    num_events: int = 0
    num_queries: int = 0
    num_ingests: int = 0
    num_deletes: int = 0
    duration_s: float = 0.0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    p999_ms: float = 0.0
    mean_ms: float = 0.0
    max_ms: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_hit_rate: float = 0.0
    availability_gap: int = 0     # queries that errored / went unanswered
    freezes: int = 0              # completed tier swaps during the run
    tier_epoch: int = 0
    qps: float = 0.0
    latencies_s: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float64), repr=False)

    def to_dict(self) -> dict:
        return {k: (float(v) if isinstance(v, float) else int(v))
                for k, v in (
                    ("num_events", self.num_events),
                    ("num_queries", self.num_queries),
                    ("num_ingests", self.num_ingests),
                    ("num_deletes", self.num_deletes),
                    ("duration_s", self.duration_s),
                    ("p50_ms", self.p50_ms), ("p99_ms", self.p99_ms),
                    ("p999_ms", self.p999_ms), ("mean_ms", self.mean_ms),
                    ("max_ms", self.max_ms),
                    ("cache_hits", self.cache_hits),
                    ("cache_misses", self.cache_misses),
                    ("cache_hit_rate", self.cache_hit_rate),
                    ("availability_gap", self.availability_gap),
                    ("freezes", self.freezes),
                    ("tier_epoch", self.tier_epoch),
                    ("qps", self.qps))}


def run_traffic(engine, schedule: list[Event], docs, *, max_batch: int = 32,
                cache_size: int = 256, clock=None, pace: bool = False,
                ingest_batch: int = 1,
                service: QueryService | None = None) -> TrafficReport:
    """Drive ``engine`` through ``schedule``; returns the measured report.

    ``docs`` is the ingest corpus — event ``doc`` indexes wrap around it.
    ``clock`` defaults to ``time.perf_counter``; pass a :class:`FakeClock`
    for deterministic reports.  ``pace=True`` sleeps until each event's
    scheduled arrival (real-time replay); the default runs as fast as the
    engine allows, which keeps benches quick while the open-loop latency
    rule above still charges any backlog to the system.

    Driver policy: pending queries are flushed BEFORE each ingest — they
    were submitted first, and completing them first keeps their latency
    from absorbing unrelated ingest cost.  (Immediate access never needs
    the opposite order: a query must only see documents ingested before its
    submission.)

    ``ingest_batch > 1`` coalesces consecutive ingest events into one
    ``QueryService.ingest_batch`` call (the batched write path).  Buffered
    documents are ALWAYS ingested before the next query submission or
    delete — every event that could observe them still sees exactly the
    documents scheduled before it, so answers (and cache behavior per
    engine version reached) are schedule-equivalent to the unbatched run.
    """
    clock = clock or time.perf_counter
    svc = service or QueryService(engine, max_batch=max_batch,
                                  cache_size=cache_size)
    lat: list[float] = []
    gap = 0
    pending: list[tuple] = []   # (ticket, effective_arrival)
    t_run0 = clock()

    def drain(batch) -> None:
        nonlocal gap
        if not batch:
            return
        done = clock()
        by_ticket = {id(t): a for t, a in pending}
        for t in batch:
            arr = by_ticket.pop(id(t), None)
            if arr is None:
                continue
            if t.result is None:
                gap += 1
            else:
                lat.append(max(done - arr, 0.0))
        pending[:] = [(t, a) for t, a in pending if id(t) in by_ticket]

    n_q = n_i = n_d = 0
    ingested: list[int] = []    # ingest ordinal -> real docid
    ibuf: list = []             # coalesced ingest docs awaiting submission

    def flush_ingests() -> None:
        nonlocal gap
        if not ibuf:
            return
        n = len(ibuf)
        try:
            ingested.extend(svc.ingest_batch(list(ibuf)))
        except Exception:
            gap += n
            ingested.extend([-1] * n)   # keep later ordinals aligned
        ibuf.clear()

    for ev in schedule:
        sched = t_run0 + ev.at_s
        if pace:
            delay = sched - clock()
            if delay > 0:
                time.sleep(delay)
        if ev.kind == "ingest":
            n_i += 1
            if ingest_batch > 1:
                ibuf.append(docs[ev.doc % len(docs)])
                if len(ibuf) >= ingest_batch:
                    drain(svc.flush())
                    flush_ingests()
                continue
            drain(svc.flush())
            try:
                ingested.append(svc.ingest(docs[ev.doc % len(docs)]))
            except Exception:
                gap += 1
                ingested.append(-1)     # keep later ordinals aligned
        elif ev.kind == "delete":
            # the target docid may still be in the coalescing buffer, and a
            # delete must observe every document scheduled before it
            flush_ingests()
            # svc.delete flushes pending itself (they must see the doc
            # alive); flushing here first lets drain() account latencies
            drain(svc.flush())
            n_d += 1
            try:
                svc.delete(ingested[ev.doc])
            except Exception:
                gap += 1
        else:
            # this query must see every ingest event scheduled before it
            flush_ingests()
            n_q += 1
            now = clock()
            try:
                t = svc.submit(ev.query)
            except Exception:
                gap += 1
                continue
            # open-loop: behind schedule -> charge queueing from the
            # scheduled arrival; ahead of schedule -> service time only
            pending.append((t, min(sched, now)))
            if t.done:          # submit auto-flushed a full batch
                drain([p for p, _ in pending if p.done])
    flush_ingests()
    drain(svc.flush())
    drain([p for p, _ in pending])  # anything left unanswered counts as gap
    t_run1 = clock()

    rep = TrafficReport(num_events=len(schedule), num_queries=n_q,
                        num_ingests=n_i, num_deletes=n_d,
                        duration_s=t_run1 - t_run0,
                        availability_gap=gap)
    if lat:
        a = np.asarray(lat, np.float64)
        rep.latencies_s = a
        p50, p99, p999 = np.quantile(a, [0.5, 0.99, 0.999])
        rep.p50_ms = float(p50 * 1e3)
        rep.p99_ms = float(p99 * 1e3)
        rep.p999_ms = float(p999 * 1e3)
        rep.mean_ms = float(a.mean() * 1e3)
        rep.max_ms = float(a.max() * 1e3)
    cs = svc.cache_stats()
    rep.cache_hits = cs["hits"]
    rep.cache_misses = cs["misses"]
    rep.cache_hit_rate = cs["hit_rate"]
    stats = engine.stats()
    rep.freezes = stats.freezes
    rep.tier_epoch = stats.tier_epoch
    if rep.duration_s > 0:
        rep.qps = n_q / rep.duration_s
    return rep


__all__ = ["FakeClock", "SLOSpec", "TrafficReport", "run_traffic"]
