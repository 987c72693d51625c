"""Deterministic Zipf workload schedules for the traffic harness.

Realistic serving load is nothing like the benches' 32 uniform queries:
query popularity and term choice are both heavily Zipf-skewed (Asadi & Lin:
skew, not uniform sampling, is what exposes tail behaviour in incremental
in-memory indexes), arrivals come in bursts, and ingest interleaves with
querying.  This module generates exactly that — as a pure function of a
:class:`WorkloadSpec` and its seed.

Schedule generation is deliberately HERMETIC: no wall clock, no global RNG,
no ambient state — every event time comes from ``numpy``'s seeded
``default_rng``.  The schedule-purity lint
(``analysis.purity.check_schedule_module``) enforces the import surface (no
``time``/``random``/``datetime``), and the traffic tests pin seed
determinism end to end: same seed → identical schedule and identical
percentile report.

Workload shape:

  * a **distinct-query pool** is drawn first (``num_distinct_queries``
    queries; terms Zipf-picked over the frequency-ranked vocabulary, modes
    cycled from ``modes``); each query event then samples the pool under a
    Zipf popularity law — the repetition that makes result caching mean
    something;
  * **mixed stream**: each event is an ingest with probability
    ``ingest_fraction`` (documents are consumed in corpus order), else a
    query;
  * **bursty (on/off) arrivals**: the arrival process alternates ON bursts
    (exponential inter-arrivals at ``rate_hz``) and OFF lulls
    (``off_rate_hz``), with geometric burst/lull lengths — the classic
    two-state MMPP shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..engine.types import POSITIONAL_MODES, Query


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything that determines a schedule, seed included.

    ``modes`` must fit the target engine: positional modes (phrase /
    proximity / bm25_prox) need a word-level engine.  ``rate_hz`` /
    ``off_rate_hz`` are the ON-burst and OFF-lull arrival rates;
    ``mean_burst`` / ``mean_off`` the mean event counts per state.
    """

    seed: int = 0
    num_events: int = 2000
    ingest_fraction: float = 0.2
    # fraction of events that tombstone a random still-live prior ingest
    # (0.0 = the historical ingest+query mix; a delete event with nothing
    # yet deletable degrades to a query, keeping the stream seed-pure)
    delete_fraction: float = 0.0
    num_distinct_queries: int = 64
    query_zipf_s: float = 1.07
    term_zipf_s: float = 1.07
    max_terms: int = 3
    modes: tuple[str, ...] = ("conjunctive", "ranked_tfidf", "bm25")
    k: int = 10
    window: int = 8
    rate_hz: float = 2000.0
    off_rate_hz: float = 200.0
    mean_burst: float = 50.0
    mean_off: float = 20.0

    def __post_init__(self):
        if not 0.0 <= self.ingest_fraction <= 1.0:
            raise ValueError("ingest_fraction must be in [0, 1]")
        if not 0.0 <= self.delete_fraction <= 1.0:
            raise ValueError("delete_fraction must be in [0, 1]")
        if self.ingest_fraction + self.delete_fraction > 1.0:
            raise ValueError("ingest_fraction + delete_fraction must "
                             "not exceed 1")
        if self.num_distinct_queries < 1 or self.num_events < 1:
            raise ValueError("need >= 1 distinct query and >= 1 event")
        if min(self.rate_hz, self.off_rate_hz) <= 0:
            raise ValueError("arrival rates must be positive")
        if min(self.mean_burst, self.mean_off) < 1.0:
            raise ValueError("mean burst/off lengths must be >= 1 event")


@dataclass(frozen=True)
class Event:
    """One scheduled arrival: a query (with its Query value), an ingest
    (``doc`` indexes the driver's corpus, assigned in arrival order), or a
    delete (``doc`` is the INGEST ORDINAL of the victim — the driver maps
    it to the real docid it got back from that ingest)."""

    at_s: float
    kind: str                   # "query" | "ingest" | "delete"
    query: Query | None = None
    doc: int | None = None


def _zipf_probs(n: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return p / p.sum()


def build_query_pool(spec: WorkloadSpec, vocab: list[str],
                     rng: np.random.Generator) -> list[Query]:
    """The distinct-query population: terms Zipf-drawn (without replacement
    per query) over the vocabulary in rank order — pass ``vocab`` sorted by
    descending collection frequency for the realistic head-heavy mix."""
    tp = _zipf_probs(len(vocab), spec.term_zipf_s)
    pool = []
    for i in range(spec.num_distinct_queries):
        mode = spec.modes[i % len(spec.modes)]
        nt = int(rng.integers(1, spec.max_terms + 1))
        if mode in POSITIONAL_MODES and mode != "bm25_prox":
            nt = max(nt, 2)  # 1-term phrase/proximity is degenerate
        picks = rng.choice(len(vocab), size=min(nt, len(vocab)),
                           replace=False, p=tp)
        pool.append(Query(
            terms=tuple(str(vocab[j]) for j in picks), mode=mode, k=spec.k,
            window=spec.window if mode == "proximity" else None))
    return pool


def generate_schedule(spec: WorkloadSpec, vocab: list[str]) -> list[Event]:
    """The full deterministic event schedule for ``spec``: ``num_events``
    arrivals with non-decreasing ``at_s``, mixed ingest/query, bursty
    on/off inter-arrival times.  Pure in the seed — calling twice with the
    same spec yields identical events."""
    rng = np.random.default_rng(spec.seed)
    pool = build_query_pool(spec, vocab, rng)
    qp = _zipf_probs(len(pool), spec.query_zipf_s)
    events: list[Event] = []
    t = 0.0
    doc_counter = 0
    alive: list[int] = []       # ingest ordinals not yet scheduled deleted
    on = True
    left = int(rng.geometric(1.0 / spec.mean_burst))
    while len(events) < spec.num_events:
        if left <= 0:
            on = not on
            mean = spec.mean_burst if on else spec.mean_off
            left = int(rng.geometric(1.0 / mean))
            continue
        rate = spec.rate_hz if on else spec.off_rate_hz
        t += float(rng.exponential(1.0 / rate))
        left -= 1
        r = float(rng.random())
        if r < spec.ingest_fraction:
            events.append(Event(at_s=t, kind="ingest", doc=doc_counter))
            alive.append(doc_counter)
            doc_counter += 1
        elif r < spec.ingest_fraction + spec.delete_fraction and alive:
            # victim uniform over still-live prior ingests; each ordinal is
            # deleted at most once (double deletes are an error downstream)
            pick = int(rng.integers(len(alive)))
            events.append(Event(at_s=t, kind="delete", doc=alive.pop(pick)))
        else:
            q = pool[int(rng.choice(len(pool), p=qp))]
            events.append(Event(at_s=t, kind="query", query=q))
    return events


__all__ = ["WorkloadSpec", "Event", "build_query_pool", "generate_schedule"]
