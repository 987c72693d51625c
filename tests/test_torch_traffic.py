"""The port's workload generator and open-loop traffic driver
(``repro_torch.serve.workload`` / ``traffic``) against the JAX package's.

The same ``WorkloadSpec`` gives the reference's schedule event for event
(``at_s`` bit-equal; the same kind, document, terms, mode and k); under a
``FakeClock`` ``run_traffic`` gives the reference's ``TrafficReport`` for a
single engine and for a fleet, with background-free freezes and deletes;
the port's schedule-purity lint passes the port's generator.  The
reference's own traffic tests are mirrored on the port: seeded
determinism, SLO evaluation, zero availability gap under a freeze storm
(one engine and a fleet), and the service's cache counters.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.lifecycle import FreezePolicy as JaxPolicy
from repro.core.sharded_index import ShardedEngine as JaxFleet
from repro.engine import Engine as JaxEngine
from repro.serve import FakeClock as JaxClock
from repro.serve import WorkloadSpec as JaxSpec
from repro.serve import generate_schedule as jax_schedule
from repro.serve import run_traffic as jax_run_traffic
from repro_torch.analysis import purity
from repro_torch.core.lifecycle import FreezePolicy
from repro_torch.core.sharded_index import ShardedEngine
from repro_torch.engine import Engine, Query
from repro_torch.serve import (FakeClock, QueryService, SLOSpec,
                               TrafficReport, WorkloadSpec, build_query_pool,
                               generate_schedule, run_traffic)

from test_torch_sharded_engine import bounded

VOCAB = [f"v{i}" for i in range(200)]


def make_docs(n, seed=11):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    probs /= probs.sum()
    return [[VOCAB[i] for i in
             rng.choice(len(VOCAB), size=rng.integers(4, 25), p=probs)]
            for _ in range(n)]


SPEC = WorkloadSpec(seed=42, num_events=150, ingest_fraction=0.25,
                    num_distinct_queries=24, max_terms=3)

SMOKE_SLO = SLOSpec(p50_ms=2000.0, p99_ms=30000.0, p999_ms=60000.0,
                    max_availability_gap=0)


def jax_spec(spec: WorkloadSpec) -> JaxSpec:
    return JaxSpec(**dataclasses.asdict(spec))


def host_engine(**kw):
    return Engine(force_backend="host", device="cpu", **kw)


# --------------------------------------------------------------------------
# the port against the reference
# --------------------------------------------------------------------------


SPECS = [SPEC,
         WorkloadSpec(seed=7, num_events=400, ingest_fraction=0.2,
                      delete_fraction=0.05, num_distinct_queries=40),
         WorkloadSpec(seed=3, num_events=200, modes=("phrase", "proximity",
                                                     "bm25_prox", "bm25"))]


@pytest.mark.parametrize("spec", SPECS, ids=["mixed", "deletes",
                                              "positional"])
def test_schedule_equals_the_references(spec):
    """Event for event: ``at_s`` bit-equal, the same kind, document,
    terms, mode, k and window."""
    ours = generate_schedule(spec, VOCAB)
    ref = jax_schedule(jax_spec(spec), VOCAB)
    assert len(ours) == len(ref) == spec.num_events
    for a, b in zip(ours, ref):
        assert np.float64(a.at_s).tobytes() == np.float64(b.at_s).tobytes()
        assert (a.kind, a.doc) == (b.kind, b.doc)
        assert (a.query is None) == (b.query is None)
        if a.query is not None:
            assert (a.query.terms, a.query.mode, a.query.k, a.query.window) \
                == (b.query.terms, b.query.mode, b.query.k, b.query.window)


@pytest.mark.parametrize("fleet", [False, True], ids=["engine", "fleet"])
def test_fake_clock_report_equals_the_references(fleet):
    """Under a ``FakeClock`` the whole report — percentiles, counts, cache
    counters, freezes — is the reference's, with synchronous freezes and
    deletes in the schedule."""
    spec = WorkloadSpec(seed=5, num_events=300, ingest_fraction=0.25,
                        delete_fraction=0.03, num_distinct_queries=24)
    docs = make_docs(120)
    if fleet:
        ours = ShardedEngine(num_shards=2, force_backend="host",
                             device="cpu",
                             tier_policy=FreezePolicy(every_docs=30,
                                                      background=False))
        ref = JaxFleet(num_shards=2, force_backend="host",
                       tier_policy=JaxPolicy(every_docs=30,
                                             background=False))
    else:
        ours = host_engine(tier_policy=FreezePolicy(every_docs=30,
                                                    background=False))
        ref = JaxEngine(force_backend="host",
                        tier_policy=JaxPolicy(every_docs=30,
                                              background=False))
    a = run_traffic(ours, generate_schedule(spec, VOCAB), docs,
                    clock=FakeClock(), ingest_batch=3)
    b = jax_run_traffic(ref, jax_schedule(jax_spec(spec), VOCAB), docs,
                        clock=JaxClock(), ingest_batch=3)
    assert a.to_dict() == b.to_dict()
    assert a.num_deletes > 0 and a.freezes > 0
    assert a.latencies_s.tobytes() == b.latencies_s.tobytes()
    if fleet:
        bounded(ours.close)
        bounded(ref.close)


def test_schedule_purity_lint():
    """The port's lint (``repro_torch.analysis.purity``) rejects
    time-based nondeterminism in schedule generators — and passes the
    port's generator."""
    bad = "import time\nfrom random import random\nimport numpy as np\n"
    findings = purity.check_schedule_module(bad, "serve/workload.py")
    assert len(findings) == 2
    assert all(f.check == purity.SCHEDULE_CHECK for f in findings)
    import repro_torch.serve.workload as wl
    with open(wl.__file__) as f:
        clean = purity.check_schedule_module(f.read(), "serve/workload.py")
    assert clean == []


# --------------------------------------------------------------------------
# seeded determinism
# --------------------------------------------------------------------------


def test_same_seed_identical_schedule():
    a = generate_schedule(SPEC, VOCAB)
    b = generate_schedule(SPEC, VOCAB)
    assert a == b
    assert len(a) == SPEC.num_events


def test_different_seed_distinct_schedule():
    a = generate_schedule(SPEC, VOCAB)
    b = generate_schedule(dataclasses.replace(SPEC, seed=43), VOCAB)
    assert a != b


def test_schedule_shape():
    sched = generate_schedule(SPEC, VOCAB)
    ts = [e.at_s for e in sched]
    assert ts == sorted(ts) and ts[0] > 0.0
    assert {e.kind for e in sched} <= {"query", "ingest"}
    for e in sched:
        assert (e.query is None) == (e.kind == "ingest")
    frac = sum(e.kind == "ingest" for e in sched) / len(sched)
    assert 0.10 < frac < 0.45


def test_query_pool_modes_and_positional_arity():
    rng = np.random.default_rng(0)
    spec = WorkloadSpec(seed=0, num_distinct_queries=30,
                        modes=("conjunctive", "phrase", "proximity",
                               "bm25_prox"))
    pool = build_query_pool(spec, VOCAB, rng)
    assert len(pool) == 30
    assert {q.mode for q in pool} == set(spec.modes)
    for q in pool:
        if q.mode in ("phrase", "proximity"):
            assert len(q.terms) >= 2
        assert q.window is None or q.mode == "proximity"


def test_spec_validation():
    for bad in (dict(ingest_fraction=1.5), dict(delete_fraction=-0.1),
                dict(ingest_fraction=0.7, delete_fraction=0.4),
                dict(num_events=0), dict(rate_hz=0.0), dict(mean_off=0.5)):
        with pytest.raises(ValueError):
            WorkloadSpec(**bad)


def test_same_seed_identical_report():
    docs = make_docs(80)

    def once():
        eng = host_engine(tier_policy=FreezePolicy(every_docs=30,
                                                   background=False))
        rep = run_traffic(eng, generate_schedule(SPEC, VOCAB), docs,
                          clock=FakeClock())
        return rep.to_dict()

    a, b = once(), once()
    assert a == b
    assert a["availability_gap"] == 0 and a["num_events"] == 150


def test_fake_clock_is_deterministic():
    a, b = FakeClock(), FakeClock()
    assert [a() for _ in range(5)] == [b() for _ in range(5)]


# --------------------------------------------------------------------------
# SLO evaluation
# --------------------------------------------------------------------------


def test_slo_evaluate_bounds_and_violations():
    rep = TrafficReport(p50_ms=5.0, p99_ms=50.0, p999_ms=100.0,
                        cache_hit_rate=0.5, availability_gap=2)
    ok = SLOSpec(p50_ms=10.0, p99_ms=60.0, p999_ms=200.0,
                 min_cache_hit_rate=0.4, max_availability_gap=2)
    assert ok.evaluate(rep) == {"ok": True, "violations": []}
    strict = SLOSpec(p50_ms=1.0, p999_ms=99.0, min_cache_hit_rate=0.9,
                     max_availability_gap=0)
    ev = strict.evaluate(rep)
    assert not ev["ok"] and len(ev["violations"]) == 4
    assert SLOSpec(max_availability_gap=None).evaluate(rep)["ok"]


def test_traffic_under_freeze_storm_zero_gap():
    """An aggressive background freeze storm lands mid-stream and not one
    query fails or goes unanswered."""
    docs = make_docs(120)
    eng = host_engine(tier_policy=FreezePolicy(every_docs=15,
                                               background=True))
    rep = run_traffic(eng, generate_schedule(SPEC, VOCAB), docs)
    bounded(eng.lifecycle.wait)
    assert rep.availability_gap == 0
    assert rep.num_queries + rep.num_ingests == rep.num_events
    assert eng.lifecycle.freezes >= 1
    ev = SMOKE_SLO.evaluate(rep)
    assert ev["ok"], ev["violations"]


@pytest.mark.parametrize("pipelined", [False, True])
def test_traffic_sharded_zero_gap(pipelined):
    """A two-shard fleet under a freeze storm, through the synchronous and
    the pipelined service."""
    docs = make_docs(120)
    fleet = ShardedEngine(num_shards=2, force_backend="host", device="cpu",
                          tier_policy=FreezePolicy(every_docs=15,
                                                   background=True))
    svc = QueryService(fleet, pipelined=pipelined)
    try:
        rep = run_traffic(fleet, generate_schedule(SPEC, VOCAB), docs,
                          service=svc)
        assert rep.availability_gap == 0
        assert SMOKE_SLO.evaluate(rep)["ok"]
    finally:
        bounded(svc.close)
        bounded(fleet.close)


# --------------------------------------------------------------------------
# cache hit/miss accounting
# --------------------------------------------------------------------------

Q0 = Query(terms=("v0", "v1"), mode="bm25", k=5)


def test_cache_counters_hit_then_invalidate_on_ingest():
    eng = host_engine()
    for d in make_docs(30):
        eng.add_document(d)
    svc = QueryService(eng, max_batch=4, cache_size=32)
    svc.submit(Q0)
    svc.flush()
    assert svc.cache_stats() == {"hits": 0, "misses": 1, "hit_rate": 0.0,
                                 "entries": 1}
    svc.submit(Q0)
    svc.flush()
    assert (svc.cache_hits, svc.cache_misses) == (1, 1)
    assert svc.hit_rate == 0.5
    svc.ingest(["v0", "v1", "v7"])
    svc.submit(Q0)
    svc.flush()
    assert (svc.cache_hits, svc.cache_misses) == (1, 2)
    svc.submit(Q0)
    svc.flush()
    assert (svc.cache_hits, svc.cache_misses) == (2, 2)
    assert svc.hit_rate == 0.5


def test_cache_counters_across_epoch_bumps():
    eng = host_engine(tier_policy=FreezePolicy(every_docs=1000,
                                               background=False))
    for d in make_docs(40):
        eng.add_document(d)
    svc = QueryService(eng, max_batch=4, cache_size=32)
    for _ in range(2):
        svc.submit(Q0)
        svc.flush()
    assert (svc.cache_hits, svc.cache_misses) == (1, 1)
    epoch0 = eng.lifecycle.epoch
    eng.lifecycle.freeze(blocking=True)
    assert eng.lifecycle.epoch == epoch0 + 1
    for _ in range(2):
        svc.submit(Q0)
        svc.flush()
    assert (svc.cache_hits, svc.cache_misses) == (2, 2)


def test_cache_counters_sharded_tier_swap():
    fleet = ShardedEngine(num_shards=2, force_backend="host", device="cpu",
                          tier_policy=FreezePolicy(every_docs=1000,
                                                   background=False))
    try:
        for d in make_docs(40):
            fleet.add_document(d)
        svc = QueryService(fleet, max_batch=4, cache_size=32)
        for _ in range(2):
            svc.submit(Q0)
            svc.flush()
        assert (svc.cache_hits, svc.cache_misses) == (1, 1)
        fleet.engines[0].lifecycle.freeze(blocking=True)  # one shard only
        for _ in range(2):
            svc.submit(Q0)
            svc.flush()
        assert (svc.cache_hits, svc.cache_misses) == (2, 2)
        assert svc.cache_stats()["hit_rate"] == 0.5
    finally:
        bounded(fleet.close)


def test_uncacheable_counts_as_neither():
    eng = host_engine()
    for d in make_docs(10):
        eng.add_document(d)
    svc = QueryService(eng, max_batch=4, cache_size=0)
    svc.submit(Q0)
    svc.flush()
    assert svc.cache_stats() == {"hits": 0, "misses": 0, "hit_rate": 0.0,
                                 "entries": 0}
