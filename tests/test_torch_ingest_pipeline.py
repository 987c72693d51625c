"""The port's pipelined write path (``repro_torch.serve.ingest_pipeline``)
and ``QueryService(pipelined=True)``, mirroring the JAX package's tests:
tickets and the barrier, marks that advance by the full batch on every
shard, back-pressure, a writer's error reaching the caller, an idempotent
``close``, a front door that moves between threads, and a stress run with
background freezes and deletes held against the JAX package's synchronous
service over its own fleet.  The pipelined service also serves the port's
device path (``device="cpu"``: the fused op's plain version) over a single
engine and over a fleet, refreshed on the querying thread after the drain.

Every blocking wait runs through ``bounded`` (a join with a timeout), so a
hang fails the test instead of stalling the run.
"""

import threading

import numpy as np
import pytest

from repro.core.lifecycle import FreezePolicy as JaxPolicy
from repro.core.sharded_index import ShardedEngine as JaxFleet
from repro.serve import QueryService as JaxService
from repro.engine import Query as JaxQuery
from repro_torch.core.lifecycle import FreezePolicy
from repro_torch.core.sharded_index import ShardedEngine
from repro_torch.engine import Engine, Query
from repro_torch.serve import QueryService
from repro_torch.serve.ingest_pipeline import IngestPipeline, IngestTicket

from test_torch_fused_query import assert_ranking
from test_torch_sharded_engine import WAIT_S, bounded


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(2024)
    vocab = [f"t{i}" for i in range(100)]
    probs = 1.0 / np.arange(1, 101) ** 1.05
    probs /= probs.sum()
    docs = [[vocab[i] for i in rng.choice(100, size=rng.integers(5, 30),
                                          p=probs)]
            for _ in range(240)]
    return vocab, docs


def cpu_engine(**kw):
    return Engine(B=64, device="cpu", **kw)


# --------------------------------------------------------------------------
# barrier mechanics
# --------------------------------------------------------------------------


def test_ticket_and_wait(corpus):
    _, docs = corpus
    pipe = IngestPipeline(cpu_engine())
    try:
        t0 = pipe.ticket()
        assert t0 == IngestTicket((0,))
        bounded(pipe.wait, t0)
        ids = pipe.submit(docs[:10])
        assert ids == list(range(1, 11))
        t1 = pipe.ticket()
        assert t1.marks == (10,)
        bounded(pipe.wait, t1)
        assert not pipe.in_flight()
        bounded(pipe.wait, t0)              # old tickets stay satisfied
        assert pipe.submit(docs[10:13]) == [11, 12, 13]
        bounded(pipe.drain)
        assert pipe.engine.index.num_docs == 13
    finally:
        bounded(pipe.close)


def test_sharded_marks_advance_by_full_batch(corpus):
    _, docs = corpus
    se = ShardedEngine(num_shards=3, B=64, device="cpu")
    pipe = IngestPipeline(se)
    try:
        pipe.submit(docs[:7])
        # every shard's mark advances by the WHOLE batch (own sub-batch +
        # version bumps for the documents it does not own)
        assert pipe.ticket().marks == (7, 7, 7)
        bounded(pipe.drain)
        assert [e.version for e in se.engines] == [7, 7, 7]
        assert se.num_docs == 7
    finally:
        bounded(pipe.close)
        bounded(se.close)


def test_bounded_queue_backpressure(corpus):
    """A queue of one batch makes ``submit`` block on slow writers; the
    run still applies every document."""
    _, docs = corpus
    pipe = IngestPipeline(cpu_engine(), max_queue=1)

    def storm():
        for i in range(0, 200, 5):
            pipe.submit(docs[i % len(docs):(i % len(docs)) + 5])
        pipe.drain()

    try:
        bounded(storm)
        assert pipe.engine.index.num_docs == 200
    finally:
        bounded(pipe.close)


def test_writer_error_propagates():
    eng = cpu_engine()

    def boom(docs):
        raise ValueError("writer exploded")

    eng.add_documents = boom
    pipe = IngestPipeline(eng)
    pipe.submit([["a", "b"]])
    with pytest.raises(RuntimeError, match="ingest writer"):
        bounded(pipe.drain)
    # close() after a writer death must not hang or mask the error
    with pytest.raises(RuntimeError, match="ingest writer"):
        bounded(pipe.close)


def test_close_is_idempotent(corpus):
    _, docs = corpus
    pipe = IngestPipeline(cpu_engine())
    pipe.submit(docs[:5])
    bounded(pipe.close)
    bounded(pipe.close)
    assert pipe.engine.index.num_docs == 5


def test_front_door_thread_handoff(corpus):
    """The front door may move between threads as long as calls never
    overlap: submits from a second thread, then a drain and a query from
    the main thread."""
    _, docs = corpus
    eng = cpu_engine()
    pipe = IngestPipeline(eng)
    try:
        done = threading.Event()

        def front():
            for i in range(0, 60, 6):
                pipe.submit(docs[i:i + 6])
            done.set()

        th = threading.Thread(target=front)
        th.start()
        th.join(WAIT_S)
        assert not th.is_alive() and done.is_set()
        bounded(pipe.drain)
        assert eng.index.num_docs == 60
        r = eng.execute(Query(terms=(docs[0][0],), mode="conjunctive"))
        assert len(r.docids) > 0
    finally:
        bounded(pipe.close)


# --------------------------------------------------------------------------
# stress: mixed ingest/query/delete under background freezes
# --------------------------------------------------------------------------


def test_pipelined_stress_with_freezes(corpus):
    """The whole serving stack: pipelined ingest into the port's four-shard
    fleet with background freezes, queries and deletes at the front door
    between batches, against the JAX package's synchronous service over
    its own fleet — docids and score bytes equal throughout and after."""
    vocab, docs = corpus
    oracle = JaxService(JaxFleet(
        num_shards=4, B=64,
        tier_policy=JaxPolicy(every_docs=25, background=True)))
    svc = QueryService(ShardedEngine(
        num_shards=4, B=64, device="cpu",
        tier_policy=FreezePolicy(every_docs=25, background=True)),
        pipelined=True, pipeline_queue=2)
    rng = np.random.default_rng(99)

    def same(terms, mode):
        ra = oracle.query(JaxQuery(terms=terms, mode=mode, k=10))
        rb = svc.query(Query(terms=terms, mode=mode, k=10))
        assert ra.docids.tolist() == rb.docids.tolist(), (mode, terms)
        if ra.scores is not None:
            assert ra.scores.tobytes() == rb.scores.tobytes()

    def run():
        pos = 0
        deleted = []
        for step in range(24):
            n = int(rng.integers(1, 14))
            batch = docs[pos:pos + n]
            pos += len(batch)
            if not batch:
                break
            a = oracle.ingest_batch(batch)
            b = svc.ingest_batch(batch)
            assert a == b
            if step % 3 == 2:
                same(tuple(vocab[i] for i in
                           rng.choice(50, size=2, replace=False)), "bm25")
            if step % 5 == 4 and a:
                victim = int(rng.choice(a))
                oracle.delete(victim)
                svc.delete(victim)
                deleted.append(victim)
        svc.pipeline.drain()
        svc.engine.drain_freezes()
        oracle.engine.drain_freezes()
        assert svc.engine.num_docs == oracle.engine.num_docs == pos
        assert svc.engine.stats().deleted_docs == len(deleted)
        for mode in ("conjunctive", "ranked_tfidf", "bm25"):
            for _ in range(6):
                same(tuple(vocab[i] for i in rng.choice(
                    60, size=int(rng.integers(1, 4)), replace=False)), mode)

    try:
        bounded(run)
    finally:
        bounded(svc.close)
        bounded(svc.engine.close)
        bounded(oracle.engine.close)


@pytest.mark.parametrize("shards", [0, 2], ids=["engine", "fleet"])
def test_pipelined_service_serves_the_device_path(corpus, shards):
    """``QueryService(pipelined=True)`` over one engine and over a
    two-shard fleet, both on ``device="cpu"``: after a freeze, pipelined
    batches and deletes, every device-served batch equals the service's
    host answers (conjunctive exactly, ranked within rtol 1e-5), and each
    query sees every document submitted before it."""
    vocab, docs = corpus
    kw = dict(B=64, growth="const", device="cpu", delta_compact_frac=None)
    eng = (ShardedEngine(num_shards=shards, **kw) if shards
           else Engine(**kw))
    svc = QueryService(eng, max_batch=8, cache_size=0, pipelined=True)
    rng = np.random.default_rng(5)

    def served(mode, backend):
        qs = [Query(terms=tuple(vocab[i] for i in rng.choice(
            30, size=int(rng.integers(1, 4)), replace=False)), mode=mode,
            k=10, backend=backend) for _ in range(8)]
        tickets = [svc.submit(q) for q in qs]      # 8 fill a batch
        return qs, [t.result for t in tickets]

    def run():
        for i in range(0, 120, 20):
            svc.ingest_batch(docs[i:i + 20])
        svc.flush()                                # drains the pipeline
        eng.collate_now()
        for i in range(120, 200, 16):
            svc.ingest_batch(docs[i:i + 16])
            svc.delete(i - 7)                      # flushes and drains
        new = svc.ingest_batch([["zz-fresh", vocab[0]]])[0]
        got = svc.query(Query(terms=("zz-fresh",), mode="conjunctive",
                              backend="device"))
        assert got.docids.tolist() == [new]        # immediate access
        for mode in ("conjunctive", "ranked_tfidf", "bm25"):
            qs, dev = served(mode, None)
            assert all(r.backend == "device" for r in dev)
            host = svc.engine.execute_many(
                [Query(terms=q.terms, mode=mode, k=10, backend="host")
                 for q in qs])
            for r, h in zip(dev, host):
                if mode == "conjunctive":
                    assert r.docids.tolist() == h.docids.tolist()
                else:
                    assert_ranking(r.docids, r.scores, h.docids, h.scores,
                                   1e-5)

    try:
        bounded(run)
    finally:
        bounded(svc.close)
        if shards:
            bounded(eng.close)
