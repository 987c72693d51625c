"""The port's host fleet (``repro_torch.core.sharded_index.ShardedEngine``)
against the JAX package's.

The same stream goes through both packages' fleets: every answer's docids
and score bytes are equal, doc-level and word-level, Const and Triangle,
with background freezes under the fleet's coordinator at ``max_in_flight``
1 and 2, and deletes.  The port's fleet with ``device="cpu"``, forced to
its ``device`` and ``kernel`` backends (the kernels' plain versions), is
held against the reference's single-engine host oracle over the whole
stream, deletes after a freeze included, and a term whose deletes and adds
cancel on one shard after the freeze (the reference's fault C1) keeps its
post-freeze postings.  The reference's own fleet tests are mirrored on the
port: round-robin docid arithmetic, parallel against serial fan-out (bit
for bit), the freeze coordinator's budget, caching, composite statistics.
The kernel loader builds a library once when threads load it together.

Every blocking wait in this file runs through :func:`bounded`, so a hang
fails the test instead of stalling the run.
"""

import threading
from dataclasses import astuple

import numpy as np
import pytest
import torch

from repro.core.sharded_index import ShardedEngine as JaxFleet
from repro.core.lifecycle import FreezePolicy as JaxPolicy
from repro.engine import Engine as JaxEngine
from repro.engine import Query as JaxQuery
from repro_torch.core import static_index as static_index_mod
from repro_torch.core.index import DynamicIndex
from repro_torch.core.lifecycle import (FreezeCoordinator, FreezeManager,
                                        FreezePolicy)
from repro_torch.core.sharded_index import ShardedEngine
from repro_torch.engine import Engine, Query
from repro_torch.kernels import build
from repro_torch.serve import QueryService

from test_torch_fused_query import assert_ranking

MODES = ("conjunctive", "ranked_tfidf", "bm25")
WAIT_S = 60


def bounded(fn, *args, timeout=WAIT_S):
    """Run ``fn(*args)`` on a helper thread joined with a timeout: a call
    that hangs fails the test; an exception it raises is re-raised."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as exc:        # handed back to the test
            box["exc"] = exc

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"{fn} did not return within {timeout} s"
    if "exc" in box:
        raise box["exc"]
    return box.get("out")


@pytest.fixture(scope="module")
def stream_docs():
    rng = np.random.default_rng(1234)
    vocab = [f"t{i}" for i in range(120)]
    probs = 1.0 / np.arange(1, 121) ** 1.05
    probs /= probs.sum()
    docs = [[vocab[i] for i in rng.choice(120, size=rng.integers(5, 40),
                                          p=probs)]
            for _ in range(320)]
    return vocab, docs


def _modes(word_level):
    base = list(MODES)
    if word_level:
        base += ["phrase", "proximity", "bm25_prox"]
    return base


def fleet(num_shards=2, **kw):
    return ShardedEngine(num_shards=num_shards, B=64, device="cpu", **kw)


def _bits(r):
    return (r.docids.tobytes(),
            None if r.scores is None else r.scores.tobytes())


def _assert_byte_identical(se, oracle, terms, mode, k=10):
    kw = dict(window=5) if mode == "proximity" else {}
    r = se.execute(Query(terms=terms, mode=mode, k=k, **kw))
    q_cls = JaxQuery if isinstance(oracle, JaxEngine) else Query
    e = oracle.execute(q_cls(terms=terms, mode=mode, k=k, backend="host",
                             **kw))
    assert r.docids.tolist() == e.docids.tolist(), (mode, terms)
    if e.scores is not None:
        assert np.array_equal(r.scores, e.scores), (mode, terms)


# --------------------------------------------------------------------------
# the port's fleet against the reference's fleet, bit for bit
# --------------------------------------------------------------------------


CROSS = [(g, w, m) for g in ("const", "triangle") for w in (False, True)
         for m in (1, 2)]
CROSS_IDS = [f"{g}-{'word' if w else 'doc'}-inflight{m}"
             for g, w, m in CROSS]


@pytest.mark.parametrize("growth,word_level,max_in_flight", CROSS,
                         ids=CROSS_IDS)
def test_port_fleet_equals_reference_fleet(stream_docs, growth, word_level,
                                           max_in_flight):
    """One stream (single and batched ingest, deletes) into both packages'
    three-shard fleets, background freezes under each coordinator: every
    mode's docids and score bytes equal, unforced and forced to the host,
    and the same fleet state after the freezes settle."""
    vocab, docs = stream_docs
    port = fleet(3, growth=growth, word_level=word_level,
                 max_in_flight=max_in_flight,
                 tier_policy=FreezePolicy(every_docs=20, background=True))
    ref = JaxFleet(num_shards=3, B=64, growth=growth, word_level=word_level,
                   max_in_flight=max_in_flight,
                   tier_policy=JaxPolicy(every_docs=20, background=True))
    rng = np.random.default_rng(7 + word_level)

    def check(n=2):
        for _ in range(n):
            terms = tuple(vocab[i] for i in rng.choice(
                60, size=int(rng.integers(1, 4)), replace=False))
            for mode in _modes(word_level):
                kw = dict(window=5) if mode == "proximity" else {}
                for backend in (None, "host"):
                    a = port.execute(Query(terms=terms, mode=mode, k=10,
                                           backend=backend, **kw))
                    b = ref.execute(JaxQuery(terms=terms, mode=mode, k=10,
                                             backend=backend, **kw))
                    assert _bits(a) == _bits(b), (mode, terms, backend)

    try:
        for i in range(0, 240, 8):
            if i % 16:
                assert port.add_documents(docs[i:i + 8]) == \
                    ref.add_documents(docs[i:i + 8])
            else:
                for d in docs[i:i + 8]:
                    assert port.add_document(d) == ref.add_document(d)
            if i % 40 == 32:
                victim = int(rng.integers(1, port.num_docs + 1))
                if victim not in port.engines[(victim - 1) % 3] \
                        .index.tombstones:
                    port.delete_document(victim)
                    ref.delete_document(victim)
                check()
        bounded(port.drain_freezes)
        bounded(ref.drain_freezes)
        assert port.coordinator.peak_in_flight <= max_in_flight
        assert all(e.lifecycle.freezes >= 1 for e in port.engines)
        check(4)
        assert port._ft == ref._ft
        assert astuple(port._counts) == astuple(ref._counts)
        # each shard holds the same chains (their block layout depends on
        # when a deferred freeze's collation ran, a matter of timing)
        for pe, re_ in zip(port.engines, ref.engines):
            assert pe.vocab == re_.vocab
            assert pe.index.tombstones == re_.index.tombstones
            for tb in pe.vocab:
                for a, b in zip(pe.index.postings(tb),
                                re_.index.postings(tb)):
                    assert np.array_equal(a, b), tb
            assert pe.version == re_.version
    finally:
        bounded(port.close)
        bounded(ref.close)


@pytest.mark.parametrize("word_level", [False, True],
                         ids=["doc_level", "word_level"])
def test_sharded_byte_identical_to_oracle_during_freezes(
        stream_docs, word_level):
    """The reference's acceptance differential on the port: a four-shard
    fleet ≡ a single-engine host oracle over the same stream, every mode,
    with background freezes completing mid-stream under the coordinator —
    and the oracle here is the JAX package's engine."""
    vocab, docs = stream_docs
    se = fleet(4, growth="const", word_level=word_level,
               tier_policy=FreezePolicy(every_docs=20, background=True),
               max_in_flight=1)
    oracle = JaxEngine(B=64, growth="const", word_level=word_level)
    rng = np.random.default_rng(5 + word_level)

    def check(n=2):
        for _ in range(n):
            nt = int(rng.integers(1, 4))
            terms = tuple(vocab[i] for i in
                          rng.choice(60, size=nt, replace=False))
            for mode in _modes(word_level):
                _assert_byte_identical(se, oracle, terms, mode)

    for i, d in enumerate(docs):
        g = se.add_document(d)
        assert g == oracle.add_document(d)   # same global docid stream
        if i % 9 == 4:
            check()
    assert se.coordinator.peak_in_flight <= 1
    bounded(se.drain_freezes)
    assert all(e.lifecycle.freezes >= 1 for e in se.engines)
    assert se.coordinator.epoch == sum(e.lifecycle.epoch
                                       for e in se.engines) > 0
    check(6)                                 # after every tier swap settled
    bounded(se.close)


# --------------------------------------------------------------------------
# the device and kernel paths (plain versions on the CPU) against the host
# --------------------------------------------------------------------------


def _oracle_stream(stream_docs, port, oracle, deletes):
    """200 documents, a freeze, 60 more, then ``deletes`` (global docids
    on both sides of the freeze)."""
    _, docs = stream_docs
    for i in range(0, 200, 50):
        assert port.add_documents(docs[i:i + 50]) == \
            oracle.add_documents(docs[i:i + 50])
    port.collate_now()
    oracle.collate_now()
    for d in docs[200:260]:
        assert port.add_document(d) == oracle.add_document(d)
    for d in deletes:
        port.delete_document(d)
        oracle.delete_document(d)


@pytest.mark.parametrize("backend", ["device", "kernel"])
def test_fleet_device_paths_equal_reference_oracle(stream_docs, backend):
    """The fleet forced to ``device`` or ``kernel`` on the CPU (the fused
    op's plain version on each shard's frozen image and delta; a Const
    index sends ``kernel`` to the fused path too), after deletes on both
    sides of the freeze: each answer against the reference's
    single-engine host oracle, conjunctive exactly, ranked within rtol
    1e-5 (the shards score in float32); the fleet's host path equals the
    oracle bit for bit."""
    vocab, docs = stream_docs
    se = fleet(2, growth="const", delta_compact_frac=None)
    oracle = JaxEngine(B=64, growth="const")
    _oracle_stream(stream_docs, se, oracle, (3, 4, 150, 201, 230, 259))
    rng = np.random.default_rng(17)
    for mode in MODES:
        batch = [Query(terms=tuple(vocab[i] for i in rng.choice(
            40, size=int(rng.integers(1, 4)), replace=False)),
            mode=mode, k=10, backend=backend) for _ in range(8)]
        got = se.execute_many(batch)
        host = se.execute_many([Query(terms=q.terms, mode=mode, k=10,
                                      backend="host") for q in batch])
        assert all(r.backend == backend for r in got)
        for q, r, h in zip(batch, got, host):
            e = oracle.execute(JaxQuery(terms=q.terms, mode=mode, k=10,
                                        backend="host"))
            assert _bits(h) == _bits(e), (mode, q.terms)
            if mode == "conjunctive":
                assert r.docids.tolist() == e.docids.tolist()
            else:
                assert_ranking(r.docids, r.scores, e.docids, e.scores, 1e-5)
    bounded(se.close)


def test_sharded_device_batches_match_oracle(stream_docs):
    """The reference's test on the port: batched fan-out routes each shard
    to its device image (planner default); the rebased (N, f_t, avgdl)
    make device scores match the global oracle to float32 tolerance."""
    vocab, docs = stream_docs
    se = fleet(2, growth="const")
    oracle = JaxEngine(B=64, growth="const")
    for d in docs[:200]:
        se.add_document(d)
        oracle.add_document(d)
    se.collate_now()
    for d in docs[200:260]:
        se.add_document(d)
        oracle.add_document(d)
    rng = np.random.default_rng(17)
    for mode in ("ranked_tfidf", "bm25"):
        batch = [Query(terms=tuple(vocab[i] for i in
                                   rng.choice(40, size=2, replace=False)),
                       mode=mode, k=10) for _ in range(6)]
        res = se.execute_many(batch)
        assert all(r.backend == "device" for r in res)
        for r, q in zip(res, batch):
            e = oracle.execute(JaxQuery(terms=q.terms, mode=mode, k=10,
                                        backend="host"))
            assert_ranking(r.docids, r.scores, e.docids, e.scores, 1e-5)
    bounded(se.close)


def test_fleet_c1_regression_device_path_keeps_post_freeze_postings():
    """Shard 0 gets the reference's C1 stream (a freeze, then deletes of
    t0-documents that exactly cancel the t0-documents added after it),
    shard 1 a filler document after each of them.  Shard 0's live f_t of
    t0 is back at its freeze value although t0 gained postings; the
    fleet's device answers still equal its host answers and the
    reference's single-engine host oracle over the same global stream."""
    from test_torch_engine import C1_OPS

    se = fleet(2, growth="const", delta_compact_frac=None)
    oracle = JaxEngine(B=64, growth="const")
    for op in C1_OPS:
        if op[0] == "add":
            for d in (op[1], ["f"]):         # shard 0's doc, shard 1's
                assert se.add_document(d) == oracle.add_document(d)
        elif op[0] == "delete":
            g = 2 * op[1] - 1                # shard 0's local docid
            se.delete_document(g)
            oracle.delete_document(g)
        else:
            se.collate_now()
            oracle.collate_now()
    shard = se.engines[0]
    tid = shard.term_id("t0")
    base = shard.resident._baseline
    assert shard._fts[tid] == base.ft[tid] < shard._appended_fts[tid]
    want = oracle.execute(JaxQuery(terms=("t0",), mode="conjunctive",
                                   backend="host")).docids.tolist()
    assert want == [2 * d - 1 for d in (6, 7, 8, 9, 10, 11, 14)]
    for backend in ("host", "device"):
        got = se.execute(Query(terms=("t0",), mode="conjunctive",
                               backend=backend))
        assert got.docids.tolist() == want, backend
    for mode in ("ranked_tfidf", "bm25"):
        for terms in (("t0",), ("t0", "t1"), ("t1", "t2"), ("t0", "f")):
            e = oracle.execute(JaxQuery(terms=terms, mode=mode, k=10,
                                        backend="host"))
            r = se.execute(Query(terms=terms, mode=mode, k=10,
                                 backend="device"))
            assert_ranking(r.docids, r.scores, e.docids, e.scores, 1e-5)
    bounded(se.close)


def test_fleet_defaults_to_the_card(monkeypatch):
    """Like ``Engine``, a fleet without ``device`` puts every shard's
    device images on the card, and raises where there is no CUDA
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEngine(num_shards=2, B=64)


# --------------------------------------------------------------------------
# round-robin docid arithmetic (no per-document maps)
# --------------------------------------------------------------------------


def test_round_robin_arithmetic(stream_docs):
    vocab, docs = stream_docs
    S = 3
    se = fleet(S, growth="const")
    for g, d in enumerate(docs[:50], start=1):
        assert se.add_document(d) == g
    assert se.num_docs == 50
    for s in range(S):
        locals_ = np.arange(1, se.engines[s].index.num_docs + 1)
        gids = se._globalize(s, locals_)
        assert ((gids - 1) % S == s).all()
        assert (((gids - 1) // S + 1) == locals_).all()
    assert not hasattr(se, "_owner") and not hasattr(se, "_to_global")
    bounded(se.close)


@pytest.mark.parametrize("backend", [None, "device"])
def test_parallel_and_serial_fanout_agree(stream_docs, backend):
    """Answers of the parallel fan-out equal the serial one's bit for bit,
    on the host path and on the device path (two shards' plain fused ops
    from two pool threads)."""
    vocab, docs = stream_docs
    par = fleet(3, growth="const", parallel=True)
    ser = fleet(3, growth="const", parallel=False)
    assert par._pool is not None and ser._pool is None
    for d in docs[:90]:
        par.add_document(d)
        ser.add_document(d)
    for e in (par, ser):
        e.collate_now()
        e.add_documents(docs[90:120])
        e.delete_document(7)
    rng = np.random.default_rng(23)
    for _ in range(5):
        batch = [Query(terms=tuple(vocab[i] for i in rng.choice(
            40, size=2, replace=False)), mode=mode, k=10, backend=backend)
            for mode in MODES]
        for a, b in zip(par.execute_many(batch), ser.execute_many(batch)):
            assert _bits(a) == _bits(b)
    bounded(par.close)


# --------------------------------------------------------------------------
# backend-set reporting
# --------------------------------------------------------------------------


def test_fused_result_reports_backend_set(stream_docs):
    vocab, docs = stream_docs
    se = fleet(2, growth="const", tier_policy=FreezePolicy())
    for d in docs[:80]:
        se.add_document(d)
    # freeze ONLY shard 0: its planner now routes small queries to the
    # tiered backend while shard 1 stays on the host
    se.engines[0].lifecycle.freeze(blocking=True)
    r = se.execute(Query(terms=(vocab[40],), mode="conjunctive"))
    assert r.backend == "host+tiered", r.backend
    assert "sharded fan-out x2" in r.reason
    r2 = se.execute(Query(terms=(vocab[40],), mode="conjunctive",
                          backend="host"))
    assert r2.backend == "host"
    bounded(se.close)


# --------------------------------------------------------------------------
# FreezeCoordinator: the fleet encode budget
# --------------------------------------------------------------------------


class _FakeEngine:
    """Minimal engine for coordinator unit tests."""

    def __init__(self):
        self.index = DynamicIndex(B=64, growth="const")

    def collate_now(self):
        pass


def test_coordinator_fifo_and_budget_unit():
    coord = FreezeCoordinator(max_in_flight=1)
    a = FreezeManager(_FakeEngine(), FreezePolicy())
    b = FreezeManager(_FakeEngine(), FreezePolicy())
    coord.register(a)
    coord.register(b)
    assert a.coordinator is coord and b.coordinator is coord
    assert coord.try_acquire(a)
    assert not coord.try_acquire(b)
    assert coord.pending == 1
    assert not coord.try_acquire(b)
    assert coord.pending == 1
    coord.release(a)
    assert coord.try_acquire(b)
    assert coord.pending == 0
    assert not coord.try_acquire(a)
    coord.release(b)
    assert not coord.try_acquire(b)
    assert coord.try_acquire(a)
    coord.release(a)
    assert coord.peak_in_flight == 1
    assert coord.deferrals >= 3
    with pytest.raises(ValueError):
        FreezeCoordinator(max_in_flight=0)


@pytest.mark.parametrize("max_in_flight", [1, 2])
def test_coordinator_caps_concurrent_encodes(stream_docs, max_in_flight,
                                             monkeypatch):
    """With four shards and an aggressive policy, concurrent background
    encodes never exceed ``max_in_flight`` (measured inside
    ``StaticIndex.freeze``) while every document stays queryable."""
    vocab, docs = stream_docs
    lock = threading.Lock()
    active = [0]
    peak = [0]
    real_freeze = static_index_mod.StaticIndex.freeze
    gate = threading.Event()

    def slow_freeze(index, codec="bp128"):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        try:
            gate.wait(timeout=30)
            return real_freeze(index, codec)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(static_index_mod.StaticIndex, "freeze", slow_freeze)
    se = fleet(4, growth="const",
               tier_policy=FreezePolicy(every_docs=12, background=True),
               max_in_flight=max_in_flight)
    oracle = Engine(B=64, growth="const", device="cpu")
    rng = np.random.default_rng(31)
    saw_in_flight = False
    for i, d in enumerate(docs[:240]):
        se.add_document(d)
        oracle.add_document(d)
        saw_in_flight |= any(e.lifecycle.in_flight for e in se.engines)
        if not gate.is_set() and (
                peak[0] >= max_in_flight
                if max_in_flight > 1 else se.coordinator.deferrals > 0):
            gate.set()
        if i % 6 == 2:
            terms = tuple(vocab[j] for j in
                          rng.choice(40, size=2, replace=False))
            _assert_byte_identical(se, oracle, terms, "bm25")
            _assert_byte_identical(se, oracle, terms, "conjunctive")
    gate.set()
    bounded(se.drain_freezes)
    assert saw_in_flight, "no background freeze ever overlapped the stream"
    assert peak[0] <= max_in_flight
    assert se.coordinator.peak_in_flight <= max_in_flight
    assert all(e.lifecycle.freezes >= 1 for e in se.engines)
    if max_in_flight == 1:
        assert se.coordinator.deferrals > 0
    bounded(se.close)


def test_deferred_freeze_pumped_by_any_shard_ingest(stream_docs,
                                                    monkeypatch):
    """A shard whose slot request was refused retries on ANY fleet
    ingest, so a queue-head shard that receives no document cannot wedge
    the FIFO."""
    vocab, docs = stream_docs
    se = fleet(2, growth="const",
               tier_policy=FreezePolicy(every_docs=10 ** 9, background=True),
               max_in_flight=1)
    for d in docs[:41]:
        se.add_document(d)
    real_freeze = static_index_mod.StaticIndex.freeze
    hold = threading.Event()

    def slow_freeze(index, codec="bp128"):
        hold.wait(timeout=30)
        return real_freeze(index, codec)

    monkeypatch.setattr(static_index_mod.StaticIndex, "freeze", slow_freeze)
    assert se.engines[1].lifecycle.freeze(blocking=False)
    mgr0 = se.engines[0].lifecycle
    monkeypatch.setattr(mgr0, "policy", FreezePolicy(every_docs=1,
                                                     background=True))
    assert not mgr0.maybe_freeze()
    assert se.coordinator.pending == 1
    hold.set()
    bounded(se.engines[1].lifecycle.wait)
    assert se.num_docs % 2 == 1
    se.add_document(docs[41])               # lands on shard 1
    assert mgr0.in_flight or mgr0.epoch == 1, \
        "queued freeze was not pumped by another shard's ingest"
    bounded(se.drain_freezes)
    assert mgr0.epoch >= 1
    bounded(se.close)


def test_failed_snapshot_releases_encode_slot(stream_docs, monkeypatch):
    vocab, docs = stream_docs
    se = fleet(2, growth="const", tier_policy=FreezePolicy(),
               max_in_flight=1)
    for d in docs[:30]:
        se.add_document(d)
    eng = se.engines[0]

    def boom():
        raise MemoryError("collation failed")

    monkeypatch.setattr(eng, "collate_now", boom)
    with pytest.raises(MemoryError):
        eng.lifecycle.freeze(blocking=False)
    monkeypatch.undo()
    assert se.coordinator.in_flight == 0, "encode slot leaked"
    assert bounded(se.engines[1].lifecycle.freeze, True)
    assert bounded(se.engines[0].lifecycle.freeze, True)
    bounded(se.close)


def test_close_releases_pool(stream_docs):
    vocab, docs = stream_docs
    se = fleet(3, growth="const")
    for d in docs[:30]:
        se.add_document(d)
    assert se._pool is not None
    bounded(se.close)
    assert se._pool is None
    bounded(se.close)                        # idempotent
    r = se.execute(Query(terms=(vocab[0],), mode="conjunctive"))
    assert len(r.docids) > 0
    with fleet(2, growth="const") as ctx:
        ctx.add_document(docs[0])
        assert ctx._pool is not None
    assert ctx._pool is None


def test_blocking_freeze_waits_for_budget(stream_docs):
    vocab, docs = stream_docs
    se = fleet(2, growth="const", tier_policy=FreezePolicy(),
               max_in_flight=1)
    for d in docs[:60]:
        se.add_document(d)
    assert se.engines[0].lifecycle.freeze(blocking=False)
    bounded(se.engines[1].lifecycle.freeze, True)       # must wait
    bounded(se.drain_freezes)
    assert se.coordinator.peak_in_flight == 1
    assert se.engines[0].lifecycle.epoch == 1
    assert se.engines[1].lifecycle.epoch == 1
    bounded(se.close)


# --------------------------------------------------------------------------
# serving-cache integration
# --------------------------------------------------------------------------


def test_sharded_results_are_cached_and_invalidated(stream_docs):
    vocab, docs = stream_docs
    se = fleet(3, growth="const", tier_policy=FreezePolicy())
    svc = QueryService(se, max_batch=4, cache_size=32)
    for d in docs[:60]:
        svc.ingest(d)
    q = Query(terms=(vocab[0], vocab[3]), mode="bm25", k=10)
    r1 = svc.query(q)
    assert svc.cache_misses == 1 and svc.cache_hits == 0
    r2 = svc.query(q)
    assert svc.cache_hits == 1
    assert _bits(r2) == _bits(r1)
    svc.ingest(docs[60])
    svc.query(q)
    assert svc.cache_misses == 2
    svc.query(q)
    assert svc.cache_hits == 2
    bounded(se.engines[1].lifecycle.freeze, True)
    r3 = svc.query(q)
    assert svc.cache_misses == 3, \
        "a shard tier swap must invalidate the sharded result cache"
    oracle = JaxEngine(B=64, growth="const")
    for d in docs[:61]:
        oracle.add_document(d)
    e = oracle.execute(JaxQuery(terms=q.terms, mode="bm25", k=10,
                                backend="host"))
    assert _bits(r3) == _bits(e)
    bounded(se.close)


# --------------------------------------------------------------------------
# composite observability and the fleet's f_t arrays
# --------------------------------------------------------------------------


def test_incremental_gft_cache_matches_naive_walk(stream_docs):
    """The per-shard aligned global-f_t arrays (value-updated at ingest and
    delete, suffix-extended at read) equal the naive dict walk over each
    shard's vocabulary, with device refreshes interleaved."""
    vocab, docs = stream_docs
    se = fleet(3, growth="const")
    for i, d in enumerate(docs[:150]):
        se.add_document(d)
        if i % 25 == 7:
            se.execute_many([Query(terms=(vocab[0], vocab[1]), mode="bm25",
                                   k=5)] * 4)
        if i % 30 == 11:
            se.delete_document(i - 3)
        if i % 10 == 3:
            for e in se.engines:
                got = e.global_fts()
                naive = np.asarray([se._ft.get(tb, 0) for tb in e.vocab],
                                   dtype=np.int64)
                assert np.array_equal(got, naive)
    bounded(se.close)


def test_composite_stats(stream_docs):
    vocab, docs = stream_docs
    se = fleet(3, growth="const",
               tier_policy=FreezePolicy(every_docs=30, background=False))
    for d in docs[:100]:
        se.add_document(d)
    se.execute(Query(terms=(vocab[0],), mode="conjunctive"))
    s = se.stats()
    assert s.num_docs == 100 == se.num_docs
    assert s.num_shards == 3
    assert s.num_postings == sum(e.index.num_postings for e in se.engines)
    assert s.num_postings == se.num_postings
    assert s.freezes == sum(e.lifecycle.freezes for e in se.engines) > 0
    assert s.tier_epoch == se.coordinator.epoch > 0
    assert s.queries == 3
    assert sum(s.by_backend.values()) == 3
    assert s.vocab_size == len({t for d in docs[:100] for t in d})
    assert Engine(device="cpu").stats().num_shards == 0
    bounded(se.close)


# --------------------------------------------------------------------------
# the kernel loader under concurrent first use (the fan-out pool)
# --------------------------------------------------------------------------


def test_kernel_load_builds_once_across_threads(monkeypatch):
    """Eight threads load one kernel for the first time together: one
    build, one open, one declaration, and every thread gets that
    library."""
    calls = {"build": 0, "open": 0, "declare": 0}
    go = threading.Barrier(8)

    def fake_build(names):
        calls["build"] += 1
        threading.Event().wait(0.05)        # widen the race window
        return {n: f"/nonexistent/lib{n}.so" for n in names}

    class FakeLib:
        def __init__(self, path):
            calls["open"] += 1

    def declare(lib):
        calls["declare"] += 1

    monkeypatch.setattr(build, "build_all", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(build, "_LOADED", {})
    got = []

    def first_use():
        go.wait(timeout=WAIT_S)
        got.append(build.load("fused_query", declare))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(WAIT_S)
        assert not th.is_alive()
    assert calls == {"build": 1, "open": 1, "declare": 1}
    assert len(got) == 8 and all(lib is got[0] for lib in got)
