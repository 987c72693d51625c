"""The port's static-tier lifecycle, tiered backend, planner rules and
epoch-keyed result cache against the JAX package's.

One seeded stream — ingest, deletes, a freeze, a post-freeze suffix with
more deletes — goes through the reference ``Engine`` and the port's
``Engine(device="cpu")`` for every cell of {const, triangle} × {bp128,
interp} × {doc, word}: the published tiers' ``to_arrays()`` are equal byte
for byte, and every mode the index serves (the three term modes, plus
phrase, proximity and bm25_prox at word level) answers on ``host`` and
``tiered`` with the reference's docids and bit-identical scores.  Under
deletes the port's device path is held to the reference's host answers,
never to its device path (the reference's fault C1).
"""

import threading

import numpy as np
import pytest

from repro.core.lifecycle import FreezePolicy as JaxPolicy
from repro.engine import Engine as JaxEngine
from repro.engine import Query as JaxQuery
from repro_torch.core.lifecycle import FreezeManager, FreezePolicy, StaticTier
from repro_torch.engine import Engine, Query, UnsupportedQueryError
from repro_torch.engine import device_backend
from repro_torch.serve import QueryService

from test_torch_static import CELL_IDS, CELLS, assert_same_arrays

TERM_MODES = ("conjunctive", "ranked_tfidf", "bm25")


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(77)
    vocab = [f"t{i}" for i in range(150)]
    probs = 1.0 / np.arange(1, 151) ** 1.05
    probs /= probs.sum()
    docs = [[vocab[i] for i in rng.choice(150, size=int(rng.integers(5, 40)),
                                          p=probs)] for _ in range(260)]
    return vocab, docs


def _probes(vocab, word, seed=3, n=5):
    """(mode, terms, window) probes: every mode the index serves."""
    rng = np.random.default_rng(seed)
    modes = TERM_MODES + (("phrase", "proximity", "bm25_prox")
                          if word else ())
    out = []
    for mode in modes:
        for _ in range(n):
            terms = tuple(vocab[i] for i in rng.choice(
                40, size=int(rng.integers(1, 4)), replace=False))
            out.append((mode, terms,
                        int(rng.integers(1, 9)) if mode == "proximity"
                        else None))
    return out


def _ask(eng, query_cls, probe, backend):
    mode, terms, window = probe
    return eng.execute(query_cls(terms=terms, mode=mode, k=10,
                                 window=window, backend=backend))


def assert_same_result(got, want, probe):
    assert got.docids.tolist() == want.docids.tolist(), probe
    if want.scores is None:
        assert got.scores is None, probe
    else:
        assert got.scores.tobytes() == want.scores.tobytes(), probe


def _replay(eng, docs):
    """Ingest, deletes, a freeze, a suffix with deletes on both sides of
    the horizon."""
    eng.add_documents(docs[:150])
    for d in (4, 33, 90):
        eng.delete_document(d)
    eng.lifecycle.freeze(blocking=True)
    for d in docs[150:220]:
        eng.add_document(d)
    for d in (12, 160, 201):
        eng.delete_document(d)
    return eng


@pytest.mark.parametrize("growth,codec,word", CELLS, ids=CELL_IDS)
def test_tiers_and_answers_equal_reference(stream, growth, codec, word):
    vocab, docs = stream
    ref = _replay(JaxEngine(B=64, growth=growth, word_level=word,
                            tier_policy=JaxPolicy(codec=codec,
                                                  background=False)), docs)
    port = _replay(Engine(B=64, growth=growth, word_level=word,
                          device="cpu",
                          tier_policy=FreezePolicy(codec=codec,
                                                   background=False)), docs)
    rt, pt = ref.static_tier(), port.static_tier()
    assert_same_arrays(rt.index.to_arrays(), pt.index.to_arrays())
    assert (pt.num_docs, pt.num_postings, pt.epoch, pt.compacted) == \
        (rt.num_docs, rt.num_postings, rt.epoch, rt.compacted) == \
        (150, rt.num_postings, 1, 3)
    ps, rs = port.stats(), ref.stats()
    assert (ps.freezes, ps.tier_epoch, ps.tombstones_compacted) == \
        (rs.freezes, rs.tier_epoch, rs.tombstones_compacted)
    for probe in _probes(vocab, word):
        host = _ask(port, Query, probe, "host")
        for backend in ("host", "tiered"):
            got = _ask(port, Query, probe, backend)
            assert got.backend == backend
            assert_same_result(got, _ask(ref, JaxQuery, probe, backend),
                               probe)
            assert_same_result(got, host, probe)


@pytest.mark.parametrize("growth", ["const", "triangle"])
@pytest.mark.parametrize("codec", ["bp128", "interp"])
def test_tiered_equals_reference_during_background_freeze(stream, growth,
                                                          codec):
    """Ingest and queries go on while the encode runs on its thread: every
    tiered answer equals the reference host's on the same prefix."""
    vocab, docs = stream
    port = Engine(B=64, growth=growth, device="cpu",
                  tier_policy=FreezePolicy(codec=codec, background=True))
    ref = JaxEngine(B=64, growth=growth)
    for eng in (port, ref):
        eng.add_documents(docs[:120])
    probes = _probes(vocab, False, seed=5, n=2)

    def check():
        for probe in probes:
            assert_same_result(_ask(port, Query, probe, "tiered"),
                               _ask(ref, JaxQuery, probe, "host"), probe)

    check()
    assert port.lifecycle.freeze(blocking=False)
    for d in docs[120:160]:
        port.add_document(d)
        ref.add_document(d)
        check()
    port.lifecycle.wait()
    tier = port.static_tier()
    assert (tier.epoch, tier.num_docs) == (1, 120)
    check()
    port.lifecycle.freeze(blocking=True)
    assert port.static_tier().num_docs == port.index.num_docs == 160
    check()
    assert (port.stats().freezes, port.stats().tier_epoch) == (2, 2)


def test_device_path_across_freezes_equals_reference_host(stream):
    """Each freeze collates and uploads a new frozen image; the fused path
    over it, a post-freeze delta and deletes (a deleted term re-added after
    the freeze included) answers as the reference host does."""
    vocab, docs = stream
    port = Engine(B=64, growth="const", device="cpu",
                  tier_policy=FreezePolicy(background=False))
    ref = JaxEngine(B=64, growth="const")
    probes = _probes(vocab, False, seed=8, n=4)

    def check():
        for probe in probes:
            got = _ask(port, Query, probe, "device")
            want = _ask(ref, JaxQuery, probe, "host")
            assert got.docids.tolist() == want.docids.tolist(), probe
            if want.scores is not None:
                np.testing.assert_allclose(got.scores, want.scores,
                                           rtol=1e-5)

    for eng in (port, ref):
        eng.add_documents(docs[:100])
        for d in (3, 8, 40):
            eng.delete_document(d)
    port.lifecycle.freeze(blocking=True)
    assert port.resident.epoch == 1 and port.resident.delta_blocks == 0
    check()
    for eng in (port, ref):
        eng.add_documents(docs[100:180] + [[vocab[0], vocab[1]]] * 3)
        for d in (101, 150):
            eng.delete_document(d)
    check()
    port.lifecycle.freeze(blocking=True)
    assert port.resident.epoch == 2 and port.stats().tier_epoch == 2
    assert port.stats().tombstones_compacted == 5
    check()


@pytest.mark.parametrize("collated", [True, False])
def test_frozen_image_and_baseline_equal_reference(stream, collated):
    """The image a freeze uploads and the delta baseline it captures hold
    the reference's fields, a term the index lacks included."""
    from repro.core.collate import collate as jax_collate
    from repro.core.device_index import build_device_image as jax_image
    from repro.core.device_index import capture_delta_baseline as jax_base
    from repro.core.index import DynamicIndex as JaxIndex
    from repro_torch.core.collate import collate
    from repro_torch.core.device_index import (build_device_image,
                                               capture_delta_baseline)
    from repro_torch.core.index import DynamicIndex
    vocab, docs = stream
    ref, port = JaxIndex(B=64), DynamicIndex(B=64)
    for d in docs[:200]:
        ref.add_document(d)
        port.add_document(d)
    if collated:
        ref, port = jax_collate(ref), collate(port)
    terms = [t.encode() for t in vocab] + [b"absent"]
    want_base, got_base = jax_base(ref, terms), capture_delta_baseline(
        port, terms)
    for f in ("tail_slot", "nx", "lastd", "dnum", "ft"):
        assert getattr(got_base, f).tolist() == \
            getattr(want_base, f).tolist(), f
    assert (got_base.num_docs, got_base.nblocks) == \
        (want_base.num_docs, want_base.nblocks)
    if not collated:
        return
    want, got = jax_image(ref, terms), build_device_image(port, terms,
                                                          device="cpu")
    for f in ("blocks", "term_slot", "term_nblk", "term_skip", "term_nx",
              "term_ft"):
        assert np.asarray(getattr(want, f)).tolist() == \
            getattr(got, f).tolist(), f


def test_freeze_touches_the_device_images_on_the_writer_thread(
        stream, monkeypatch):
    """``collate_now`` (the frozen image's upload) runs on the thread that
    asked for the freeze; the encode thread touches no device image."""
    vocab, docs = stream
    seen = []
    real = device_backend.build_device_image

    def spy(*a, **kw):
        seen.append(threading.current_thread())
        return real(*a, **kw)

    monkeypatch.setattr(device_backend, "build_device_image", spy)
    port = Engine(B=64, growth="const", device="cpu",
                  tier_policy=FreezePolicy(every_docs=40, background=True))
    for d in docs[:200]:
        port.add_document(d)
        port.execute(Query(terms=(vocab[0],), mode="bm25", k=5,
                           backend="device"))
    port.lifecycle.wait()
    assert port.stats().freezes >= 1
    assert seen and all(t is threading.main_thread() for t in seen)


def test_policy_triggers_freeze_as_reference(stream):
    vocab, docs = stream
    port = Engine(B=64, growth="const", device="cpu",
                  tier_policy=FreezePolicy(every_docs=50, background=False))
    ref = JaxEngine(B=64, growth="const",
                    tier_policy=JaxPolicy(every_docs=50, background=False))
    for d in docs[:170]:
        port.add_document(d)
        ref.add_document(d)
    assert port.lifecycle.freezes == ref.lifecycle.freezes == 3
    assert port.static_tier().num_docs == ref.static_tier().num_docs == 150
    # batched ingest checks the policy once per batch, as the reference
    port.add_documents(docs[170:260])
    ref.add_documents(docs[170:260])
    assert port.static_tier().num_docs == ref.static_tier().num_docs == 260


def test_freeze_empty_engine():
    eng = Engine(B=64, growth="const", device="cpu",
                 tier_policy=FreezePolicy())
    eng.lifecycle.freeze(blocking=True)
    tier = eng.static_tier()
    assert tier is not None and tier.num_docs == 0 and tier.epoch == 1
    eng.add_document(["a", "b"])
    r = eng.execute(Query(terms=("a",), mode="conjunctive",
                          backend="tiered"))
    assert r.docids.tolist() == [1]


def test_freeze_manager_standalone_interp(stream):
    vocab, docs = stream
    eng = Engine(B=64, growth="const", device="cpu")
    mgr = FreezeManager(eng, FreezePolicy(codec="interp"))
    eng.lifecycle = mgr
    eng.add_documents(docs[:90])
    mgr.freeze(blocking=True)
    assert mgr.tier.index.codec == "interp"
    assert mgr.tier.num_postings == eng.index.num_postings
    assert mgr.tier.index.bytes_per_posting() < eng.index.bytes_per_posting()


# --------------------------------------------------------------------------
# planner rules 2 and 5
# --------------------------------------------------------------------------


def test_planner_prefers_tiered_once_published(stream):
    vocab, docs = stream
    eng = Engine(B=64, growth="const", device="cpu",
                 tier_policy=FreezePolicy())
    eng.add_documents(docs[:80])
    q = Query(terms=(vocab[120],), mode="conjunctive")
    assert eng.execute(q).backend == "host"          # no tier yet
    eng.lifecycle.freeze(blocking=True)
    assert eng.execute(q).backend == "tiered"
    # batches still go to the device images
    batch = [Query(terms=(vocab[i], vocab[i + 1]), mode="ranked_tfidf")
             for i in range(6)]
    assert {r.backend for r in eng.execute_many(batch)} == {"device"}
    # a Triangle index sends a large volume to the kernel backend first
    tri = Engine(B=64, growth="triangle", device="cpu",
                 planner=None, tier_policy=FreezePolicy())
    tri.add_documents(docs[:80])
    tri.lifecycle.freeze(blocking=True)
    tri.planner.config = type(tri.planner.config)(kernel_min_postings=10)
    assert tri.execute(Query(terms=(vocab[0],),
                             mode="bm25")).backend == "kernel"
    assert tri.execute(Query(terms=(vocab[140],),
                             mode="bm25")).backend == "tiered"


def test_positional_modes_route_to_the_tier(stream):
    vocab, docs = stream
    eng = Engine(B=64, growth="const", word_level=True, device="cpu",
                 tier_policy=FreezePolicy(every_docs=60, background=False))
    phrase = Query(terms=(vocab[0], vocab[1]), mode="phrase")
    assert eng.execute(phrase).backend == "host"     # no tier yet
    eng.add_documents(docs[:70])
    assert eng.lifecycle.freezes == 1
    for q in (phrase, Query(terms=(vocab[0], vocab[1]), mode="proximity",
                            window=4),
              Query(terms=(vocab[0], vocab[1]), mode="bm25_prox")):
        got = eng.execute(q)
        assert got.backend == "tiered"
        want = eng.execute(Query(terms=q.terms, mode=q.mode, k=q.k,
                                 window=q.window, backend="host"))
        assert_same_result(got, want, q)


def test_forced_backends_refuse_what_they_cannot_serve():
    doc = Engine(B=64, growth="const", device="cpu")
    doc.add_document(["x", "y"])
    for mode, kw in (("phrase", {}), ("proximity", {"window": 3}),
                     ("bm25_prox", {})):
        with pytest.raises((ValueError, UnsupportedQueryError)):
            doc.execute(Query(terms=("x", "y"), mode=mode,
                              backend="tiered", **kw))
    word = Engine(B=64, growth="const", word_level=True, device="cpu")
    word.add_document(["x", "y", "x"])
    for mode, kw in (("proximity", {"window": 2}), ("bm25_prox", {})):
        for backend in ("device", "kernel"):
            with pytest.raises((ValueError, UnsupportedQueryError)):
                word.execute(Query(terms=("x", "y"), mode=mode,
                                   backend=backend, **kw))


def test_suffix_cursor_skips_frozen_prefix(stream):
    vocab, docs = stream
    eng = Engine(B=64, growth="const", device="cpu",
                 tier_policy=FreezePolicy())
    eng.add_documents(docs[:100])
    eng.lifecycle.freeze(blocking=True)
    eng.add_documents(docs[100:140])
    view = eng.backends["tiered"].view()
    assert view.horizon == 100
    for t in vocab[:30]:
        ds, fs = view.suffix_postings(t)
        full_d, full_f = eng.index.postings(t)
        cut = np.searchsorted(full_d, 101, side="left")
        assert ds.tolist() == full_d[cut:].tolist()
        assert fs.tolist() == full_f[cut:].tolist()


# --------------------------------------------------------------------------
# the result cache keyed on (version, tier epoch, query)
# --------------------------------------------------------------------------


def test_cache_key_holds_the_tier_epoch(stream):
    """A tier swap without an ingest makes the old entries unreachable."""
    vocab, docs = stream
    eng = Engine(B=64, growth="const", device="cpu",
                 tier_policy=FreezePolicy())
    svc = QueryService(eng, max_batch=4, cache_size=32)
    svc.ingest_batch(docs[:60])
    q = Query(terms=(vocab[0], vocab[3]), mode="conjunctive")
    assert svc._cache_key(q) == (eng.version, 0, q)
    r1 = svc.query(q)
    svc.query(q)
    assert (svc.cache_hits, svc.cache_misses) == (1, 1)
    old = svc._cache_key(q)
    eng.lifecycle.freeze(blocking=True)
    assert svc._cache_key(q) == (eng.version, 1, q) != old
    assert old in svc._cache
    r3 = svc.query(q)
    assert (svc.cache_hits, svc.cache_misses) == (1, 2)
    assert r3.docids.tolist() == r1.docids.tolist()
    svc.ingest(docs[60])                 # a version bump misses too
    svc.query(q)
    assert svc.cache_misses == 3
    # no lifecycle: the epoch is 0
    plain = QueryService(Engine(B=64, device="cpu"))
    assert plain._cache_key(q)[1] == 0


def test_flush_cache_key_computed_once_per_ticket(stream):
    """An epoch bump while ``execute_many`` runs must not file the result
    under the new epoch: the next query at the new epoch misses."""
    vocab, docs = stream
    eng = Engine(B=64, growth="const", device="cpu",
                 tier_policy=FreezePolicy())
    svc = QueryService(eng, cache_size=16)
    svc.ingest_batch(docs[:60])
    real = eng.execute_many

    def racing(queries):
        res = real(queries)
        eng.lifecycle.freeze(blocking=True)
        return res

    eng.execute_many = racing
    q = Query(terms=(vocab[0], vocab[2]), mode="conjunctive")
    r1 = svc.query(q)
    eng.execute_many = real
    r2 = svc.query(q)
    assert svc.cache_misses == 2 and svc.cache_hits == 0
    assert r2.docids.tolist() == r1.docids.tolist()
    assert svc.query(q).docids.tolist() == r1.docids.tolist()
    assert svc.cache_hits == 1


# --------------------------------------------------------------------------
# the lifecycle's publication invariants
# --------------------------------------------------------------------------


def test_freeze_metadata_published_atomically(stream):
    vocab, docs = stream
    eng = Engine(B=64, growth="const", device="cpu",
                 tier_policy=FreezePolicy(every_docs=12, background=True))
    mgr = eng.lifecycle
    stop = threading.Event()
    bad = []

    def reader():
        while not stop.is_set():
            tier = mgr.tier
            epoch = mgr.epoch
            freezes = mgr.freezes
            t_ep = tier.epoch if tier is not None else 0
            if not freezes >= epoch >= t_ep:
                bad.append((t_ep, epoch, freezes))

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for d in docs[:150]:
            eng.add_document(d)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    mgr.wait()
    assert not bad
    assert mgr.freezes == mgr.epoch == mgr.tier.epoch > 0
    assert mgr.last_freeze_s == mgr.tier.encode_s is not None


def test_suffix_size_snapshots_tier_once():
    class SwappingIndex:
        mgr = None

        @property
        def num_docs(self):
            return 100

        @property
        def num_postings(self):
            self.mgr.tier = StaticTier(index=None, num_docs=100,
                                       num_postings=1000, epoch=2)
            return 1000

    class FakeEngine:
        def __init__(self, idx):
            self.index = idx

    idx = SwappingIndex()
    mgr = FreezeManager(FakeEngine(idx), FreezePolicy())
    idx.mgr = mgr
    mgr.tier = StaticTier(index=None, num_docs=50, num_postings=500, epoch=1)
    assert mgr.suffix_size() == (50, 500)
    assert mgr.suffix_size() == (0, 0)
