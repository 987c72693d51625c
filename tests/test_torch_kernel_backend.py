"""The port's kernel backend, planner routing and split device path against
the JAX package's.

* Triangle and Expon growth (no device image): the same stream goes through
  the JAX ``Engine`` and the port's ``Engine(device="cpu")``; the port's
  ``"kernel"`` backend (host decode, then the ``intersect`` and
  ``topk_score`` ops' plain versions) is held against the JAX ``"pallas"``
  backend (the Pallas kernels in interpret mode) and the JAX host backend,
  in all three doc-level modes, with and without deletes.  Conjunctive
  answers exact; ranked docids equal up to swaps among near-equal scores,
  scores within rtol 1e-6 of the JAX kernels (the same float32 weights,
  summed in another order) and rtol 1e-5 of the host (float64).
* The planner sends the same queries where the JAX planner does, with
  ``"pallas"`` read as ``"kernel"``; forcing ``"device"`` on a Triangle
  engine raises, as it does in the reference.
* Ties come back in canonical order (score descending, docid ascending).
* ``DeviceBackend(use_fused=False)`` — one ``query_step`` per image — on a
  Const engine with a freeze and a delta, against the JAX split path and
  the JAX host backend; under deletes it delegates to the fused path.
"""

import numpy as np
import pytest

from repro.engine import Engine as JaxEngine
from repro.engine import Query as JaxQuery
from repro.engine.device_backend import DeviceBackend as JaxDeviceBackend
from repro.engine.planner import Planner as JaxPlanner
from repro.engine.planner import PlannerConfig as JaxPlannerConfig
from repro.engine.types import TermStats as JaxTermStats
from repro.kernels.fused_query.ref import decode_blocks_parallel
from repro_torch.core.device_index import decode_blocks
from repro_torch.engine import Engine, PlannerConfig, Query
from repro_torch.engine.device_backend import DeviceBackend
from repro_torch.engine.planner import Planner
from repro_torch.engine.types import TermStats

from test_torch_engine import _docs, _replay
from test_torch_fused_query import assert_ranking

MODES = ("conjunctive", "ranked_tfidf", "bm25")


def _ops(docs, deletes: bool):
    ops = [("adds", docs[i:i + 50]) for i in range(0, 200, 50)]
    ops += [("add", d) for d in docs[200:]]
    if deletes:
        ops += [("delete", 3), ("delete", 170), ("update", 12, docs[5]),
                ("delete", 120), ("add", docs[7]), ("delete", 201)]
    return ops


def _queries(vocab, seed, n=6):
    rng = np.random.default_rng(seed)
    return [tuple(vocab[i] for i in rng.choice(30, size=int(rng.integers(1, 4)),
                                               replace=False))
            for _ in range(n)]


def _agree(got, want, mode, rtol):
    if mode == "conjunctive":
        assert got.docids.tolist() == want.docids.tolist()
    else:
        assert_ranking(got.docids, got.scores, want.docids, want.scores,
                       rtol)


@pytest.fixture(scope="module", params=[("triangle", False),
                                        ("triangle", True),
                                        ("expon", False), ("expon", True)],
                ids=["triangle", "triangle-deletes", "expon",
                     "expon-deletes"])
def engines(request):
    growth, deletes = request.param
    vocab, docs = _docs(seed=83, n=260)
    ops = _ops(docs, deletes)
    jax_eng = _replay(JaxEngine(B=64, growth=growth), ops)
    port = _replay(Engine(B=64, growth=growth, device="cpu"), ops)
    assert not port.device_capable and port.kernel_capable
    return vocab, jax_eng, port


@pytest.mark.parametrize("mode", MODES)
def test_kernel_backend_matches_jax_pallas_and_host(engines, mode):
    vocab, jax_eng, port = engines
    for terms in _queries(vocab, seed=MODES.index(mode)):
        got = port.execute(Query(terms=terms, mode=mode, k=10,
                                 backend="kernel"))
        assert got.backend == "kernel"
        pallas = jax_eng.execute(JaxQuery(terms=terms, mode=mode, k=10,
                                          backend="pallas"))
        host = jax_eng.execute(JaxQuery(terms=terms, mode=mode, k=10,
                                        backend="host"))
        _agree(got, pallas, mode, 1e-6)
        _agree(got, host, mode, 1e-5)
        # the port's own host backend answers alike
        _agree(port.execute(Query(terms=terms, mode=mode, k=10,
                                  backend="host")), host, mode, 1e-12)


def test_planner_routes_like_the_jax_planner(engines):
    """Unforced batches on a variable-growth engine: the same split between
    the kernels and the host, query by query."""
    vocab, _jax, port = engines
    cfg = dict(device_min_batch=4)
    jp = JaxPlanner(JaxPlannerConfig(pallas_min_postings=60, **cfg))
    pp = Planner(PlannerConfig(kernel_min_postings=60, **cfg))
    seen = set()
    for mode in MODES + ("phrase",):
        for terms in _queries(vocab, seed=40, n=12):
            for batch in (1, 8):
                fts = [port._fts[t] if (t := port.term_id(x)) is not None
                       else 0 for x in terms]
                want = jp.plan(JaxQuery(terms=terms, mode=mode), batch,
                               [JaxTermStats(f, 0) for f in fts],
                               device_capable=False, pallas_capable=True)
                got = pp.plan(Query(terms=terms, mode=mode), batch,
                              [TermStats(f, 0) for f in fts],
                              device_capable=False, kernel_capable=True)
                expect = "kernel" if want.backend == "pallas" \
                    else want.backend
                assert got.backend == expect, (terms, mode, batch)
                seen.add(got.backend)
    assert seen == {"kernel", "host"}


def test_engine_routes_large_queries_to_the_kernel_backend():
    vocab, docs = _docs(seed=83, n=260)
    ops = _ops(docs, deletes=False)
    port = _replay(Engine(B=64, growth="triangle", device="cpu",
                          planner=PlannerConfig(kernel_min_postings=60)), ops)
    jax_small = _replay(JaxEngine(
        B=64, growth="triangle",
        planner=JaxPlannerConfig(pallas_min_postings=60)), ops)
    for mode in MODES:
        qs = _queries(vocab, seed=50 + MODES.index(mode), n=8)
        got = port.execute_many([Query(terms=t, mode=mode, k=10)
                                 for t in qs])
        want = jax_small.execute_many([JaxQuery(terms=t, mode=mode, k=10)
                                       for t in qs])
        assert [g.backend for g in got] == [
            "kernel" if w.backend == "pallas" else w.backend for w in want]
        for g, w in zip(got, want):
            _agree(g, w, mode, 1e-5)
    assert port.stats().by_backend.get("kernel", 0) > 0


def test_forcing_the_device_backend_on_triangle_raises(engines):
    _vocab, _jax, port = engines
    with pytest.raises(ValueError, match="device"):
        port.execute(Query(terms=("w1",), mode="bm25", backend="device"))
    with pytest.raises(ValueError, match="kernel"):
        port.execute(Query(terms=("w1", "w2"), mode="phrase",
                           backend="kernel"))
    word = Engine(B=64, growth="triangle", word_level=True, device="cpu")
    word.add_document(["w1", "w2"])
    with pytest.raises(ValueError, match="kernel"):
        word.execute(Query(terms=("w1",), mode="bm25", backend="kernel"))


@pytest.mark.parametrize("mode", ["ranked_tfidf", "bm25"])
def test_ties_come_back_in_canonical_order(mode):
    """Twelve identical documents tie; k = 5 keeps the five lowest docids,
    as the reference's top-k does."""
    port = Engine(B=64, growth="triangle", device="cpu")
    jax_eng = JaxEngine(B=64, growth="triangle")
    docs = [["a", "b", "c"]] * 3 + [["a", "b"]] * 12 + [["c", "d"]] * 4
    for e in (port, jax_eng):
        e.add_documents(docs)
    got = port.execute(Query(terms=("b",), mode=mode, k=5, backend="kernel"))
    want = jax_eng.execute(JaxQuery(terms=("b",), mode=mode, k=5,
                                    backend="pallas"))
    assert got.docids.tolist() == want.docids.tolist()
    assert len(set(got.scores.tolist())) == 1 or mode == "bm25"
    host = port.execute(Query(terms=("b",), mode=mode, k=5, backend="host"))
    assert got.docids.tolist() == host.docids.tolist()
    tied = got.docids[got.scores == got.scores[-1]]
    assert tied.tolist() == sorted(tied.tolist())


def _const_ops(docs, deletes: bool):
    ops = [("adds", docs[i:i + 40]) for i in range(0, 160, 40)]
    ops += [("freeze",)] + [("add", d) for d in docs[160:]]
    if deletes:
        ops += [("delete", 4), ("delete", 190), ("update", 30, docs[2])]
    return ops


def _const_engines(deletes: bool):
    vocab, docs = _docs(seed=89, n=260)
    ops = _const_ops(docs, deletes)
    jax_eng = _replay(JaxEngine(B=64, growth="const",
                                decode_fn=decode_blocks_parallel), ops)
    port = _replay(Engine(B=64, growth="const", device="cpu"), ops)
    return vocab, jax_eng, port


@pytest.mark.parametrize("deletes", [False, True], ids=["delta", "deletes"])
@pytest.mark.parametrize("mode", MODES)
def test_split_device_path_matches_jax(mode, deletes):
    vocab, jax_eng, port = _const_engines(deletes)
    qs = [Query(terms=t, mode=mode, k=10) for t in _queries(vocab, seed=7)]
    split = DeviceBackend(port, port.resident, use_fused=False)
    got = split.execute_many(qs)
    assert all(r.backend == "device" for r in got)
    assert port.resident.delta_blocks > 0
    jq = [JaxQuery(terms=q.terms, mode=mode, k=10) for q in qs]
    host = [jax_eng.execute(JaxQuery(terms=q.terms, mode=mode, k=10,
                                     backend="host")) for q in qs]
    for g, h in zip(got, host):
        _agree(g, h, mode, 1e-5)
    if not deletes:
        # the reference's split path, decoding with its closed-form decode
        # (equal to its scan decode on every position query_step reads)
        jsplit = JaxDeviceBackend(jax_eng, resident=jax_eng.resident,
                                  use_fused=False).execute_many(jq)
        for g, w in zip(got, jsplit):
            _agree(g, w, mode, 1e-5)
    # the split path's launches: the fused batch count moves only when
    # deletes send it to the fused path
    before = port.resident.batches_served
    split.execute_many(qs)
    assert (port.resident.batches_served > before) == deletes


def test_engine_decode_fn_reaches_the_split_path():
    """``Engine(decode_fn=f)`` hands ``f`` to the split path's
    ``query_step``: one call per image per (mode, k) group, and the same
    answers as the default decode."""
    vocab, docs = _docs(seed=89, n=260)
    ops = _const_ops(docs, deletes=False)
    calls = []

    def counting(blocks, start, end, F):
        calls.append(blocks.shape[0])
        return decode_blocks(blocks, start, end, F)

    port = _replay(Engine(B=64, growth="const", device="cpu",
                          decode_fn=counting), ops)
    plain = _replay(Engine(B=64, growth="const", device="cpu"), ops)
    for mode in MODES:
        qs = [Query(terms=t, mode=mode, k=10)
              for t in _queries(vocab, seed=11)]
        before = len(calls)
        got = DeviceBackend(port, port.resident,
                            use_fused=False).execute_many(qs)
        assert len(calls) - before == 2
        want = DeviceBackend(plain, plain.resident,
                             use_fused=False).execute_many(qs)
        for g, w in zip(got, want):
            assert g.docids.tolist() == w.docids.tolist()
            if mode != "conjunctive":
                assert np.array_equal(g.scores, w.scores)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_backend_on_const_takes_the_fused_path(mode):
    """On a device-capable engine the kernel backend answers each (mode, k)
    group with one fused launch over the resident images, as the device
    backend does, under its own name."""
    vocab, jax_eng, port = _const_engines(deletes=True)
    terms = _queries(vocab, seed=21)
    before = port.resident.batches_served
    got = port.execute_many([Query(terms=t, mode=mode, k=10,
                                   backend="kernel") for t in terms])
    assert port.resident.batches_served == before + 1
    assert all(r.backend == "kernel" for r in got)
    dev = port.execute_many([Query(terms=t, mode=mode, k=10,
                                   backend="device") for t in terms])
    for g, d in zip(got, dev):
        assert g.docids.tolist() == d.docids.tolist()
        if mode != "conjunctive":
            assert np.array_equal(g.scores, d.scores)
    for t, g in zip(terms, got):
        _agree(g, jax_eng.execute(JaxQuery(terms=t, mode=mode, k=10,
                                           backend="host")), mode, 1e-5)
