"""The port's engine and serving loop against the JAX package's engine.

The same stream — a mid-stream ``collate_now`` and a post-freeze delta —
goes through the JAX ``Engine`` and the port's ``Engine(device="cpu")``.
Query batches served by the port's ``QueryService`` (routed to its fused
device backend) must agree with the JAX host backend (scores to rtol 1e-5:
the host scores in float64) and, without deletes, with the JAX device
backend (rtol 1e-6).  Under deletes the port is held against the JAX host
backend only: the JAX device path drops post-freeze postings of a term
whose deletes and adds cancel out (the reference's fault C1), which the
fixed regression stream below reproduces and the port must not.
"""

import numpy as np
import pytest
import torch

from repro.engine import Engine as JaxEngine
from repro.engine import Query as JaxQuery
from repro_torch.convert import dynamic_index_from_arrays
from repro_torch.engine import Engine, Query
from repro_torch.serve import QueryService

from test_torch_fused_query import assert_ranking

MODES = ("conjunctive", "ranked_tfidf", "bm25")


def _docs(seed=41, n=260, V=70):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(V)]
    probs = 1.0 / np.arange(1, V + 1) ** 1.07
    probs /= probs.sum()
    docs = [[vocab[i] for i in rng.choice(V, size=int(rng.integers(2, 30)),
                                          p=probs)] for _ in range(n)]
    return vocab, docs


def _queries(vocab, mode, seed, n=8):
    rng = np.random.default_rng(seed)
    return [tuple(vocab[i] for i in rng.choice(40, size=int(rng.integers(1, 4)),
                                               replace=False))
            for _ in range(n)]


def _serve(eng, terms_list, mode):
    svc = QueryService(eng, max_batch=64)
    tickets = [svc.submit(Query(terms=t, mode=mode, k=10))
               for t in terms_list]
    svc.flush()
    return [t.result for t in tickets]


def _jax(eng, terms, mode, backend):
    return eng.execute(JaxQuery(terms=terms, mode=mode, k=10,
                                backend=backend))


def _agree(got, want, mode, rtol):
    if mode == "conjunctive":
        assert got.docids.tolist() == want.docids.tolist()
    else:
        assert_ranking(got.docids, got.scores, want.docids, want.scores,
                       rtol)


def _replay(eng, ops):
    for op in ops:
        if op[0] == "add":
            eng.add_document(op[1])
        elif op[0] == "adds":
            eng.add_documents(op[1])
        elif op[0] == "delete":
            eng.delete_document(op[1])
        elif op[0] == "update":
            eng.update_document(op[1], op[2])
        else:
            eng.collate_now()
    return eng


def _stream_ops(docs, deletes: bool):
    ops = [("adds", docs[i:i + 40]) for i in range(0, 160, 40)]
    ops.append(("freeze",))
    ops += [("add", d) for d in docs[160:]]
    if deletes:
        ops += [("delete", 3), ("delete", 170), ("update", 12, docs[5]),
                ("delete", 120), ("add", docs[7]), ("delete", 200),
                ("update", 161, docs[9])]
    return ops


@pytest.mark.parametrize("mode", MODES)
def test_port_matches_jax_host_and_device(mode):
    vocab, docs = _docs()
    ops = _stream_ops(docs, deletes=False)
    jax_eng = _replay(JaxEngine(B=64, growth="const"), ops)
    port = _replay(Engine(B=64, growth="const", device="cpu"), ops)
    terms_list = _queries(vocab, mode, seed=2)
    got = _serve(port, terms_list, mode)
    assert all(r.backend == "device" for r in got)
    for terms, r in zip(terms_list, got):
        _agree(r, _jax(jax_eng, terms, mode, "host"), mode, 1e-5)
        _agree(r, _jax(jax_eng, terms, mode, "device"), mode, 1e-6)
    assert port.resident.frozen_uploads == 1


@pytest.mark.parametrize("mode", MODES)
def test_port_under_deletes_and_updates_matches_jax_host(mode):
    vocab, docs = _docs(seed=43)
    ops = _stream_ops(docs, deletes=True)
    jax_eng = _replay(JaxEngine(B=64, growth="const"), ops)
    port = _replay(Engine(B=64, growth="const", device="cpu"), ops)
    terms_list = _queries(vocab, mode, seed=4)
    got = _serve(port, terms_list, mode)
    assert all(r.backend == "device" for r in got)
    for terms, r in zip(terms_list, got):
        want = _jax(jax_eng, terms, mode, "host")
        _agree(r, want, mode, 1e-5)
        host = port.execute(Query(terms=terms, mode=mode, k=10,
                                  backend="host"))
        assert host.docids.tolist() == want.docids.tolist()
        if mode != "conjunctive":
            assert np.array_equal(host.scores, want.scores)


#: ROADMAP fault C1: a freeze at 8 docs, then deletes of t0-documents that
#: exactly cancel the t0-documents added after the freeze, so the live f_t
#: of t0 equals its f_t at the freeze although t0 gained postings.
C1_OPS = (
    [("add", ["t1", "t2"])]
    + [("add", ["t0", "t1"] if i % 2 else ["t0", "t2"]) for i in range(2, 9)]
    + [("freeze",), ("delete", 2), ("add", ["t0", "t2"]),
       ("add", ["t0", "t1", "t2"]), ("add", ["t0"]), ("delete", 3),
       ("add", ["t0", "t1"]), ("delete", 4), ("add", ["t0", "t2"]),
       ("delete", 12), ("delete", 5), ("add", ["t0", "t1"]),
       ("delete", 13)])


def test_c1_regression_device_path_keeps_post_freeze_postings():
    assert len(C1_OPS) == 21
    jax_eng = _replay(JaxEngine(B=64, growth="const"), C1_OPS)
    port = _replay(Engine(B=64, growth="const", device="cpu"), C1_OPS)
    q = ("t0",)
    want = _jax(jax_eng, q, "conjunctive", "host").docids.tolist()
    assert want == [6, 7, 8, 9, 10, 11, 14]
    # the stream does trip the reference's device path (fault C1) ...
    assert _jax(jax_eng, q, "conjunctive", "device").docids.tolist() != want
    # ... and the port's device path answers like the host
    got = port.execute(Query(terms=q, mode="conjunctive", backend="device"))
    assert got.docids.tolist() == want
    for mode in ("ranked_tfidf", "bm25"):
        for terms in (("t0",), ("t0", "t1"), ("t1", "t2")):
            _agree(port.execute(Query(terms=terms, mode=mode, k=10,
                                      backend="device")),
                   _jax(jax_eng, terms, mode, "host"), mode, 1e-5)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        assert Engine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine()
    assert Engine(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("builder", ["device_image", "delta_image",
                                     "from_arrays"])
def test_image_builders_default_to_the_card(builder):
    """Each image builder called without ``device`` puts its image on the
    card, or raises where there is none; ``device="cpu"`` is honoured."""
    from repro_torch.convert import image_from_arrays
    from repro_torch.core.device_index import (build_delta_image,
                                               build_device_image,
                                               capture_delta_baseline)
    vocab, docs = _docs(seed=67, n=40)
    eng = Engine(B=64, growth="const", device="cpu")
    eng.add_documents(docs[:30])
    eng.collate_now()
    base = capture_delta_baseline(eng.index, eng.vocab)
    cpu = build_device_image(eng.index, eng.vocab, device="cpu")
    if builder == "delta_image":
        eng.add_documents(docs[30:])
    build = {
        "device_image": lambda **kw: build_device_image(
            eng.index, eng.vocab, **kw),
        "delta_image": lambda **kw: build_delta_image(
            eng.index, eng.vocab, base, num_docs=64, **kw),
        "from_arrays": lambda **kw: image_from_arrays(
            {f: getattr(cpu, f).numpy() for f in (
                "blocks", "term_slot", "term_nblk", "term_skip", "term_nx",
                "term_ft")}, num_docs=cpu.num_docs, F=cpu.F, **kw),
    }[builder]
    assert build(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_frozen_image_uploads_once_per_freeze():
    vocab, docs = _docs(seed=47)
    eng = Engine(B=64, growth="const", device="cpu")
    eng.add_documents(docs[:120])
    eng.collate_now()
    frozen_blocks = eng.resident._frozen_raw.blocks
    for i, d in enumerate(docs[120:200]):
        eng.add_document(d)
        if i % 20 == 0:
            _serve(eng, _queries(vocab, "bm25", seed=i), "bm25")
    assert eng.resident.frozen_uploads == 1
    assert eng.stats().resident_uploads == 1
    assert eng.resident.batches_served >= 4
    assert eng.resident._frozen_raw.blocks is frozen_blocks
    eng.collate_now()
    _serve(eng, _queries(vocab, "conjunctive", seed=99), "conjunctive")
    assert eng.resident.frozen_uploads == 2
    assert eng.resident.epoch == 2


def test_engine_adopts_an_index_built_by_the_jax_package():
    vocab, docs = _docs(seed=53, n=150)
    jax_eng = _replay(JaxEngine(B=64, growth="const"),
                      _stream_ops(docs, deletes=False)[:4]
                      + [("delete", 17)])
    idx = jax_eng.index
    port_idx = dynamic_index_from_arrays(
        I=idx.store.I, nblocks=idx.store.nblocks, hash=idx.hash,
        vocab_size=idx.vocab_size, num_docs=idx.num_docs,
        num_postings=idx.num_postings, num_words=idx.num_words,
        tombstones=idx.tombstones, B=64, growth="const", F=idx.F)
    port = Engine(index=port_idx, device="cpu")
    for mode in MODES:
        for terms in _queries(vocab, mode, seed=6, n=5):
            want = _jax(jax_eng, terms, mode, "host")
            for backend in ("host", "device"):
                got = port.execute(Query(terms=terms, mode=mode, k=10,
                                         backend=backend))
                _agree(got, want, mode, 1e-5)


@pytest.mark.parametrize("mode", ["phrase", "proximity", "bm25_prox",
                                  "ranked_tfidf"])
def test_word_level_engine_serves_from_the_host(mode):
    """Word-level indexes have no device image: every mode, positional
    ones included, routes to the host and matches the JAX host backend."""
    vocab, docs = _docs(seed=59, n=120, V=40)
    jax_eng = JaxEngine(B=64, growth="const", word_level=True)
    port = Engine(B=64, growth="const", word_level=True, device="cpu")
    for d in docs:
        jax_eng.add_document(d)
        port.add_document(d)
    window = 4 if mode == "proximity" else None
    k = 10
    for terms in _queries(vocab, mode, seed=8, n=6):
        want = jax_eng.execute(JaxQuery(terms=terms, mode=mode, k=k,
                                        window=window, backend="host"))
        got = port.execute(Query(terms=terms, mode=mode, k=k,
                                 window=window))
        assert got.backend == "host"
        assert got.docids.tolist() == want.docids.tolist()
        if want.scores is not None:
            assert np.array_equal(got.scores, want.scores)
    with pytest.raises(ValueError):
        port.execute(Query(terms=("w1",), mode=mode, k=k, window=window,
                           backend="device"))


def test_force_backend_pins_every_query():
    vocab, docs = _docs(seed=61, n=80)
    eng = Engine(B=64, growth="const", device="cpu", force_backend="host")
    eng.add_documents(docs)
    got = eng.execute_many([Query(terms=(vocab[i],), mode="bm25", k=5)
                            for i in range(6)])
    assert {r.backend for r in got} == {"host"}
    assert eng.stats().by_backend == {"host": 6}
