"""Hybrid retrieval, the slice as a whole: the port against the JAX package.

The hybrid example's three rounds (``examples/hybrid_retrieval.py``) run in
both packages on the same seeded corpus with the same two-tower parameters
(the reference's ``twotower_init``, carried across by
``convert.twotower_from_jax``): stage 1, conjunctive candidates from the
live dynamic index, must be the same sets (450, 451 and 452 candidates, a
document arriving between rounds); stage 2, the dense scores of the
candidates, within rtol 1e-5, atol 1e-6 (float32 towers summed in other
orders), and the top 5 the same up to swaps among scores within that
tolerance.  From round 1 on, the fresh document's docid is past the item
table, and both packages read its last row.  Stage 1 through the port's
``Engine(device="cpu")`` forced to the device backend (frozen image plus
delta) gives the same candidates, and the port's example script prints the
reference's counts.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import DynamicIndex as JaxIndex
from repro.core.query import conjunctive_query as jax_conjunctive
from repro.data.corpus import CorpusSpec as JaxSpec
from repro.data.corpus import SyntheticCorpus as JaxCorpus
from repro.kernels.retrieval_dot.ops import candidate_scores as jax_scores
from repro.models import recsys as rec
from repro_torch import convert
from repro_torch.core.index import DynamicIndex
from repro_torch.core.query import conjunctive_query
from repro_torch.data.corpus import CorpusSpec, SyntheticCorpus
from repro_torch.engine import Engine, Query
from repro_torch.kernels.retrieval_dot.ops import candidate_scores
from repro_torch.models.recsys import TwoTowerConfig

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
COUNTS = [450, 451, 452]
SPEC = dict(n_docs=1500, words_per_doc=120, universe=3_000, seed=3)
USER = [[11, 99, 1033, 7]]


def _rounds(idx, docs, stage1, stage2):
    """The example's loop: per round, the candidates and what ``stage2``
    makes of them; then a fresh document holding the query terms."""
    terms = [docs[10][0], docs[10][1]]
    out = []
    for round_ in range(3):
        cands = np.asarray(stage1(idx, terms), np.int64)
        out.append((cands, stage2(cands)))
        newdoc = [terms[0], terms[1], "freshdoc"] + docs[round_]
        idx.add_document(newdoc)
        docs.append(newdoc)
    return terms, out


@pytest.fixture(scope="module")
def both():
    """(terms, jax rounds, port rounds, the port's documents with the
    fresh ones appended)."""
    jdocs = list(JaxCorpus(JaxSpec(**SPEC)).doc_terms())
    tdocs = list(SyntheticCorpus(CorpusSpec(**SPEC)).doc_terms())
    assert jdocs == tdocs
    kw = dict(n_users_vocab=4096, n_items=len(jdocs) + 1, embed_dim=32,
              tower_mlp=(64, 32), n_user_feats=4)
    jcfg = rec.TwoTowerConfig(**kw)
    params = rec.twotower_init(jcfg, jax.random.PRNGKey(0))
    model = convert.twotower_from_jax(jax.tree.map(np.asarray, params),
                                      TwoTowerConfig(**kw), device="cpu")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    user = {"user_feats": jnp.asarray(USER, jnp.int32),
            "user_mask": jnp.ones((1, 4), jnp.float32)}
    u = rec.user_embedding(params, user, jcfg, mesh)

    def jax_stage2(cands):
        emb = rec.item_embedding(params, jnp.asarray(cands, jnp.int32), jcfg,
                                 mesh)
        return np.asarray(jax_scores(u, emb, tile_q=8, tile_n=128,
                                     tile_d=32))[0]

    with torch.inference_mode():
        tu = model.user_embedding({"user_feats": torch.tensor(USER),
                                   "user_mask": torch.ones(1, 4)})

        def port_stage2(cands):
            emb = model.item_embedding(torch.from_numpy(cands))
            return candidate_scores(tu, emb)[0].numpy()

        jidx, tidx = JaxIndex(B=64), DynamicIndex(B=64)
        for d in jdocs:
            jidx.add_document(d)
            tidx.add_document(d)
        terms, jr = _rounds(jidx, list(jdocs), jax_conjunctive, jax_stage2)
        terms2, tr = _rounds(tidx, tdocs, conjunctive_query, port_stage2)
    assert terms == terms2
    return terms, jr, tr, tdocs


def test_candidate_counts_and_sets_match(both):
    _terms, jr, tr, _docs = both
    assert [len(c) for c, _ in tr] == COUNTS
    for (jc, _), (tc, _) in zip(jr, tr):
        assert np.array_equal(jc, tc)


def test_fresh_documents_are_candidates_past_the_item_table(both):
    """Immediate access: each round's fresh docid is a candidate of the
    next round, and it is past the item table (read as its last row)."""
    _terms, _jr, tr, _docs = both
    n_items = SPEC["n_docs"] + 1
    for r in (1, 2):
        fresh = SPEC["n_docs"] + r
        assert fresh in tr[r][0] and fresh >= n_items


@pytest.mark.parametrize("round_", [0, 1, 2])
def test_dense_scores_and_top5_match(both, round_):
    _terms, jr, tr, _docs = both
    (cands, want), (_c, got) = jr[round_], tr[round_]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    top_got = np.argsort(-got, kind="stable")[:5]
    top_want = np.argsort(-want, kind="stable")[:5]
    # rank by rank, the port's pick scores as the reference's: the docids
    # differ only where two scores tie within the tolerance
    tol = ATOL + RTOL * np.abs(want[top_want])
    assert np.all(np.abs(want[top_got] - want[top_want]) <= tol)


def test_engine_device_backend_gives_the_same_candidates(both):
    """Stage 1 through ``Engine.execute_many`` on the device backend (its
    plain versions on the CPU): a freeze after the corpus, the fresh
    documents in the delta."""
    terms, _jr, tr, docs = both
    eng = Engine(B=64, growth="const", device="cpu")
    eng.add_documents(docs[:SPEC["n_docs"]])
    eng.collate_now()
    q = Query(terms=tuple(terms), mode="conjunctive", backend="device")
    for round_ in range(3):
        res = eng.execute_many([q, q])
        assert all(r.backend == "device" for r in res)
        for r in res:
            assert np.array_equal(r.docids, tr[round_][0])
            assert np.array_equal(
                r.docids, conjunctive_query(eng.index, list(terms)))
        eng.add_document(docs[SPEC["n_docs"] + round_])


def test_example_script_prints_the_reference_counts():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "hybrid_retrieval_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[round")]
    assert [int(ln.split("] ")[1].split()[0]) for ln in lines] == COUNTS
