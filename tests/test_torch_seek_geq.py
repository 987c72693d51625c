"""The port's ``PostingsCursor.seek_geq`` (the paper's §3.2/§3.6 block-skip
seek) against the reference's, mirroring ``tests/test_seek_geq.py``.

The same documents go into the reference's ``DynamicIndex`` and the
port's.  Every port cursor is wrapped in the port's contract cursor
(``repro_torch.analysis.contracts.wrap``), which asserts the protocol's
postconditions on every call; the reference's cursor, in the reference's
wrapper, is driven through the same targets.  Both must land on the same
docids, and on the ones the decoded postings say, for every growth policy,
at word level, and on adversarial gap patterns.
"""

import numpy as np
import pytest

from repro.analysis.contracts import wrap as jax_wrap
from repro.core import query as JQ
from repro.core.index import DynamicIndex as JaxIndex
from repro.core.query import PostingsCursor as JaxCursor
from repro_torch.analysis.contracts import ContractCursor, wrap
from repro_torch.core import query as Q
from repro_torch.core.index import DynamicIndex
from repro_torch.core.query import PostingsCursor

GROWTHS = ["const", "triangle", "expon"]


def _both(docs, **kw):
    """The reference's index and the port's over the same documents."""
    ref, port = JaxIndex(**kw), DynamicIndex(**kw)
    for doc in docs:
        ref.add_document(doc)
        port.add_document(doc)
    return ref, port


def _cursors(ref, port, term):
    cur = wrap(PostingsCursor(port.store, port.lookup(term)), label=term)
    assert isinstance(cur, ContractCursor)
    return cur, jax_wrap(JaxCursor(ref.store, ref.lookup(term)), label=term)


def _sweep_cursor(ref, port, term, targets):
    """Drive both cursors through non-decreasing ``targets``: every landing
    position of the port's is checked against its decoded postings list,
    and the two cursors visit the same docids."""
    docids, _ = port.postings(term)
    assert docids.tolist() == ref.postings(term)[0].tolist()
    cur, rcur = _cursors(ref, port, term)
    floor = 0  # cursors only move forward
    visited, ref_visited = [], []
    for t in targets:
        ok = cur.seek_geq(t)
        assert ok == rcur.seek_geq(t), (term, t)
        eff = max(t, floor)
        j = np.searchsorted(docids, eff)
        if j >= len(docids):
            assert not ok
            break
        assert ok, (term, t)
        assert cur.docid == docids[j], (term, t, cur.docid, docids[j])
        visited.append(int(cur.docid))
        ref_visited.append(int(rcur.docid))
        floor = cur.docid
    assert visited == ref_visited


@pytest.mark.parametrize("growth", GROWTHS)
@pytest.mark.parametrize("word_level", [False, True])
def test_seek_geq_random_targets(zipf_docs, growth, word_level):
    vocab, docs = zipf_docs
    ref, port = _both(docs[:250], B=48, growth=growth, word_level=word_level)
    rng = np.random.default_rng(7)
    for ti in rng.choice(150, size=25, replace=False):
        term = vocab[ti]
        docids, _ = port.postings(term)
        if len(docids) == 0:
            continue
        lo, hi = int(docids[0]), int(docids[-1])
        targets = np.sort(rng.integers(max(0, lo - 2), hi + 3, size=12))
        _sweep_cursor(ref, port, term, targets.tolist())


@pytest.mark.parametrize("growth", GROWTHS)
def test_seek_geq_adversarial_gaps(growth):
    """Huge d-gaps (block-leading b-gaps spanning thousands of docs),
    singleton chains, and dense runs right after a gap."""
    pattern = ([1, 2, 3] + list(range(40, 60)) + [1500]
               + list(range(2995, 3001)))
    hit = set(pattern)
    docs = []
    for d in range(1, 3001):
        terms = ["filler", f"mod{d % 7}"]
        if d in hit:
            terms.append("rare")
        if d == 1700:
            terms.append("singleton")
        docs.append(terms)
    ref, port = _both(docs, B=40, growth=growth)
    docids, _ = port.postings("rare")
    assert docids.tolist() == sorted(hit)
    # jump straight across the 1440-doc gap, then probe the dense tail
    _sweep_cursor(ref, port, "rare",
                  [0, 3, 55, 61, 1499, 1500, 1501, 2995, 3000])
    # target beyond the last posting exhausts
    _sweep_cursor(ref, port, "rare", [3001])
    # singleton chain: land exactly, then exhaust
    _sweep_cursor(ref, port, "singleton", [5, 1700])
    _sweep_cursor(ref, port, "singleton", [1701])
    # long filler chain (3000 postings, many blocks): every-block boundaries
    filler_ids, _ = port.postings("filler")
    _sweep_cursor(ref, port, "filler", filler_ids[::97].tolist())


@pytest.mark.parametrize("growth", GROWTHS)
def test_seek_geq_drives_conjunctive_vs_brute(zipf_docs, growth):
    """conjunctive_query is built on seek_geq; differential against the
    set-intersection oracle and the reference's conjunctive_query doubles
    as an end-to-end seek check."""
    vocab, docs = zipf_docs
    ref, port = _both(docs[:300], B=40, growth=growth)
    rng = np.random.default_rng(13)
    for _ in range(40):
        terms = [vocab[i] for i in
                 rng.choice(100, size=rng.integers(2, 5), replace=False)]
        got = Q.conjunctive_query(port, terms)
        assert got.tolist() == Q.brute_conjunctive(port, terms).tolist()
        assert got.tolist() == JQ.conjunctive_query(ref, terms).tolist()


def test_seek_geq_word_level_adversarial():
    """Word-level postings repeat docids (one posting per occurrence);
    seek_geq must land on the FIRST occurrence of the target document,
    as the reference's cursor does."""
    docs = []
    for d in range(1, 400):
        if d % 50 == 0:
            docs.append(["echo"] * 5 + ["pad"])  # 5 occurrences
        else:
            docs.append(["pad"])
    ref, port = _both(docs, B=48, growth="const", word_level=True)
    cur, rcur = _cursors(ref, port, "echo")
    for c in (cur, rcur):
        assert c.seek_geq(120)
        assert c.docid == 150
        # advancing within the 5 duplicate postings stays on the document
        assert c.next() and c.docid == 150
        assert c.seek_geq(200) and c.docid == 200
        assert not c.seek_geq(351)  # beyond the last posting: exhausts
