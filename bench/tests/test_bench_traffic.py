"""The traffic generator is a pure function of its seed."""

import numpy as np
import pytest

from bench import traffic
from bench.tests.tiny import CELLS, tiny


def same(a: traffic.Traffic, b: traffic.Traffic) -> bool:
    return (len(a.resident) == len(b.resident)
            and all(np.array_equal(x, y) for x, y in zip(a.resident,
                                                          b.resident))
            and a.queries.terms == b.queries.terms
            and a.queries.modes == b.queries.modes
            and a.warmup.terms == b.warmup.terms
            and np.array_equal(a.arrivals.delete, b.arrivals.delete)
            and all(np.array_equal(x, y) for x, y in zip(a.arrivals.docs,
                                                          b.arrivals.docs)))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 3 * 2**40, -5])
def test_same_seed_same_traffic(name, seed):
    c = tiny(name)
    assert same(traffic.make_traffic(c.cfg, c.mix, seed, 3.0),
                traffic.make_traffic(c.cfg, c.mix, seed, 3.0))


@pytest.mark.parametrize("name", CELLS)
def test_other_seed_other_traffic(name):
    c = tiny(name)
    assert not same(traffic.make_traffic(c.cfg, c.mix, 1, 3.0),
                    traffic.make_traffic(c.cfg, c.mix, 2, 3.0))


def test_queries_draw_known_distinct_terms_in_mode_cycle():
    c = tiny("wsj1-const.bulk")
    tr = traffic.make_traffic(c.cfg, c.mix, 5, 1.0)
    for i, (ts, m) in enumerate(zip(tr.queries.terms, tr.queries.modes)):
        assert 1 <= len(ts) <= 4 and len(set(ts)) == len(ts)
        assert all(tr.known[t] for t in ts)
        assert m == ("conjunctive", "ranked_tfidf", "bm25")[i % 3]
    assert tr.queries.k == 10


def test_arrivals_a_fixed_number_a_batch_and_live_deletes():
    c = tiny("wsj1-fleet2.immediate")
    counts = set()
    chunk = 4 * traffic.CHUNK_BATCHES
    for seed in (3, 4, 5):
        a = traffic.make_traffic(c.cfg, c.mix, seed, 4.0).arrivals
        counts.add(len(a))
        ahead = int(np.ceil(16 * 4.0))
        assert len(a) == chunk * int(np.ceil(ahead / traffic.CHUNK_BATCHES))
        assert list(a.before(0)) == [0, 1, 2, 3]
        # a window that outruns what set-up drew draws the next chunk
        n = len(a)
        assert list(a.before(n // 4)) == [n, n + 1, n + 2, n + 3]
        assert len(a) % chunk == 0
        delete = np.asarray(a.delete)
        dels = delete[delete > 0]
        assert len(dels) == len(set(dels.tolist()))
        assert np.all(delete[31::32] > 0)
        assert np.count_nonzero(delete) == len(a) // 32
        # a delete names a document ingested before it
        ndocs = c.cfg["n_docs"]
        for i in range(len(a)):
            if delete[i]:
                assert 1 <= delete[i] <= ndocs
            else:
                ndocs += 1
    assert len(counts) == 1


def test_arrivals_drawn_later_are_those_drawn_ahead():
    """A chunk is the same whether set-up or the window draws it."""
    c = tiny("wsj1-fleet2.immediate")
    a = traffic.make_traffic(c.cfg, c.mix, 2**31 + 5, 1.0).arrivals
    b = traffic.make_traffic(c.cfg, c.mix, 2**31 + 5, 20.0).arrivals
    a.draw(b.per_batch and len(b) // b.per_batch)
    assert len(a) == len(b) and a.delete == b.delete
    assert all(np.array_equal(x, y) for x, y in zip(a.docs, b.docs))


def test_every_seed_offers_the_same_sizes():
    c = tiny("wsj1-fleet2.immediate")
    a, b = (traffic.make_traffic(c.cfg, c.mix, s, 2.0) for s in (8, 9))
    assert sorted(map(len, a.resident)) == sorted(map(len, b.resident))
    assert sorted(map(len, a.arrivals.docs)) == sorted(
        map(len, b.arrivals.docs))
    assert sorted(map(len, a.queries.terms)) == sorted(
        map(len, b.queries.terms))
    assert [len(x) for x in a.resident] != [len(x) for x in b.resident]
