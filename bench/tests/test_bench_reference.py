"""The reference against the port's host backend on a tiny seeded stream
with deletes, for one engine and for the two-shard fleet (this test may
import both; the reference imports nothing of the port)."""

import numpy as np
import pytest

from bench import check, traffic
from bench.tests.tiny import tiny

pytest.importorskip("repro_torch")


def drive(sharded: bool, seed: int):
    from repro_torch.core.sharded_index import ShardedEngine
    from repro_torch.engine import Engine, Query
    c = tiny("wsj1-fleet2.immediate" if sharded else "wsj1-const.bulk",
             n_docs=300)
    tr = traffic.make_traffic(c.cfg, c.mix, seed, 1.0)
    names = traffic.term_names(c.cfg["collection"]["universe"])
    eng = (ShardedEngine(num_shards=2, B=64, growth="const", device="cpu")
           if sharded else Engine(B=64, growth="const", device="cpu"))
    strings = [[names[i] for i in d.tolist()] for d in tr.resident]
    eng.add_documents(strings[:200])
    eng.collate_now()
    eng.add_documents(strings[200:])
    rng = np.random.default_rng(seed)
    dead = [int(d) for d in rng.choice(np.arange(1, 301), 12,
                                       replace=False)]
    for d in dead[:6]:
        eng.delete_document(d)
    checked = []
    for ts, m in zip(tr.queries.terms[:150], tr.queries.modes[:150]):
        q = Query(terms=tuple(names[t] for t in ts), mode=m, k=10,
                  backend="host")
        r = eng.execute_many([q])[0]
        checked.append(check.Checked(ts, m, 10, 300, 6, r.docids, r.scores))
    if sharded:
        eng.close()
    return tr, dead, checked, c


@pytest.mark.parametrize("sharded", [False, True], ids=["engine", "fleet"])
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_reference_matches_the_host_backend(sharded, seed):
    tr, dead, checked, c = drive(sharded, seed)
    got = check.compare(checked, 0, tr.resident, 5000, dead,
                        c.cfg["scoring"])
    assert got["conj_wrong"] == 0 and got["ranked_wrong"] == 0
    assert got["score_gap"] < 1e-12 and got["rank_gap"] == 0.0
    # and it tells a stale view from the right one: the same answers
    # judged as if the deletes had not been made
    stale = check.compare(
        [check.Checked(x.terms, x.mode, x.k, x.horizon, 0, x.docids,
                       x.scores) for x in checked],
        0, tr.resident, 5000, dead, c.cfg["scoring"])
    assert stale["conj_wrong"] + stale["ranked_wrong"] > 0 or \
        stale["score_gap"] > 1e-6
