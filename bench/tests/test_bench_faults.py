"""A whole run on the CPU, past the harness's look for a card, with the
timed path broken underneath: ``correct`` has to come out false for every
fault a cell can have, and true when nothing is broken."""

from contextlib import contextmanager
from unittest import mock

import numpy as np
import pytest

from bench import harness
from bench.tests.tiny import CELLS, MANIFEST, tiny

pytest.importorskip("repro_torch")


@contextmanager
def altered_answer():
    """A docid altered where the device backend produces it."""
    from repro_torch.engine import device_backend
    real = device_backend.fused_execute

    def run(*a, **kw):
        out = real(*a, **kw)
        for r in out:
            if len(r.docids):
                r.docids = r.docids.copy()
                r.docids[0] += 1
                break
        return out
    with mock.patch.object(device_backend, "fused_execute", run):
        yield


@contextmanager
def half_left_out():
    """Half of every engine batch answered with nothing."""
    from repro_torch.engine import engine
    from repro_torch.engine.types import QueryResult
    real = engine.Engine.execute_many

    def run(self, queries):
        out = real(self, queries)
        return [QueryResult.empty(q.mode, r.backend) if i % 2 else r
                for i, (q, r) in enumerate(zip(queries, out))]
    with mock.patch.object(engine.Engine, "execute_many", run):
        yield


@contextmanager
def state_unchanged():
    """The device images never refresh after the first time: the window's
    documents and deletes never reach the answers."""
    from repro_torch.engine import device_backend
    real = device_backend.ResidentImageManager.refresh

    def run(self):
        if self._synced_version >= 0:
            return False
        return real(self)
    with mock.patch.object(device_backend.ResidentImageManager, "refresh",
                           run):
        yield


@contextmanager
def exchange_left_out():
    """The fleet's merge without the second shard's answers."""
    from repro_torch.core import sharded_index
    from repro_torch.engine.types import QueryResult
    real = sharded_index.ShardedEngine.execute_many

    def run(self, queries):
        second = self.engines[1]
        empty = [QueryResult.empty(q.mode, "device") for q in queries]
        with mock.patch.object(second, "execute_many", lambda qs: empty):
            return real(self, queries)
    with mock.patch.object(sharded_index.ShardedEngine, "execute_many", run):
        yield


FAULTS = {
    "altered_answer": (altered_answer, CELLS),
    "half_left_out": (half_left_out, CELLS),
    "state_unchanged": (state_unchanged, ("wsj1-fleet2.immediate",)),
    "exchange_left_out": (exchange_left_out, ("wsj1-fleet2.immediate",)),
}
CASES = [(f, c) for f, (_, cells) in FAULTS.items() for c in cells]


@pytest.mark.parametrize("fault,name", CASES)
def test_a_broken_run_is_not_correct(fault, name):
    with FAULTS[fault][0]():
        out = harness.run_cell(tiny(name), 2**31 + 17, 1.5, False, "cpu")
    assert out["correct"] is False
    assert out["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(name, trace):
    out = harness.run_cell(tiny(name), 2**31 + 17, 1.5, bool(trace), "cpu")
    runs = out.pop("_runs")
    run = runs[-1]
    # a traced run gives a metric that reads no span an untraced window
    assert len(runs) == (2 if trace else 1)
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
    assert run.backends == {"device": run.queries}
    assert run.queries > 0 and out["compiled"] is False
    if "immediate" in name:
        assert run.docs_ingested > 0 and run.deletes > 0
    cell = harness.cell(name, MANIFEST)
    want = {m["name"] for m in
            (cell.per_layer if trace else cell.end_to_end)}
    # on the CPU the card's trace is empty: only its readers stay silent
    silent = {"fused_query_roofline", "idle_share"}
    assert set(out["metrics"]) == want - silent
    assert all(np.isfinite(v["value"]) for v in out["metrics"].values())
