"""The port's planner and its measured crossover against the JAX package's.

* ``CrossoverTable.from_rows`` on seeded random sweeps (three modes, one to
  three collection sizes, batches 1, 2, 8 and 32, tied times and missing
  host rows) gives the JAX table, with the reference's ``"pallas"``
  backend read as the port's ``"kernel"``; the reference's own cases
  (``tests/test_fused_query.py``'s ``_rows()``) hold on the port; a table
  survives a ``from_bench`` round trip.
* ``Planner.plan`` on an exhaustive grid — mode, batch size, f_t lists
  under and over the volume thresholds, the index's capabilities, a
  published tier or none, every combination of the three ``allow_*``
  flags, and no table or a table with thresholds, ``None``s and an
  unswept mode — routes each case where the JAX planner does, ``"pallas"``
  read as ``"kernel"``.  The one documented exception is rule 4 (a large
  candidate volume) on a device-capable index with the device allowed:
  the reference says ``"pallas"``, the port ``"device"``, since on such an
  index both of the port's backends make the same single ``fused_query``
  launch.
* ``kernels.registry.supporting(mode)`` names the reference's kernels.
"""

import inspect
import itertools
import json

import numpy as np
import pytest

from repro.engine.planner import CrossoverTable as JaxCrossoverTable
from repro.engine.planner import Planner as JaxPlanner
from repro.engine.planner import PlannerConfig as JaxPlannerConfig
from repro.engine.types import Query as JaxQuery
from repro.engine.types import TermStats as JaxTermStats
from repro.kernels import registry as jax_registry
from repro_torch.engine import CrossoverTable, PlannerConfig, Query
from repro_torch.engine.planner import Planner
from repro_torch.engine.types import TermStats
from repro_torch.kernels import registry

FUSED = ("conjunctive", "ranked_tfidf", "bm25")
BACKENDS = {"pallas": "kernel"}          # the reference's name -> the port's


def _port_name(backend: str) -> str:
    return BACKENDS.get(backend, backend)


def _port_rows(rows):
    return [dict(r, backend=_port_name(r["backend"])) for r in rows]


def _port_table(jax_min_batch: dict) -> dict:
    return {mode: {_port_name(b): v for b, v in per.items()}
            for mode, per in jax_min_batch.items()}


def _random_sweep(seed: int) -> list[dict]:
    """Rows as ``engine_bench.py`` records them, drawn from a seed: times
    from a few values (ties with the host happen), about one host row in
    six missing, rows of other backends missing now and then, extra keys,
    shuffled."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice([300, 1200, 5000], size=int(rng.integers(1, 4)),
                       replace=False).tolist()
    rows = []
    for mode in FUSED:
        for size in sizes:
            for batch in (1, 2, 8, 32):
                for backend in ("host", "device", "pallas"):
                    if rng.random() < (1 / 6 if backend == "host" else 0.1):
                        continue
                    rows.append({"workload": mode, "backend": backend,
                                 "size": int(size), "batch": batch,
                                 "us_per_query": float(
                                     rng.integers(1, 6) * 20),
                                 "warmup_ms": float(rng.random())})
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


@pytest.mark.parametrize("seed", range(16))
def test_from_rows_matches_the_jax_table(seed):
    rows = _random_sweep(seed)
    want = JaxCrossoverTable.from_rows(rows)
    got = CrossoverTable.from_rows(_port_rows(rows))
    assert got.min_batch == _port_table(want.min_batch)
    assert got.swept_modes == want.swept_modes
    for mode in FUSED + ("phrase",):
        for backend in ("device", "pallas"):
            assert got.min_batch_for(mode, _port_name(backend)) == \
                want.min_batch_for(mode, backend)


def _rows():
    """The reference's ``_rows()`` with its backends in the port's names."""
    rows = []
    for size in (300, 1200):
        for batch in (1, 8, 32):
            rows.append({"workload": "bm25", "backend": "host",
                         "size": size, "batch": batch, "us_per_query": 100.0})
            # device wins from batch 8 at EVERY size
            rows.append({"workload": "bm25", "backend": "device",
                         "size": size, "batch": batch,
                         "us_per_query": 150.0 if batch < 8 else 60.0})
            # the kernel wins at 32 on ONE size only -> conservative None
            rows.append({"workload": "bm25", "backend": "kernel",
                         "size": size, "batch": batch,
                         "us_per_query": 80.0 if (batch == 32 and
                                                  size == 300) else 140.0})
    return rows


def test_crossover_table_derivation():
    t = CrossoverTable.from_rows(_rows())
    assert t.min_batch["bm25"]["device"] == 8
    assert t.min_batch["bm25"]["kernel"] is None   # must win at every size
    jax_rows = [dict(r, backend="pallas") if r["backend"] == "kernel" else r
                for r in _rows()]
    assert t.min_batch == _port_table(
        JaxCrossoverTable.from_rows(jax_rows).min_batch)


def test_planner_routes_by_measured_crossover():
    t = CrossoverTable.from_rows(_rows())
    p = Planner(PlannerConfig(crossover=t, kernel_min_postings=10 ** 9))
    stats = [TermStats(ft=50, nblocks=2)]
    q = Query(terms=("a",), mode="bm25", k=10)
    kw = dict(device_capable=True, kernel_capable=True)
    assert p.plan(q, 8, stats, **kw).backend == "device"
    assert p.plan(q, 1, stats, **kw).backend == "host"
    # a mode the sweep never measured keeps the static default
    q2 = Query(terms=("a",), mode="ranked_tfidf", k=10)
    assert p.plan(q2, 8, stats, **kw).backend == "device"


def test_crossover_from_bench_round_trip(tmp_path):
    path = tmp_path / "bench.json"
    path.write_text(json.dumps({"crossover": {"rows": _rows()}}))
    assert CrossoverTable.from_bench(str(path)).min_batch == \
        CrossoverTable.from_rows(_rows()).min_batch
    # no default file: the repository's BENCH_engine.json is the JAX
    # package's CPU sweep, in the reference's backend names
    default = inspect.signature(CrossoverTable.from_bench).parameters[
        "path"].default
    assert default is inspect.Parameter.empty


# ---------------------------------------------------------------------------
# the planning grid
# ---------------------------------------------------------------------------

#: f_t lists under and over the volume thresholds (2,048 postings each):
#: none known, small, Σ over but min under, min over, a zero among them
FT_LISTS = ([], [0], [5], [5, 100], [1500, 1500], [3000], [3000, 10],
            [2048], [0, 2500], [2048, 2048, 9000])
BATCHES = (1, 2, 4, 8, 32)
#: tables in the reference's names: thresholds, Nones and an unswept mode
JAX_TABLES = {
    "none": None,
    "mixed": {"conjunctive": {"device": 8, "pallas": None},
              "ranked_tfidf": {"device": None, "pallas": 2}},
    "never": {"conjunctive": {"device": None, "pallas": None},
              "ranked_tfidf": {"device": 1, "pallas": 1},
              "bm25": {"device": 32, "pallas": 4}},
}


def _rule4_on_device(jax_decision, allow_device, device_capable) -> bool:
    return (jax_decision.backend == "pallas"
            and jax_decision.reason.startswith("candidate volume")
            and allow_device and device_capable)


@pytest.mark.parametrize("mode", FUSED + ("phrase",))
@pytest.mark.parametrize("table", sorted(JAX_TABLES))
def test_plan_matches_the_jax_planner_on_the_grid(table, mode):
    jax_min = JAX_TABLES[table]
    jax_table = None if jax_min is None else JaxCrossoverTable(jax_min)
    port_table = None if jax_min is None else \
        CrossoverTable(_port_table(jax_min))
    seen, cases = set(), 0
    for allow_device, allow_kernel, allow_tiered in itertools.product(
            (False, True), repeat=3):
        jp = JaxPlanner(JaxPlannerConfig(
            allow_device=allow_device, allow_pallas=allow_kernel,
            allow_tiered=allow_tiered, crossover=jax_table))
        pp = Planner(PlannerConfig(
            allow_device=allow_device, allow_kernel=allow_kernel,
            allow_tiered=allow_tiered, crossover=port_table))
        for fts, batch, device_capable, kernel_capable, tiered_available, \
                tiered_capable in itertools.product(
                    FT_LISTS, BATCHES, (False, True), (False, True),
                    (False, True), (False, True)):
            terms = tuple(f"t{i}" for i in range(max(1, len(fts))))
            want = jp.plan(JaxQuery(terms=terms, mode=mode), batch,
                           [JaxTermStats(f, 0) for f in fts],
                           device_capable=device_capable,
                           pallas_capable=kernel_capable,
                           tiered_available=tiered_available,
                           tiered_capable=tiered_capable)
            got = pp.plan(Query(terms=terms, mode=mode), batch,
                          [TermStats(f, 0) for f in fts],
                          device_capable=device_capable,
                          kernel_capable=kernel_capable,
                          tiered_available=tiered_available,
                          tiered_capable=tiered_capable)
            if _rule4_on_device(want, allow_device, device_capable):
                expect = "device"
            else:
                expect = _port_name(want.backend)
            assert got.backend == expect, (
                fts, batch, device_capable, kernel_capable,
                tiered_available, tiered_capable, allow_device,
                allow_kernel, allow_tiered, want, got)
            seen.add(got.backend)
            cases += 1
    assert cases == 8 * len(FT_LISTS) * len(BATCHES) * 16
    if mode == "phrase":
        assert seen == {"host", "tiered"}
    else:
        assert seen == {"host", "device", "kernel", "tiered"}


def test_a_table_routes_swept_modes_by_its_thresholds():
    """The table alone decides the batch rule of a swept mode: below the
    device's threshold a batch stays off the device even past
    ``device_min_batch``, the kernel backend takes it from its own
    threshold, and a mode whose backends never won stays on the host;
    ``allow_kernel=False`` keeps the kernel backend's threshold unused."""
    table = CrossoverTable(_port_table(JAX_TABLES["mixed"]))
    stats = [TermStats(5, 0)]
    kw = dict(device_capable=True, kernel_capable=True)
    p = Planner(PlannerConfig(crossover=table))
    q = Query(terms=("t",), mode="conjunctive")
    assert [p.plan(q, b, stats, **kw).backend for b in BATCHES] == \
        ["host", "host", "host", "device", "device"]
    q = Query(terms=("t",), mode="ranked_tfidf")
    assert [p.plan(q, b, stats, **kw).backend for b in BATCHES] == \
        ["host", "kernel", "kernel", "kernel", "kernel"]
    q = Query(terms=("t",), mode="bm25")               # not swept
    assert [p.plan(q, b, stats, **kw).backend for b in BATCHES] == \
        ["host", "host", "device", "device", "device"]
    off = Planner(PlannerConfig(crossover=table, allow_kernel=False))
    q = Query(terms=("t",), mode="ranked_tfidf")
    assert {off.plan(q, b, stats, **kw).backend for b in BATCHES} == {"host"}


@pytest.mark.parametrize("mode", FUSED + ("phrase", "proximity",
                                          "bm25_prox"))
def test_supporting_names_the_reference_kernels(mode):
    want = {s.name for s in jax_registry.supporting(mode)}
    got = {s.name for s in registry.supporting(mode)}
    assert got == want
    assert all(mode in s.modes for s in registry.supporting(mode))
