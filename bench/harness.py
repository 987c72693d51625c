"""One run of one cell: set-up, warm-up, the measured window, the metrics,
the comparison with the reference, and the result line.

Everything a cell needs is found by name: the workload in
``BENCHMARK.json``, its configuration in the file that names, its mix in
``bench/mixes/<traffic>.json`` and each metric's reader in
``bench/metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import check, traffic
from .tracing import DeviceTrace, Recorder, busy_seconds, device_ops, idle_gaps

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    end_to_end: list
    per_layer: list


def cell(name: str, bench: dict | None = None) -> Cell:
    """Cell ``name`` as ``BENCHMARK.json`` defines it, with the metrics it
    reports: end-to-end ones that list it (or list no cells), per-layer
    ones that list it, or that list no cells and move an end-to-end
    metric it reports."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(ROOT / entry["file"])
    mix = load_json(BENCH / "mixes" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name, int(w["chips"]), cfg, mix, e2e, layer)


def reader(metric: str):
    """The reader module of ``metric``: ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Run:
    """What the readers read.  Times are host-clock seconds."""

    setup_s: float = 0.0
    setup_phases: dict = field(default_factory=dict)
    t0: float = 0.0                 # the window opens
    t1: float = 0.0                 # the window's last answer
    batches: list = field(default_factory=list)   # (formed, answered, n)
    queries: int = 0
    unanswered: int = 0
    backends: dict = field(default_factory=dict)
    docs_ingested: int = 0
    deletes: int = 0
    counters_start: dict = field(default_factory=dict)
    counters_end: dict = field(default_factory=dict)
    footprint: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)
    device_events: list = field(default_factory=list)
    aligned: bool = False
    busy_s: float | None = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def counter(self, key: str) -> int:
        return self.counters_end.get(key, 0) - self.counters_start.get(key, 0)

    def quarter_rates(self) -> list[float]:
        """Queries a second in each quarter of the window, by answer
        time: how steady the window ran."""
        q = self.window_s / 4
        n = [0] * 4
        for _, answered, k in self.batches:
            n[min(3, int((answered - self.t0) / q))] += k
        return [x / q for x in n]


class Sample:
    """A uniform sample of ``size`` out of every answer of the window,
    drawn from the seed (Algorithm L).  The position of each answer that
    enters it is drawn ahead, so the window only compares a counter and
    stores what it is handed; ``items[slot]`` holds it."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng = size, rng
        self.items: list = []
        self.next = 0               # the next position that enters
        self.w = 1.0

    def slots(self, lo: int, n: int) -> list[tuple[int, int]]:
        """(offset, slot) of each of positions ``lo .. lo+n-1`` that enters
        the sample; each replaces what its slot held."""
        out = []
        while self.next < lo + n:
            if len(self.items) < self.size:
                slot = len(self.items)
                self.items.append(None)
            else:
                slot = int(self.rng.integers(self.size))
            out.append((self.next - lo, slot))
            self._advance()
        return out

    def _advance(self) -> None:
        if len(self.items) < self.size:
            self.next += 1
            return
        self.w *= math.exp(math.log(1.0 - self.rng.random()) / self.size)
        skip = (0 if self.w >= 1.0 else
                math.floor(math.log(1.0 - self.rng.random())
                           / math.log1p(-self.w)))
        self.next += skip + 1


@dataclass
class Feed:
    """Where the offered work stands: the next query of the pool, the next
    batch, documents visible and deletes made."""

    horizon: int
    qi: int = 0
    batch: int = 0
    ndel: int = 0


def warm(system, queries: list, batch: int) -> None:
    for i in range(0, len(queries), batch):
        system.answer(queries[i:i + batch])


def window(system, run: Run, feed: Feed, arr: traffic.Arrivals,
           queries: list, batch: int, seconds: float, sample: Sample):
    """The measured window: batches in a closed loop until ``seconds``
    have passed; before each batch its arrivals go in.  Each answer the
    sample takes is stored raw, as (position, query, horizon, deletes,
    answer).  Returns the last batch the same way, to be checked beside
    the sample."""
    n_docs0, ndel0 = feed.horizon, feed.ndel
    backends = run.backends
    last: tuple = ()
    run.t0 = time.perf_counter()
    t_end = run.t0 + seconds
    while True:
        formed = time.perf_counter()
        if formed >= t_end:
            break
        docs: list = []
        for ai in arr.before(feed.batch):
            d = arr.delete[ai]
            if d:
                if docs:
                    system.ingest(docs)
                    feed.horizon += len(docs)
                    docs = []
                system.delete(d)
                feed.ndel += 1
            else:
                docs.append(arr.docs[arr.doc_of[ai]])
        if docs:
            system.ingest(docs)
            feed.horizon += len(docs)
        qi, n = feed.qi, len(queries)
        idx = [(qi + j) % n for j in range(batch)]
        answers = system.answer([queries[i] for i in idx])
        answered = time.perf_counter()
        run.batches.append((formed, answered, batch))
        for a in answers:
            if a is None:
                run.unanswered += 1
            else:
                backends[a[2]] = backends.get(a[2], 0) + 1
        for off, slot in sample.slots(qi, batch):
            sample.items[slot] = (qi + off, idx[off], feed.horizon,
                                  feed.ndel, answers[off])
        last = (qi, idx, feed.horizon, feed.ndel, answers)
        feed.qi += batch
        feed.batch += 1
    run.t1 = run.batches[-1][1]
    run.queries = len(run.batches) * batch
    run.docs_ingested = feed.horizon - n_docs0
    run.deletes = feed.ndel - ndel0
    qi, idx, horizon, ndel, answers = last
    return [(qi + j, i, horizon, ndel, a)
            for j, (i, a) in enumerate(zip(idx, answers))]


def checked(raw: list, pool: traffic.Queries) -> list:
    """The window's raw answers (deduplicated by position) as records for
    the comparison."""
    out, seen = [], set()
    for pos, i, horizon, ndel, a in raw:
        if pos in seen:
            continue
        seen.add(pos)
        docids, scores = (a[0], a[1]) if a is not None else (None, None)
        out.append(check.Checked(pool.terms[i], pool.modes[i], pool.k,
                                 horizon, ndel, docids, scores))
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} &
                  set(FORBIDDEN))


@dataclass
class SetUp:
    """A cell's system served and warmed, with the traffic it is offered."""

    system: object
    traffic: traffic.Traffic
    queries: list
    batch: int
    feed: Feed
    setup_s: float
    phases: dict


def set_up(c: Cell, seed: int, seconds: float, device: str, t_start: float,
           system=None) -> SetUp:
    """Everything before the window, all of it counted in ``setup_s``:
    generation, the bulk load, the freeze, the service, the warm-up of
    every shape the window uses.  Then the objects set-up made are moved
    out of the collector's reach (``gc.freeze``), so that the window's
    collections walk what the window makes, and not the query pool and
    the collection the benchmark holds."""
    import torch
    on_card = device.startswith("cuda")
    cfg, mix = c.cfg, c.mix
    marks = [("start", time.perf_counter())]
    tr = traffic.make_traffic(cfg, mix, seed, seconds)
    names = traffic.term_names(int(cfg["collection"]["universe"]))
    marks.append(("generate", time.perf_counter()))
    if system is None:
        from .systems import Program
        sys_ = Program(cfg, names, device)
    else:
        sys_ = system(cfg, tr, names)
    sys_.load(tr.resident, int(cfg["load_chunk"]))
    marks.append(("load", time.perf_counter()))
    sys_.freeze()
    sys_.serve(mix)
    if on_card:
        torch.cuda.synchronize()
    marks.append(("freeze", time.perf_counter()))
    batch = int(mix["queries"]["batch"])
    queries = sys_.queries(tr.queries)
    warm(sys_, sys_.queries(tr.warmup), batch)
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    marks.append(("warm-up", time.perf_counter()))
    phases = {"before the harness": marks[0][1] - t_start}
    phases.update({n: t - marks[i][1] for i, (n, t) in enumerate(marks[1:])})
    return SetUp(sys_, tr, queries, batch, Feed(len(tr.resident)),
                 marks[-1][1] - t_start, phases)


def run_cell(c: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             system=None, log=print) -> dict:
    """One run of cell ``c``.  ``system`` None drives the program on
    ``device``; a callable (cfg, traffic, names) -> system puts another in
    its place (the control).  Returns the result line's object.

    With ``trace`` the per-layer metrics are read.  A reader that reads
    neither spans nor the card's trace (``PLAIN = True``: the host clock
    of whole batches, counters) reads a first window run as in an untraced
    run; the others read a second window, under the spans and the
    profiler.  The two windows take half of ``seconds`` each, so that the
    run measures as long as an untraced one and the profiler's trace,
    whose reading takes longer than its window, stays short."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device.startswith("cuda")
    cfg, mix = c.cfg, c.mix
    metrics = c.per_layer if trace else c.end_to_end
    readers = {m["name"]: reader(m["name"]) for m in metrics}
    plain = {n for n, r in readers.items()
             if trace and getattr(r, "PLAIN", False)}
    st = set_up(c, seed, seconds, device, t_start, system)
    sys_, tr = st.system, st.traffic
    sample = Sample(int(mix["check"]["sample"]),
                    traffic.generator(seed, traffic.SAMPLE))
    runs = []
    if plain:
        seconds /= 2
        first = Run(setup_s=st.setup_s, setup_phases=st.phases)
        window(sys_, first, st.feed, tr.arrivals, st.queries, st.batch,
               seconds, sample)
        runs.append(first)
    run = Run(setup_s=st.setup_s, setup_phases=st.phases)
    runs.append(run)
    run.counters_start = sys_.counters()
    rec = Recorder(torch.cuda.synchronize if on_card else None)
    devtrace = DeviceTrace(trace and on_card)
    if trace:
        spans = rec.install({n: getattr(r, "SPANS", ()) for n, r in
                             readers.items() if n not in plain})
        with spans, devtrace:
            last = window(sys_, run, st.feed, tr.arrivals, st.queries,
                          st.batch, seconds, sample)
    else:
        last = window(sys_, run, st.feed, tr.arrivals, st.queries, st.batch,
                      seconds, sample)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run.counters_end = sys_.counters()
    run.footprint = sys_.footprint()
    run.spans = rec.spans
    if trace and on_card:
        run.device_events = devtrace.events()
        run.aligned = devtrace.aligned
        run.busy_s = busy_seconds(run.device_events, run.t0, run.t1)
    for r in runs[:-1]:
        r.footprint = run.footprint
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(runs[0] if m["name"] in plain else run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        else:
            log(f"metric {m['name']}: nothing to read in this run",
                file=sys.stderr)
    compiled = bool(getattr(sys_, "compiles", False))
    sys_.close()
    del sys_, st
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # the comparison, once the program's state is freed
    items = checked([x for x in sample.items if x is not None] + last,
                    tr.queries)
    numbers = check.compare(
        items, sum(r.unanswered for r in runs),
        tr.resident + tr.arrivals.docs, int(cfg["collection"]["universe"]),
        [d for d in tr.arrivals.delete if d], cfg["scoring"])
    limits = cfg["limits"]
    correct = check.verdict(numbers, limits)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": c.chips if on_card else 0,
           "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = run.busy_s if run.busy_s is not None else 0.0
        dev["window_s"] = run.window_s
    out = {"correct": bool(correct),
           "attempted": sum(r.queries for r in runs),
           "failed": sum(r.unanswered for r in runs), "metrics": values,
           "device": dev, "compiled": compiled}
    if trace and on_card:
        out["breakdown"] = {
            "device_ops": device_ops(run.device_events),
            "idle_gaps": (idle_gaps(run.device_events, run.spans, run.t0,
                                    run.t1) if run.aligned else [])}
    out["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                     for n in check.NUMBERS}
    out["_runs"] = runs
    return out
