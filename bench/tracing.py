"""Spans around the program's calls, and the card's trace, for the
``--trace 1`` run.

A span wraps one function or method of the program from outside, as
``unittest.mock`` patches it: the host clock before and after the call
(with a synchronize on each side when the span asks for it), the thread,
the result when it is a bool, and what the span's ``capture`` takes from
the call.  Per-layer readers declare the spans they read (``SPANS``); the
harness adds its own, which name what the host was doing while the card
idled.

The card's trace is ``torch.profiler`` with the CUDA activity alone.  A
short spin kernel launched right after the profiler starts ties the
trace's clock to the host's, so idle gaps can be named by the span that
covered them.
"""

from __future__ import annotations

import bisect
import importlib
import threading
import time
from contextlib import ExitStack
from dataclasses import dataclass, field
from unittest import mock

#: the harness's own spans: what the host was doing while the card idled
LABELS = (
    "repro_torch.serve.query_service:QueryService.flush",
    "repro_torch.serve.query_service:QueryService.ingest_batch",
    "repro_torch.serve.query_service:QueryService.delete",
    "repro_torch.serve.ingest_pipeline:IngestPipeline.drain",
    "repro_torch.core.sharded_index:ShardedEngine.execute_many",
    "repro_torch.engine.engine:Engine.execute_many",
    "repro_torch.engine.device_backend:ResidentImageManager.refresh",
    "repro_torch.engine.device_backend:pack_queries",
    "repro_torch.engine.device_backend:fused_execute",
    "repro_torch.kernels.fused_query.ops:prepare",
    "repro_torch.kernels.fused_query.ops:fused_query_kernel",
)

#: the marker kernel (``torch.cuda._sleep``) that aligns the two clocks
MARKER = "spin"


@dataclass(frozen=True)
class Span:
    """A span around ``target`` ("module:Qualified.name").  ``capture``
    (args, kwargs, result) -> value runs after the call."""

    target: str
    sync: bool = False
    capture: object = None


@dataclass
class SpanRec:
    name: str
    t0: float
    t1: float
    thread: int
    result: bool | None
    captured: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _owner(target: str):
    mod, qual = target.split(":", 1)
    obj = importlib.import_module(mod)
    parts = qual.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    return obj, parts[-1]


class Recorder:
    """Installs spans (merged by target: a span synchronizes when any
    declaration asks it to) and keeps what they record in memory."""

    def __init__(self, sync=None):
        self.sync = sync
        self.spans: list[SpanRec] = []

    def _wrap(self, fn, name: str, sync: bool, captures: dict):
        spans, do_sync = self.spans, self.sync if sync else None

        def run(*a, **kw):
            if do_sync is not None:
                do_sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if do_sync is not None:
                do_sync()
            t1 = time.perf_counter()
            got = {k: c(a, kw, out) for k, c in captures.items()}
            spans.append(SpanRec(name, t0, t1, threading.get_ident(),
                                 out if isinstance(out, bool) else None,
                                 got))
            return out
        return run

    def install(self, declared: dict) -> ExitStack:
        """``declared`` maps a reader's name to its spans.  Returns the
        stack whose close removes every wrapper."""
        by_target: dict[str, dict] = {}
        for target in LABELS:
            by_target[target] = {"sync": False, "captures": {}}
        for reader, spans in declared.items():
            for s in spans:
                e = by_target.setdefault(s.target,
                                         {"sync": False, "captures": {}})
                e["sync"] = e["sync"] or s.sync
                if s.capture is not None:
                    e["captures"][reader] = s.capture
        stack = ExitStack()
        for target, e in by_target.items():
            owner, attr = _owner(target)
            fn = getattr(owner, attr)
            stack.enter_context(mock.patch.object(
                owner, attr, self._wrap(fn, target.split(":", 1)[1],
                                        e["sync"], e["captures"])))
        return stack


class DeviceTrace:
    """``torch.profiler`` over the window, CUDA activity only; a no-op
    where the run has no card."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t_mark = None

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import torch
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False

    def events(self) -> list[tuple[str, float, float]]:
        """(name, start, end) of every device activity, in seconds of the
        host clock when the marker was found, else of the trace's own."""
        if not self.enabled:
            return []
        raw = _device_events(self.prof)
        mark = [s for n, s, _ in raw if MARKER in n]
        off = (self.t_mark - min(mark)) if mark else 0.0
        self.aligned = bool(mark)
        return [(n, s + off, e + off) for n, s, e in raw
                if MARKER not in n]


def _device_events(prof) -> list[tuple[str, float, float]]:
    """Device events of the profiler's results, in seconds."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out.append((ev.name, ev.time_range.start * 1e-6,
                        ev.time_range.end * 1e-6))
    return out


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(events, t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` in which some device activity ran."""
    return sum(max(0.0, min(e, t1) - max(s, t0))
               for s, e in merged((s, e) for _, s, e in events))


def idle_gaps(events, spans: list[SpanRec], t0: float, t1: float,
              top: int = 10) -> list[list]:
    """The card's idle time in ``[t0, t1]``, summed by the innermost span
    that covered each gap's middle (the harness's loop where none did),
    longest first."""
    busy = merged((max(s, t0), min(e, t1)) for _, s, e in events
                  if e > t0 and s < t1)
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < t1:
        gaps.append((at, t1))
    total: dict[str, float] = {}
    by_start = sorted(spans, key=lambda r: r.t0)
    active: list[SpanRec] = []
    nxt = 0
    for s, e in gaps:               # ascending, so a span once ended stays so
        mid = (s + e) / 2
        while nxt < len(by_start) and by_start[nxt].t0 <= mid:
            active.append(by_start[nxt])
            nxt += 1
        active = [r for r in active if r.t1 >= mid]
        inner = max(active, key=lambda r: r.t0, default=None)
        label = inner.name if inner is not None else "harness loop"
        total[label] = total.get(label, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(total.items(), key=lambda x: -x[1])
            ][:top]


def device_ops(events, top: int = 10) -> list[list]:
    """Device seconds by operation name, largest first."""
    total: dict[str, float] = {}
    for n, s, e in events:
        total[n] = total.get(n, 0.0) + (e - s)
    return [[k[:160], v] for k, v in sorted(total.items(),
                                             key=lambda x: -x[1])][:top]



class Nested:
    """Spans sorted by start, to find those that lie inside another."""

    def __init__(self, spans: list[SpanRec]):
        self.spans = sorted(spans, key=lambda s: s.t0)
        self.starts = [s.t0 for s in self.spans]

    def inside(self, parent: SpanRec,
               same_thread: bool = False) -> list[SpanRec]:
        out = []
        for s in self.spans[bisect.bisect_left(self.starts, parent.t0):]:
            if s.t0 > parent.t1:
                break
            if s is not parent and s.t1 <= parent.t1 and (
                    not same_thread or s.thread == parent.thread):
                out.append(s)
        return out
