"""Runtime concurrency sanitizer: instrumented locks + lightweight races.

Two detectors, both deterministic (no timing dependence):

* **Lock-order inversions** — every instrumented lock acquisition records
  ``held -> acquired`` edges in a global acquisition graph; an edge that
  closes a cycle is a potential deadlock and is reported immediately, even
  if the schedules never actually overlapped (the classic lock-order
  discipline: cycles are bugs whether or not they deadlocked today).

* **Field races (Eraser-style lockset)** — :meth:`Sanitizer.shadow`
  intercepts chosen attributes of an object and refines, per field, the
  set of instrumented locks held on *every* access once a second live
  thread touches it.  A write with an empty candidate lockset is reported
  as a write/write or write/read race.  A thread that terminated before
  the next access happens-before it (its writes are visible after
  ``join``), so post-``join`` reads do not false-positive.

Enablement: ``Sanitizer.enable()`` monkeypatches ``threading.Lock`` /
``RLock`` / ``Condition`` so locks created by ``repro_torch``/test modules
are instrumented while stdlib internals (queues, thread pools) keep the
real primitives.  The tests opt in via ``pytest --sanitize`` or
``REPRO_SANITIZE=1`` (``tests/conftest.py``, whose sanitizer's caller
filter matches ``repro_torch`` too).  ``# published`` and
``# writer_only`` fields (see :mod:`repro_torch.analysis.annotations`) are
deliberately lock-free and must NOT be shadowed — shadow the fields whose
protection is a lock.

What a run on the card relies on (``chip_smoke.py``'s sanitized fleet):

* a lock is instrumented only if it is created AFTER ``enable()``, by a
  module whose name starts with ``repro_torch``, ``tests`` or ``test_``,
  or by ``conftest``.  Build the engines after ``enable()``;
* locks made at import are real ones: ``kernels/build.py``'s
  ``_LOAD_LOCK`` is created when the module is first imported, which a
  script does before it enables the sanitizer;
* locks made by a script run as ``__main__`` are real too, so a script
  makes the locks it wants checked through :meth:`Sanitizer.lock`.
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass, field

from .report import Finding

CHECK = "sanitizer"

_REAL = {
    "Lock": threading.Lock,
    "RLock": threading.RLock,
    "Condition": threading.Condition,
}

ENV_FLAG = "REPRO_SANITIZE"


def _callsite(skip_module: str) -> str:
    f = sys._getframe(2)
    while f is not None and f.f_globals.get("__name__") == skip_module:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


class _SanLock:
    """Instrumented non-reentrant/reentrant lock reporting to a Sanitizer."""

    def __init__(self, san: "Sanitizer", raw, label: str,
                 reentrant: bool = False):
        self._san = san
        self._raw = raw
        self.label = label
        self._reentrant = reentrant
        self._owner: int | None = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            ok = self._raw.acquire(blocking, timeout)
            if ok:
                self._count += 1
            return ok
        self._san._before_acquire(self)
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            self._san._on_acquired(self)
            if self._reentrant:
                self._owner, self._count = me, 1
        return ok

    def release(self) -> None:
        if self._reentrant and self._owner == threading.get_ident():
            self._count -= 1
            if self._count > 0:
                self._raw.release()
                return
            self._owner = None
        self._raw.release()
        self._san._on_release(self)

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<SanLock {self.label}>"


@dataclass
class _FieldState:
    owner: threading.Thread
    shared: bool = False
    lockset: set[int] = field(default_factory=set)
    written_shared: bool = False
    reported: bool = False


class Sanitizer:
    """One sanitizer instance: its own lock registry, graph, and findings."""

    def __init__(self, name: str = "sanitizer"):
        self.name = name
        self.findings: list[Finding] = []
        self._mu = _REAL["Lock"]()
        self._graph: dict[int, set[int]] = {}
        self._labels: dict[int, str] = {}
        self._reported_cycles: set[frozenset] = set()
        self._held = threading.local()
        self._fields: dict[tuple[int, str], _FieldState] = {}
        self._field_labels: dict[tuple[int, str], str] = {}
        self._shadow_cache: dict[tuple, type] = {}
        self._enabled = False

    # ------------------------------------------------------------------
    # lock construction
    # ------------------------------------------------------------------

    def lock(self, label: str | None = None) -> _SanLock:
        lk = _SanLock(self, _REAL["Lock"](),
                      label or _callsite(__name__))
        self._labels[id(lk)] = lk.label
        return lk

    def rlock(self, label: str | None = None) -> _SanLock:
        lk = _SanLock(self, _REAL["RLock"](),
                      label or _callsite(__name__), reentrant=True)
        self._labels[id(lk)] = lk.label
        return lk

    def condition(self, label: str | None = None):
        """A real Condition over an instrumented (non-reentrant) lock:
        ``with``/``wait``/``notify`` all route through the hooks."""
        return _REAL["Condition"](self.lock(label))

    # ------------------------------------------------------------------
    # lock-order graph
    # ------------------------------------------------------------------

    def _held_list(self) -> list:
        if not hasattr(self._held, "locks"):
            self._held.locks = []
        return self._held.locks

    def _before_acquire(self, lock: _SanLock) -> None:
        held = self._held_list()
        if any(h is lock for h in held):
            return                  # owned-probe / re-acquire, not an edge
        if not held:
            return
        nid = id(lock)
        with self._mu:
            for h in held:
                hid = id(h)
                self._graph.setdefault(hid, set()).add(nid)
                cycle = self._find_path(nid, hid)
                if cycle is not None:
                    key = frozenset([hid, nid])
                    if key not in self._reported_cycles:
                        self._reported_cycles.add(key)
                        names = " -> ".join(
                            self._labels.get(x, "?") for x in cycle + [nid])
                        self.findings.append(Finding(
                            CHECK, _callsite(__name__).split(":")[0], 0,
                            f"lock-order.{h.label}~{lock.label}",
                            f"lock-order inversion: acquiring "
                            f"'{lock.label}' while holding '{h.label}' "
                            f"closes the cycle {names} (thread "
                            f"{threading.current_thread().name}, at "
                            f"{_callsite(__name__)})"))

    def _find_path(self, src: int, dst: int) -> list[int] | None:
        """DFS path src -> dst in the acquisition graph (ids)."""
        stack = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self._graph.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def _on_acquired(self, lock: _SanLock) -> None:
        self._held_list().append(lock)

    def _on_release(self, lock: _SanLock) -> None:
        held = self._held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                break

    # ------------------------------------------------------------------
    # field race detection (Eraser lockset)
    # ------------------------------------------------------------------

    def shadow(self, obj, *fields: str, label: str | None = None):
        """Intercept ``fields`` of ``obj`` (in place) for race detection."""
        cls = obj.__class__
        key = (cls, tuple(sorted(fields)))
        shadow_cls = self._shadow_cache.get(key)
        if shadow_cls is None:
            ns = {"__san_shadowed__": True}
            for f in fields:
                ns[f] = self._make_property(f)
            shadow_cls = type(f"Sanitized{cls.__name__}", (cls,), ns)
            self._shadow_cache[key] = shadow_cls
        base = label or type(obj).__name__
        for f in fields:
            slot = f"_san_{f}"
            if f in obj.__dict__:
                obj.__dict__[slot] = obj.__dict__.pop(f)
            self._field_labels[(id(obj), f)] = f"{base}.{f}"
        obj.__class__ = shadow_cls
        return obj

    def _make_property(self, fname: str):
        slot = f"_san_{fname}"
        san = self

        def getter(obj):
            san._on_field_access(obj, fname, is_write=False)
            try:
                return obj.__dict__[slot]
            except KeyError:
                raise AttributeError(fname) from None

        def setter(obj, value):
            san._on_field_access(obj, fname, is_write=True)
            obj.__dict__[slot] = value

        return property(getter, setter)

    def _on_field_access(self, obj, fname: str, is_write: bool) -> None:
        key = (id(obj), fname)
        me = threading.current_thread()
        held = {id(lk) for lk in self._held_list()}
        with self._mu:
            st = self._fields.get(key)
            if st is None:
                self._fields[key] = _FieldState(owner=me)
                return
            if not st.shared:
                if st.owner is me:
                    return
                if not st.owner.is_alive():
                    # the previous owner terminated before this access:
                    # termination happens-before, ownership transfers
                    st.owner = me
                    return
                st.shared = True
                st.lockset = set(held)
                st.written_shared = is_write
            else:
                st.lockset &= held
                st.written_shared |= is_write
            if st.written_shared and not st.lockset and not st.reported:
                st.reported = True
                lbl = self._field_labels.get(key, fname)
                kind = "write" if is_write else "read"
                self.findings.append(Finding(
                    CHECK, _callsite(__name__).split(":")[0], 0,
                    f"race.{lbl}",
                    f"data race on {lbl}: {kind} by thread '{me.name}' "
                    f"with empty candidate lockset — concurrent threads "
                    f"access this field with no common lock (at "
                    f"{_callsite(__name__)})"))

    # ------------------------------------------------------------------
    # threading patch (env-flag / --sanitize enablement)
    # ------------------------------------------------------------------

    def _instrument_caller(self) -> bool:
        mod = sys._getframe(2).f_globals.get("__name__", "")
        return (mod.startswith("repro_torch") or mod.startswith("tests")
                or mod.startswith("test_") or mod == "conftest")

    def enable(self) -> "Sanitizer":
        """Patch ``threading.Lock/RLock/Condition`` so locks created by
        repro_torch/test code are instrumented; stdlib callers get the real
        primitives.  Idempotent; pair with :meth:`disable`."""
        if self._enabled:
            return self
        san = self

        def make_lock(*a, **kw):
            if san._instrument_caller():
                return san.lock(label=_callsite(__name__))
            return _REAL["Lock"](*a, **kw)

        def make_rlock(*a, **kw):
            if san._instrument_caller():
                return san.rlock(label=_callsite(__name__))
            return _REAL["RLock"](*a, **kw)

        def make_condition(lock=None, *a, **kw):
            if lock is None and san._instrument_caller():
                return san.condition(label=_callsite(__name__))
            return _REAL["Condition"](lock, *a, **kw)

        threading.Lock = make_lock
        threading.RLock = make_rlock
        threading.Condition = make_condition
        self._enabled = True
        return self

    def disable(self) -> None:
        if not self._enabled:
            return
        threading.Lock = _REAL["Lock"]
        threading.RLock = _REAL["RLock"]
        threading.Condition = _REAL["Condition"]
        self._enabled = False

    def __enter__(self) -> "Sanitizer":
        return self.enable()

    def __exit__(self, *exc) -> None:
        self.disable()

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    def report(self) -> str:
        if not self.findings:
            return f"{self.name}: clean"
        return "\n".join(str(f) for f in self.findings)


def env_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


__all__ = ["Sanitizer", "CHECK", "ENV_FLAG", "env_enabled"]
