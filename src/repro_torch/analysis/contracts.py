"""Runtime contract wrapper for the cursor protocol.

:class:`ContractCursor` wraps any cursor implementation and asserts, on
every call, the behavioral half of the protocol the static pass
(:mod:`repro_torch.analysis.protocol`) can only check structurally:

* ``next`` never moves ``docid`` backwards (strictly forward for doc-level
  cursors; word-level occurrence streams may repeat a docid across
  occurrences, so equality is allowed with ``strict=False``);
* ``seek_geq(target)`` lands on ``docid >= target`` or exhausts, never
  moves backwards, and never lands strictly between the pre-call position
  and ``target`` (the postcondition the chained tiered cursors rely on);
* ``positions()`` returns strictly increasing positive word positions;
* no ``next``/``seek_geq`` after exhaustion.

The differential tests wrap every implementation (dynamic, static, both
codecs, chained) in this class, so a protocol regression fails loudly at
the violating call instead of surfacing as a wrong result set downstream.
"""

from __future__ import annotations


class ContractViolation(AssertionError):
    """A cursor broke the protocol contract at runtime."""


class ContractCursor:
    """Transparent contract-checking proxy around a cursor.

    ``strict=True`` additionally requires strictly increasing docids from
    ``next`` (doc-level cursors); word-level occurrence cursors keep the
    default non-decreasing contract.
    """

    def __init__(self, inner, *, strict: bool = False, label: str = ""):
        self.inner = inner
        self.strict = strict
        self.label = label or type(inner).__name__
        self.calls = 0

    # -- delegated state ---------------------------------------------------

    @property
    def docid(self):
        return self.inner.docid

    @property
    def payload(self):
        return self.inner.payload

    @property
    def exhausted(self):
        return self.inner.exhausted

    def _fail(self, msg: str) -> None:
        raise ContractViolation(f"[{self.label}] {msg}")

    def _snapshot(self):
        return None if self.inner.exhausted else self.inner.docid

    # -- checked protocol --------------------------------------------------

    def next(self):
        before = self._snapshot()
        if before is None:
            self._fail("next() called on an exhausted cursor")
        out = self.inner.next()
        self.calls += 1
        if not self.inner.exhausted:
            d = self.inner.docid
            if d < before:
                self._fail(f"next() moved docid backwards: "
                           f"{before} -> {d}")
            if self.strict and d == before:
                self._fail(f"next() repeated docid {d} on a "
                           f"doc-level cursor")
        return out

    def seek_geq(self, target):
        before = self._snapshot()
        out = self.inner.seek_geq(target)
        self.calls += 1
        if not self.inner.exhausted:
            d = self.inner.docid
            if d < target:
                self._fail(f"seek_geq({target}) landed on docid {d} "
                           f"< target (postcondition: exhausted or "
                           f"docid >= target)")
            if before is not None and d < before:
                self._fail(f"seek_geq({target}) moved docid backwards: "
                           f"{before} -> {d}")
        elif before is not None and before >= target:
            self._fail(f"seek_geq({target}) exhausted a cursor already "
                       f"positioned at docid {before} >= target")
        return out

    def positions(self):
        pos = self.inner.positions()
        seq = list(pos)
        if any(p <= 0 for p in seq):
            self._fail(f"positions() returned a non-positive word "
                       f"position: {seq}")
        if any(b <= a for a, b in zip(seq, seq[1:])):
            self._fail(f"positions() not strictly increasing: {seq}")
        return pos

    def __getattr__(self, name):
        return getattr(self.inner, name)


def wrap(cursor, *, strict: bool = False, label: str = ""):
    """Wrap ``cursor`` unless it already is a :class:`ContractCursor`."""
    if isinstance(cursor, ContractCursor):
        return cursor
    return ContractCursor(cursor, strict=strict, label=label)


__all__ = ["ContractCursor", "ContractViolation", "wrap"]
