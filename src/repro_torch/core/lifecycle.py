"""Tiered index lifecycle: dynamic → delta → static (Figure 2, closed loop).

The paper's triple goal includes "fast conversion of the dynamic index to a
'normal' static compressed inverted index", but a conversion nobody queries
is just a benchmark.  This module turns the
:class:`~repro_torch.core.static_index.StaticIndex` into a live serving
tier, following the production shape of Asadi & Lin (Fast, Incremental
Inverted Indexing, 2013): a write-optimized in-memory segment continuously
frozen into compressed read-optimized segments, with queries spanning
both — and, per Vigna's Quasi-Succinct Indices, the frozen tier kept in its
most compact codec.

Lifecycle of one freeze (driven by :class:`FreezeManager`):

  1. **policy trigger** — after an ingest, ``maybe_freeze`` compares the
     un-frozen suffix (docs/postings past the current tier horizon) against
     the :class:`FreezePolicy` thresholds;
  2. **snapshot** (caller thread, cheap) — ``Engine.collate_now()`` runs the
     §5.5 collation (which also refreezes the device image + delta
     baseline, so all tiers share one freeze point), then the collated
     index is ``clone()``-d: one memcpy, after which the background thread
     shares no mutable state with ingest;
  3. **convert** (background thread, expensive) — the clone is encoded into
     a :class:`StaticIndex` (bp128 or interp) while ingest and queries
     continue against the live index and the *previous* tier: there is no
     moment at which any document is unqueryable (zero availability gap);
  4. **swap** (atomic) — the finished tier is published as a single
     reference assignment of an immutable :class:`StaticTier`; the epoch
     counter bumps, invalidating the serving layer's query-result cache.

Exactness across tiers: docids are ordinal and each document's postings are
written before the next document starts, so docs ``<= tier.num_docs`` live
wholly in the static tier and later docs wholly in the dynamic suffix — the
same disjoint-docid-range argument :class:`~repro_torch.core.device_index.
DeltaBaseline` makes for the device path.  The engine's tiered backend
(``engine.backends.TieredBackend``) merges the two ranges and rebases
idf/BM25 statistics to the live collection, so results are byte-identical
to a host-backend evaluation of the full dynamic index.

Word-level engines follow the identical lifecycle: ``StaticIndex.freeze``
regroups each occurrence stream into docid/count/w-gap streams (§5.1's
⟨d,w⟩ form), and the same disjointness argument covers positions too —
a document's occurrences never straddle the horizon, so phrase queries
evaluated over chained static+dynamic positional cursors are exact.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from .static_index import StaticIndex


@dataclass(frozen=True)
class FreezePolicy:
    """When (and how) to freeze the dynamic prefix into the static tier.

    ``every_docs`` / ``every_postings``: freeze once the un-frozen suffix
    reaches that many documents / postings (either trigger suffices; None
    disables that trigger).  ``codec`` picks the static codec; ``background``
    runs the conversion on a freeze thread (the production mode — ``False``
    makes every freeze synchronous, which tests use for determinism).
    """

    every_docs: int | None = None
    every_postings: int | None = None
    codec: str = "bp128"
    background: bool = True


@dataclass(frozen=True)
class StaticTier:
    """An immutable published tier: the compressed image, its docid horizon
    (every docid <= num_docs is served from it), the freeze epoch, and the
    encode wall-clock.  Everything a reader learns about a freeze rides on
    this ONE object — the manager's ``epoch``/``freezes``/``last_freeze_s``
    are derived views, so the tier swap is a single reference assignment
    with no multi-field publication window."""

    index: StaticIndex
    num_docs: int
    num_postings: int
    epoch: int
    encode_s: float | None = None
    # tombstoned docids this tier's encode dropped (freeze-time compaction:
    # the tier is rebuilt anyway, so dead docids are excluded for free —
    # ``num_docs`` stays the docid HORIZON, which tombstoning never moves)
    compacted: int = 0


class FreezeCoordinator:
    """Fleet-wide freeze scheduling: at most ``max_in_flight`` concurrent
    static-tier encodes across every registered :class:`FreezeManager`.

    A fleet of independently-freezing shards can hit its policy thresholds
    simultaneously (round-robin ingest makes that the COMMON case — shards
    fill in lockstep) and pay N encode threads at once: N clones resident,
    N cores stolen from serving.  The coordinator turns that spike into a
    stagger: a manager asks for an encode slot before starting its
    background thread, and a refused manager queues FIFO and simply retries
    at a later ``maybe_freeze`` — deferral, not blocking, so the writer
    thread never stalls and the snapshot is taken when the slot is actually
    granted (a FRESHER horizon than at queue time, which is strictly
    better).  ``ShardedEngine`` pumps every queued manager on EVERY fleet
    ingest (the fleet shares one writer thread), so the queue head cannot
    wedge the FIFO by never receiving documents of its own; a fully idle
    fleet drains deferred freezes via ``drain_freezes``.

    Thread model: ``try_acquire`` runs on writer threads, ``release`` on
    encode threads, both under one condition variable.  ``acquire`` (the
    blocking variant, used by synchronous freezes) jumps the FIFO — it
    holds the caller's writer thread, so making it wait for queued
    background work could stall ingest indefinitely; the budget invariant
    (never more than ``max_in_flight`` encodes alive) still holds.

    Observability: ``in_flight`` (current), ``peak_in_flight`` (high-water
    mark — the bench's staggered-vs-simultaneous headline), ``epoch`` (sum
    of all managers' epochs — a composite, monotone tier-swap counter that
    serving caches key on).
    """

    def __init__(self, max_in_flight: int = 1):
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got "
                             f"{max_in_flight}")
        self.max_in_flight = max_in_flight
        self.managers: list[FreezeManager] = []
        self._cond = threading.Condition()
        self._in_flight = 0                             # guarded_by: _cond
        self._waiters: deque[FreezeManager] = deque()   # guarded_by: _cond
        self.peak_in_flight = 0                         # guarded_by: _cond
        # refused try_acquires (queue pressure)
        self.deferrals = 0                              # guarded_by: _cond

    def register(self, manager: "FreezeManager") -> "FreezeManager":
        """Adopt a manager: its background freezes now need an encode slot."""
        manager.coordinator = self
        self.managers.append(manager)
        return manager

    # -- slot accounting ---------------------------------------------------

    def _grant(self) -> None:       # requires: _cond
        self._in_flight += 1
        self.peak_in_flight = max(self.peak_in_flight, self._in_flight)

    def try_acquire(self, manager: "FreezeManager") -> bool:
        """Non-blocking slot request (writer thread).  FIFO-fair: a refused
        manager is queued and nobody may overtake it while slots are
        contended."""
        with self._cond:
            if manager not in self._waiters:
                self._waiters.append(manager)
            if (self._in_flight < self.max_in_flight
                    and self._waiters[0] is manager):
                self._waiters.popleft()
                self._grant()
                return True
            self.deferrals += 1
            return False

    def acquire(self, manager: "FreezeManager") -> None:
        """Blocking slot request (synchronous freezes).  Jumps the FIFO —
        see class docstring — but still counts against ``max_in_flight``."""
        with self._cond:
            if manager in self._waiters:
                self._waiters.remove(manager)
            while self._in_flight >= self.max_in_flight:
                self._cond.wait()
            self._grant()

    def release(self, manager: "FreezeManager") -> None:
        with self._cond:
            self._in_flight -= 1
            self._cond.notify_all()

    # -- observability -----------------------------------------------------

    @property
    def in_flight(self) -> int:
        with self._cond:
            return self._in_flight

    @property
    def pending(self) -> int:
        """Managers queued for a slot (deferred freezes)."""
        with self._cond:
            return len(self._waiters)

    @property
    def epoch(self) -> int:
        """Composite tier epoch: sum of every manager's epoch.  Monotone
        (epochs only grow), and it changes whenever ANY shard swaps its
        tier — exactly the invalidation granularity a fleet-level
        query-result cache needs."""
        return sum(m.epoch for m in self.managers)

    @property
    def freezes(self) -> int:
        return sum(m.freezes for m in self.managers)

    def wait(self) -> None:
        """Join every in-flight encode (tests / shutdown).  Queued-but-
        deferred freezes are NOT started here — drive those through the
        owning engines' ``maybe_freeze`` (see ``ShardedEngine.drain_freezes``)."""
        for m in self.managers:
            m.wait()


class FreezeManager:
    """Owns the static tier of one engine: policy, background freeze, swap.

    Thread model: ``maybe_freeze``/``freeze`` run on the engine's single
    writer thread; the conversion runs on at most one background thread at a
    time, touching only its private clone; ``tier`` is swapped by a single
    reference assignment (readers grab the reference once per query, so a
    mid-query swap is invisible).  A freeze request while one is in flight
    is a no-op — the next ``maybe_freeze`` re-evaluates the policy against
    the new horizon.

    When a :class:`FreezeCoordinator` has adopted this manager (fleet
    serving), every encode additionally needs a slot from it: background
    freezes defer (return False, retried at the next ``maybe_freeze``)
    while the fleet is at its encode budget; blocking freezes wait.
    """

    def __init__(self, engine, policy: FreezePolicy | None = None):
        self.engine = engine
        self.policy = policy or FreezePolicy()
        self.tier: StaticTier | None = None             # published
        self._thread: threading.Thread | None = None    # writer_only
        self.coordinator: FreezeCoordinator | None = None

    # -- observability ----------------------------------------------------

    @property
    def epoch(self) -> int:
        """Freeze epoch of the published tier (0 before the first swap).
        Derived from the single published ``tier`` reference — one load, so
        ``epoch``/``freezes``/the horizon can never be observed mutually
        inconsistent the way separate counter fields could."""
        tier = self.tier
        return tier.epoch if tier is not None else 0

    @property
    def freezes(self) -> int:
        """Completed freezes == the published epoch (each freeze bumps the
        epoch by exactly one, starting from zero)."""
        return self.epoch

    @property
    def last_freeze_s(self) -> float | None:
        """Encode wall-clock of the most recent freeze (rides on the tier)."""
        tier = self.tier
        return tier.encode_s if tier is not None else None

    @property
    def tombstones_compacted(self) -> int:
        """Dead docids the PUBLISHED tier's encode dropped (rides on the
        tier reference like every other freeze observable — tombstones only
        grow, so this is monotone across swaps)."""
        tier = self.tier
        return tier.compacted if tier is not None else 0

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Join an in-flight background conversion (tests / shutdown)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def quiesce(self) -> None:
        """Snapshot barrier (``core/persist.py``): join any in-flight
        background encode so a subsequent ``Engine.snapshot`` captures the
        newest tier.  Optional — a snapshot is consistent WITHOUT it (the
        persist path reads the published ``tier`` reference exactly once,
        and the tiered merge is exact at any horizon); quiescing only moves
        the persisted horizon forward.  Writer thread only, like every
        freeze entry point."""
        self.wait()

    def suffix_size(self) -> tuple[int, int]:
        """(docs, postings) ingested past the current tier horizon."""
        idx = self.engine.index
        tier = self.tier        # snapshot ONCE: a background swap between
        if tier is None:        # loads would mix two horizons (torn read)
            return idx.num_docs, idx.num_postings
        return (idx.num_docs - tier.num_docs,
                idx.num_postings - tier.num_postings)

    # -- the lifecycle -----------------------------------------------------

    def maybe_freeze(self) -> bool:
        """Policy check after an ingest; starts a freeze when due (and, under
        a coordinator, when the fleet encode budget grants a slot — a
        refused attempt is simply retried on the next ingest)."""
        if self.in_flight:
            return False
        pol = self.policy
        docs, postings = self.suffix_size()
        due = ((pol.every_docs is not None and docs >= pol.every_docs)
               or (pol.every_postings is not None
                   and postings >= pol.every_postings))
        if not due or docs == 0:
            return False
        return self.freeze(blocking=not pol.background)

    def freeze(self, blocking: bool = False) -> bool:
        """Snapshot now, convert (in background unless ``blocking``), swap.

        Returns False if a freeze is already in flight, or if a coordinator
        refused the encode slot (background mode only — the freeze stays
        queued and a later ``maybe_freeze`` retries).  The caller thread
        pays for ``collate_now`` (the §5.5 copy plus, on device-capable
        layouts, the device-image snapshot it has always implied) and one
        ``clone()`` memcpy — the expensive static re-encode runs off-thread;
        queries keep being served from the previous tier + dynamic suffix
        until the swap.
        """
        if self.in_flight:
            if not blocking:
                return False
            self.wait()
        coord = self.coordinator
        if coord is not None:
            # the slot covers snapshot + encode: the clone a freeze keeps
            # resident is part of the budget the coordinator meters
            if blocking:
                coord.acquire(self)
            elif not coord.try_acquire(self):
                return False
        eng = self.engine
        # from here to the handoff, the slot must not leak: if the snapshot
        # (collate/clone) raises, work() — whose finally owns the release —
        # never runs, and a leaked slot would wedge the whole fleet's
        # freeze budget permanently
        handed_off = False
        try:
            eng.collate_now()       # shared freeze point with the device tier
            snapshot = eng.index.clone()
            epoch = self.epoch + 1
            t0 = time.perf_counter()

            def work():
                try:
                    static = StaticIndex.freeze(snapshot, self.policy.codec)
                    static.epoch = epoch
                    tier = StaticTier(index=static,
                                      num_docs=snapshot.num_docs,
                                      num_postings=snapshot.num_postings,
                                      epoch=epoch,
                                      encode_s=time.perf_counter() - t0,
                                      compacted=len(snapshot.tombstones))
                    # atomic publish: ONE reference assignment of an
                    # immutable payload — epoch/freezes/last_freeze_s are
                    # all derived views of this reference, so there is no
                    # window where a reader sees them inconsistent
                    self.tier = tier
                finally:
                    if coord is not None:
                        coord.release(self)

            if blocking:
                handed_off = True   # work()'s finally releases, even raising
                work()
            else:
                self._thread = threading.Thread(target=work, daemon=True,
                                                name=f"freeze-epoch-{epoch}")
                self._thread.start()
                handed_off = True
        except BaseException:
            if coord is not None and not handed_off:
                coord.release(self)
            raise
        return True


__all__ = ["FreezePolicy", "StaticTier", "FreezeManager",
           "FreezeCoordinator"]
