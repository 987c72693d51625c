"""Pipelined write path: bounded per-shard writer queues with the
immediate-access barrier at query fan-out.

The synchronous ingest path pays tokenization, routing, and the BlockStore
append on one thread per call.  This module splits an ingest into the three
stages the paper's ~2 GB/min claim presumes (and Asadi & Lin's pipelined
in-memory indexer makes explicit):

  1. **prepare** — tokenization/term-byte aggregation
     (:func:`~repro_torch.core.prepare.prepare_batch`): pure, runs on the
     SUBMITTING thread, never on a writer;
  2. **route** — global docid assignment + fleet statistics
     (:meth:`~repro_torch.core.sharded_index.ShardedEngine.route_batch`): cheap
     dict arithmetic, also on the submitting thread, so fleet counters keep
     exactly one writer;
  3. **append** — the per-shard batched BlockStore append
     (``Engine.add_documents``): each shard's bounded queue is drained by
     its own writer thread, so round-robin writers run independently and a
     fleet ingests at shard-parallel speed.

**The immediate-access barrier moves to query fan-out.**  ``submit``
returns docids immediately (assignment is deterministic arithmetic); the
paper's contract — a query sees every document submitted before it — is
enforced by whoever executes queries: capture :meth:`ticket` at query
submission and :meth:`wait` on it before fanning out
(``QueryService.flush`` does both).  A ticket is the per-shard
high-water-mark vector of submitted documents; ``wait`` blocks until every
shard's applied count reaches its mark.  Ingest throughput therefore never
pays a per-document visibility sync — only a query that actually arrives
pays, and only for documents submitted before it.

**Single-writer discipline.**  Each shard engine is written by exactly one
thread — its queue's drainer (the router never touches shard engines, and
each drain applies that shard's version bumps for the whole batch,
including the ``extra`` bumps for fleet documents the shard does not own).
The front door may touch engines directly (delete/update/collate) only
after :meth:`drain` — which is exactly what ``QueryService`` does.  The
queues are bounded: a submitter that outruns the writers blocks, so memory
stays flat under ingest storms.

**Writers touch host state only.**  A writer appends to its shard's host
index and bumps its version; it never touches the shard's device images.
Those refresh lazily on the thread that executes queries, after the drain
in ``QueryService.flush`` (``engine.device_backend.serve_groups``).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

from ..core.prepare import prepare_batch


@dataclass(frozen=True)
class IngestTicket:
    """Per-shard high-water marks (documents submitted up to a moment).

    ``marks[s]`` counts every fleet document routed through shard ``s``'s
    queue — sub-batch applies plus non-owned version bumps advance it by
    the full batch size, so all marks agree and any one of them is the
    total submitted-document count."""

    marks: tuple[int, ...]


class _ShardWriter:
    """One bounded queue + drainer thread for one shard engine."""

    def __init__(self, engine, max_queue: int):
        self.engine = engine
        self._q = queue.Queue(maxsize=max_queue)
        self._cv = threading.Condition()
        self._submitted = 0     # writer_only — the submitting front door
        self._completed = 0     # guarded_by: _cv
        self._error = None      # guarded_by: _cv
        self._thread = None

    def start(self) -> None:
        def drain():
            while True:
                item = self._q.get()
                if item is None:
                    return
                batch, extra = item
                n = len(batch) + extra
                try:
                    if batch:
                        self.engine.add_documents(batch)
                    if extra:
                        # fleet documents this shard does not own still move
                        # its scoring state (N, f_t, avgdl) — bump here, on
                        # the one thread that writes this engine's version
                        self.engine.version += extra
                except BaseException as exc:  # propagate to wait()/close()
                    with self._cv:
                        self._error = exc
                        self._cv.notify_all()
                    return
                with self._cv:
                    self._completed += n
                    self._cv.notify_all()
        self._thread = threading.Thread(
            target=drain, daemon=True, name="ingest-writer")
        self._thread.start()

    def submit(self, batch, extra: int) -> int:
        """Enqueue one (sub-batch, extra-bump) item; returns the new
        high-water mark.  Blocks when the bounded queue is full."""
        self._submitted += len(batch) + extra
        self._q.put((batch, extra))
        return self._submitted

    @property
    def mark(self) -> int:
        return self._submitted

    def wait(self, mark: int) -> None:
        """Block until ``mark`` documents have been applied (the barrier).
        Re-raises a writer-thread failure rather than hanging on it."""
        with self._cv:
            while self._completed < mark:
                if self._error is not None:
                    raise RuntimeError(
                        "ingest writer thread failed") from self._error
                self._cv.wait(timeout=0.5)
            if self._error is not None:
                raise RuntimeError(
                    "ingest writer thread failed") from self._error

    def stop(self) -> None:
        if self._thread is None:
            return
        self._q.put(None)
        self._thread.join()
        self._thread = None


class IngestPipeline:
    """Bounded, pipelined batch ingest over an ``Engine`` or
    ``ShardedEngine`` (anything with ``add_documents``; a fleet's
    ``route_batch`` unlocks per-shard parallelism).

    While a pipeline is attached, ALL ingest must flow through
    :meth:`submit` (docid assignment is pipeline-side for a single engine),
    and any direct engine mutation (delete/update/collate/snapshot) must be
    preceded by :meth:`drain` — ``QueryService`` enforces both.  Use as a
    context manager, or :meth:`close` explicitly; writers are daemon
    threads, so a leaked pipeline cannot wedge interpreter exit.

    ``max_queue`` bounds each shard queue in BATCH items: a submitter more
    than ``max_queue`` batches ahead of a writer blocks until the writer
    catches up (bounded memory under storms).
    """

    def __init__(self, engine, max_queue: int = 8):
        self.engine = engine
        self._route = getattr(engine, "route_batch", None)
        engines = getattr(engine, "engines", None) \
            if self._route is not None else None
        self._writers = [_ShardWriter(e, max_queue)
                         for e in (engines if engines is not None
                                   else [engine])]
        self._word = (engine.word_level if engines is not None
                      else engine.index.word_level)
        # single-engine docid assignment happens HERE (the writer applies
        # later); seeded from the engine, advanced per submit — valid
        # precisely while every ingest flows through the pipeline
        self._next_docid = (engine.num_docs if engines is not None
                            else engine.index.num_docs)  # writer_only
        for w in self._writers:
            w.start()

    # -- submit / barrier ------------------------------------------------

    def submit(self, docs) -> list[int]:
        """Stage 1+2 on the calling thread (tokenize, route, assign
        docids), enqueue stage 3 per shard; returns the assigned global
        docids immediately.  Submitting thread only (the front door)."""
        prepared = prepare_batch(docs, self._word)
        if self._route is not None:
            gids, per_shard, extra = self._route(prepared)
            for s, w in enumerate(self._writers):
                w.submit(per_shard[s], extra[s])
            return gids
        base = self._next_docid
        self._next_docid = base + len(prepared)
        self._writers[0].submit(prepared, 0)
        return list(range(base + 1, base + len(prepared) + 1))

    def ticket(self) -> IngestTicket:
        """The current per-shard high-water marks: a query submitted NOW
        must wait on exactly this ticket before it executes."""
        return IngestTicket(tuple(w.mark for w in self._writers))

    def wait(self, ticket: IngestTicket) -> None:
        """The immediate-access barrier: block until every shard has
        applied the documents submitted before ``ticket`` was taken."""
        for w, m in zip(self._writers, ticket.marks):
            w.wait(m)

    def drain(self) -> None:
        """Wait for everything submitted so far (= ``wait(ticket())``).
        After this returns — and until the next ``submit`` — no writer
        thread touches any engine, so the front door may mutate engines
        directly (delete/update/collate/snapshot)."""
        self.wait(self.ticket())

    def in_flight(self) -> bool:
        """True if any submitted batch has not been fully applied yet."""
        for w in self._writers:
            with w._cv:
                if w._completed < w._submitted:
                    return True
        return False

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Drain and stop the writer threads (idempotent)."""
        try:
            self.drain()
        finally:
            for w in self._writers:
                w.stop()

    def __enter__(self) -> "IngestPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["IngestPipeline", "IngestTicket"]
