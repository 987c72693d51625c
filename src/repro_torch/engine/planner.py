"""Backend selection: route each query by cheap observables.

The planner is a pure function of per-term f_t (the engine's O(1)
counters), the query batch size and the index shape, so planning never
rivals execution.  Rules, in priority order:

1. a forced override (``Query.backend`` or ``Engine(force_backend=...)``)
   wins unconditionally and raises if the backend cannot run the query:
   ``device`` needs a device-capable index (Const growth, doc-level),
   ``kernel`` a doc-level one, and neither serves positional modes;
2. positional modes (phrase / proximity / bm25_prox) need word positions:
   they go to the tiered backend when a static tier is published
   (positions served from the compressed ⟨d,w⟩ image) and to the host
   otherwise;
3. on a device-capable index, batches of ``device_min_batch`` or more
   queries go to the device backend: one fused kernel launch per (mode, k)
   group amortizes the dispatch.  When the config carries a measured
   :class:`CrossoverTable` and the query's mode was swept, the table
   decides instead: the device backend from the smallest batch at which
   it beat the host, then the kernel backend (``allow_kernel``) from its
   own; a backend that never won is never batch-routed to, and
   ``device_min_batch`` does not apply to that mode;
4. single or small queries whose candidate volume (min f_t for
   conjunctive, Σ f_t for ranked) reaches ``kernel_min_postings`` leave the
   host when ``allow_kernel`` is set: to the device backend on a
   device-capable index (where the reference says ``"pallas"``: on such an
   index both backends make the same single ``fused_query`` launch), and
   to the kernel backend on any other doc-level index (Triangle or Expon
   growth: no device image, so the kernel backend decodes the postings on
   the host and runs the ``intersect``/``topk_score`` kernels on them);
5. when the lifecycle has published a static tier (``tiered_available``),
   remaining queries whose candidate volume stays under
   ``tiered_max_volume`` go to the tiered backend: the frozen docid prefix
   is served from the compressed image (bp128 skip tables for seek_GEQ)
   and only the post-freeze suffix touches the live chains — the volume
   gate bounds the decode penalty to the small-query regime;
6. everything else stays on the host, whose seek_GEQ skipping beats a
   device round trip on short chains.

Without a table the thresholds are static defaults.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import NamedTuple

from .types import POSITIONAL_MODES, Query, TermStats


@dataclass(frozen=True)
class CrossoverTable:
    """Measured routing crossovers, derived from a benchmark sweep.

    ``min_batch[mode][backend]`` is the smallest swept batch size at which
    ``backend`` (``"device"`` or ``"kernel"``) beat the host's steady-state
    µs per query at EVERY swept collection size of that workload, or None
    when it never did: a backend must win across sizes before the planner
    prefers it.
    """

    min_batch: dict = field(default_factory=dict)

    @classmethod
    def from_rows(cls, rows) -> "CrossoverTable":
        """Derive the table from sweep rows: dicts with ``workload``,
        ``backend``, ``size``, ``batch`` and ``us_per_query``
        (steady-state); other keys are ignored.  Batches are tried in
        ascending order, and a row without a host row of the same
        workload, batch and size never wins."""
        cells: dict[tuple, dict[str, float]] = {}
        for r in rows:
            key = (r["workload"], int(r["batch"]), int(r["size"]))
            cells.setdefault(key, {})[r["backend"]] = float(r["us_per_query"])
        modes = sorted({k[0] for k in cells})
        batches = sorted({k[1] for k in cells})
        table: dict[str, dict[str, int | None]] = {}
        for mode in modes:
            table[mode] = {}
            for backend in ("device", "kernel"):
                win = None
                for b in batches:
                    group = [v for k, v in cells.items()
                             if k[0] == mode and k[1] == b]
                    if group and all(backend in v and "host" in v
                                     and v[backend] < v["host"]
                                     for v in group):
                        win = b
                        break
                table[mode][backend] = win
        return cls(min_batch=table)

    @classmethod
    def from_bench(cls, path: str) -> "CrossoverTable":
        """Re-derive the table from the rows a benchmark recorded under
        ``payload["crossover"]["rows"]`` of the JSON file at ``path``.

        ``path`` has no default: the one file of that layout in this
        repository, ``BENCH_engine.json``, holds the JAX package's sweep
        on a CPU in interpret mode, whose backends are ``"host"``,
        ``"device"`` and ``"pallas"``; a table routing this port must come
        from a sweep of the port on the card."""
        with open(path) as fh:
            payload = json.load(fh)
        return cls.from_rows(payload["crossover"]["rows"])

    def min_batch_for(self, mode: str, backend: str) -> int | None:
        """Measured least winning batch for (mode, backend); None when the
        backend never won or the mode was not swept."""
        per_mode = self.min_batch.get(mode)
        if per_mode is None:
            return None
        return per_mode.get(backend)

    @property
    def swept_modes(self) -> tuple[str, ...]:
        return tuple(self.min_batch)


@dataclass(frozen=True)
class PlannerConfig:
    """Thresholds for the routing rules (see module docstring).

    With ``crossover`` set, rule 3 routes each swept mode by the table's
    measured thresholds in place of ``device_min_batch``; modes the sweep
    never measured keep the static rule.  ``allow_kernel`` False closes
    rule 3's kernel route and rule 4, whichever backend it names, as the
    reference's ``allow_pallas`` does.
    """

    device_min_batch: int = 4        # batch size at which the device wins
    kernel_min_postings: int = 2048  # candidate volume at which kernels win
    tiered_max_volume: int = 2048    # volume ceiling for tiered routing
    allow_device: bool = True
    allow_kernel: bool = True
    allow_tiered: bool = True
    crossover: CrossoverTable | None = None  # measured thresholds


class PlanDecision(NamedTuple):
    backend: str
    reason: str


class Planner:
    def __init__(self, config: PlannerConfig | None = None,
                 force_backend: str | None = None):
        self.config = config or PlannerConfig()
        self.force_backend = force_backend

    def plan(self, query: Query, batch_size: int, stats: list[TermStats],
             *, device_capable: bool, kernel_capable: bool = False,
             tiered_available: bool = False,
             tiered_capable: bool = True) -> PlanDecision:
        """Pick a backend for ``query`` arriving in a batch of
        ``batch_size``; ``stats`` aligns with ``query.terms``.
        ``device_capable`` reports whether the index layout supports device
        images (Const-mode, doc-level), ``kernel_capable`` whether the
        kernel backend applies (doc-level, any growth: it decodes postings
        on the host, and word-level lists carry w-gap payloads and repeated
        docids the kernels do not model); a device-capable index is also
        kernel-capable, and rules 3 and 4 ask both.  ``tiered_capable``
        reports whether the tiered backend can run THIS query (positional modes
        need a word-level index), ``tiered_available`` whether a static
        tier is published — routing prefers it over the host only then,
        since with no tier it is the host path with extra indirection."""
        cfg = self.config
        forced = query.backend or self.force_backend
        if forced is not None:
            capable = {"device": device_capable, "kernel": kernel_capable,
                       "tiered": tiered_capable}.get(forced, True)
            if forced in ("device", "kernel", "tiered") and (
                    not capable or (query.mode in POSITIONAL_MODES
                                    and forced != "tiered")):
                raise ValueError(
                    f"backend {forced!r} forced, but {query.mode!r} queries "
                    "on this index layout do not support it")
            return PlanDecision(forced, "forced override")
        tiered = cfg.allow_tiered and tiered_capable and tiered_available
        if query.mode in POSITIONAL_MODES:
            if tiered:
                return PlanDecision(
                    "tiered",
                    f"{query.mode} served from the compressed ⟨d,w⟩ tier")
            return PlanDecision("host",
                                f"{query.mode} requires word positions")
        device = cfg.allow_device and device_capable
        table = cfg.crossover
        swept = table is not None and query.mode in table.swept_modes
        if device:
            if swept:
                mb = table.min_batch_for(query.mode, "device")
                if mb is not None and batch_size >= mb:
                    return PlanDecision(
                        "device", f"measured crossover: device wins "
                                  f"{query.mode} at batch >= {mb}")
            elif batch_size >= cfg.device_min_batch:
                return PlanDecision(
                    "device",
                    f"batch of {batch_size} amortizes device dispatch")
        kernel = cfg.allow_kernel and kernel_capable
        if kernel and device_capable and swept:
            mb = table.min_batch_for(query.mode, "kernel")
            if mb is not None and batch_size >= mb:
                return PlanDecision(
                    "kernel", f"measured crossover: the kernel backend "
                              f"wins {query.mode} at batch >= {mb}")
        fts = [s.ft for s in stats if s.ft > 0]
        if not fts:
            return PlanDecision("host", "no term statistics (empty terms)")
        volume = min(fts) if query.mode == "conjunctive" else sum(fts)
        if kernel and volume >= cfg.kernel_min_postings:
            if device:
                return PlanDecision(
                    "device", f"candidate volume {volume} favours the kernel")
            return PlanDecision(
                "kernel", f"candidate volume {volume} favours kernels")
        if tiered and volume <= cfg.tiered_max_volume:
            return PlanDecision(
                "tiered", "static tier serves the frozen prefix compressed")
        return PlanDecision(
            "host", f"candidate volume {volume} favours cursor skipping")
