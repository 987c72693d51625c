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
   group amortizes the dispatch;
4. single or small queries whose candidate volume (min f_t for
   conjunctive, Σ f_t for ranked) reaches ``kernel_min_postings`` go to the
   device backend on a device-capable index, and to the kernel backend on
   any other doc-level index (Triangle or Expon growth: no device image,
   so the kernel backend decodes the postings on the host and runs the
   ``intersect``/``topk_score`` kernels on them);
5. when the lifecycle has published a static tier (``tiered_available``),
   remaining queries whose candidate volume stays under
   ``tiered_max_volume`` go to the tiered backend: the frozen docid prefix
   is served from the compressed image (bp128 skip tables for seek_GEQ)
   and only the post-freeze suffix touches the live chains — the volume
   gate bounds the decode penalty to the small-query regime;
6. everything else stays on the host, whose seek_GEQ skipping beats a
   device round trip on short chains.

The thresholds are static defaults: no crossover has been measured on a
GPU yet, so none is loaded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

from .types import POSITIONAL_MODES, Query, TermStats


@dataclass(frozen=True)
class PlannerConfig:
    """Thresholds for the routing rules (see module docstring)."""

    device_min_batch: int = 4        # batch size at which the device wins
    kernel_min_postings: int = 2048  # candidate volume at which kernels win
    tiered_max_volume: int = 2048    # volume ceiling for tiered routing
    allow_device: bool = True
    allow_tiered: bool = True


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
        docids the kernels do not model).  ``tiered_capable`` reports
        whether the tiered backend can run THIS query (positional modes
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
        if device and batch_size >= cfg.device_min_batch:
            return PlanDecision(
                "device", f"batch of {batch_size} amortizes device dispatch")
        fts = [s.ft for s in stats if s.ft > 0]
        if not fts:
            return PlanDecision("host", "no term statistics (empty terms)")
        volume = min(fts) if query.mode == "conjunctive" else sum(fts)
        if volume >= cfg.kernel_min_postings:
            if device:
                return PlanDecision(
                    "device", f"candidate volume {volume} favours the kernel")
            if kernel_capable:
                return PlanDecision(
                    "kernel", f"candidate volume {volume} favours kernels")
        if tiered and volume <= cfg.tiered_max_volume:
            return PlanDecision(
                "tiered", "static tier serves the frozen prefix compressed")
        return PlanDecision(
            "host", f"candidate volume {volume} favours cursor skipping")
