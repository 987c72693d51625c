"""Unified query engine: one planner/executor over the host, device,
kernel and tiered backends.

    eng = Engine(B=64, growth="const")          # device images on the card
    eng.add_document(["fast", "dynamic", "index"])
    res = eng.execute(Query(mode="conjunctive", terms=("fast", "index")))
    res.docids, res.scores, res.backend

  * :class:`~repro_torch.engine.backends.HostBackend` — the paper-faithful
    cursor/TAAT code in ``core/query.py`` (every mode, word-level too);
  * :class:`~repro_torch.engine.device_backend.DeviceBackend` — one launch
    of the fused decode→score→top-k op per (mode, k) group over a resident
    frozen collated image plus an incrementally refreshed delta, so device
    queries see every ingested document without re-running ``collate()``;
    ``DeviceBackend(use_fused=False)`` runs the split path instead (one
    ``query_step`` per image, the ``dvbyte_decode`` kernel as its decode);
  * :class:`~repro_torch.engine.backends.KernelBackend` — ``"kernel"``:
    on an index without device images (Triangle or Expon growth) it
    decodes postings on the host and runs the ``intersect`` and
    ``topk_score`` kernels; on a Const index, the fused path;
  * :class:`~repro_torch.engine.backends.TieredBackend` — the frozen docid
    prefix served from the compressed
    :class:`~repro_torch.core.static_index.StaticIndex` tier published by
    :class:`~repro_torch.core.lifecycle.FreezeManager` (background freeze,
    atomic swap), merged exactly with the post-freeze dynamic suffix.

Tiering and snapshots::

    eng = Engine(tier_policy=FreezePolicy(every_docs=10_000))
    eng.lifecycle.freeze()                  # or let the policy trigger it
    eng.snapshot("snaps/")                  # crash-atomic, core/persist.py
    eng2 = Engine.restore("snaps/")         # device images on the card

A :class:`~repro_torch.engine.planner.Planner` selects the backend per
query from term statistics and batch size, by static thresholds or a
measured :class:`~repro_torch.engine.planner.CrossoverTable`
(``PlannerConfig(crossover=...)``), with a forced-override knob
(``Engine(force_backend=...)`` or ``Query(backend=...)``).
"""

from ..core.lifecycle import (
    FreezeCoordinator,
    FreezeManager,
    FreezePolicy,
    StaticTier,
)
from .backends import (
    HostBackend,
    KernelBackend,
    TieredBackend,
    UnsupportedQueryError,
)
from .device_backend import DeviceBackend
from .engine import Engine
from .planner import CrossoverTable, PlanDecision, Planner, PlannerConfig
from .types import (
    MODES,
    POSITIONAL_MODES,
    CollectionStats,
    Query,
    QueryResult,
)

__all__ = [
    "Engine", "Query", "QueryResult", "Planner", "PlannerConfig",
    "CrossoverTable", "PlanDecision", "HostBackend", "DeviceBackend",
    "KernelBackend", "TieredBackend", "UnsupportedQueryError",
    "FreezeManager", "FreezePolicy", "StaticTier", "FreezeCoordinator",
    "CollectionStats", "MODES", "POSITIONAL_MODES",
]
