"""Engine query/result types shared by the planner and every backend."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: Query modes every backend must agree on (identical results up to float
#: tolerance — enforced by the differential test matrix in tests/test_engine.py).
MODES = ("conjunctive", "ranked_tfidf", "bm25", "phrase", "proximity",
         "bm25_prox")

#: Modes that consume word positions: they require a word-level index and
#: run only on the host backend — forcing them onto the device backend
#: raises.
POSITIONAL_MODES = ("phrase", "proximity", "bm25_prox")

#: Backends a query may force via ``Query.backend``.
BACKENDS = ("host", "device", "kernel")


@dataclass(frozen=True)
class Query:
    """One term-based query.

    ``mode`` is one of :data:`MODES`; ``k`` bounds ranked result size
    (ignored for boolean modes); ``window`` is the proximity span in words
    (required for ``mode="proximity"``, disallowed elsewhere — keeping it
    out of non-proximity queries means equal queries stay equal, which the
    serving layer's result-cache key relies on); ``backend`` forces a
    specific backend for this query, overriding the planner (raises if that
    backend cannot run the query, rather than silently falling back).
    """

    terms: tuple[str, ...]
    mode: str = "conjunctive"
    k: int = 10
    window: int | None = None
    backend: str | None = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown query mode {self.mode!r}; "
                             f"expected one of {MODES}")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        if self.k < 1:
            # k=0 slices diverge across backends (nz[-0:] keeps everything
            # host-side, top_k keeps nothing) — reject rather than diverge
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.mode == "proximity":
            if self.window is None or self.window < 1:
                raise ValueError("proximity queries need window >= 1, got "
                                 f"{self.window!r}")
        elif self.window is not None:
            raise ValueError(
                f"window only applies to proximity queries, not {self.mode!r}")
        object.__setattr__(self, "terms", tuple(self.terms))


@dataclass
class QueryResult:
    """Backend-independent result: docids ascending for boolean modes,
    descending-score order for ranked modes (``scores`` is None for boolean
    modes).  ``backend``/``reason`` record the planner's routing decision for
    introspection and benchmarks."""

    docids: np.ndarray
    scores: np.ndarray | None = None
    backend: str = "host"
    reason: str = ""

    def __len__(self) -> int:
        return len(self.docids)

    @classmethod
    def empty(cls, mode: str, backend: str) -> "QueryResult":
        """No match: empty docids, and empty scores for a ranked mode."""
        return cls(np.zeros(0, np.int64),
                   None if mode == "conjunctive" else np.zeros(0, np.float64),
                   backend)


from ..core.query import CollectionStats  # noqa: E402  (re-export: the
#   ranking statistics a deletion-aware engine scores with)
from ..core.query import TermStats  # noqa: E402  (re-export for planner)


@dataclass
class EngineStats:
    """Counters surfaced by ``Engine.stats()`` (serving observability)."""

    num_docs: int = 0         # ordinal docid horizon (includes tombstoned)
    deleted_docs: int = 0     # tombstoned docids still masked at serve time
    num_postings: int = 0
    num_words: int = 0        # total tokens ingested (= postings, word-level)
    vocab_size: int = 0
    queries: int = 0
    query_batches: int = 0    # execute_many calls (latency denominator)
    query_time_s: float = 0.0  # wall-clock inside execute_many (plan+run)
    ingest_docs: int = 0      # documents ingested (add_document(s))
    ingest_batches: int = 0   # ingest calls (mirror of query_batches: a
    #                           single add_document counts as a batch of 1)
    ingest_time_s: float = 0.0  # wall-clock inside ingest (tokenize+append
    #                             +bookkeeping)
    collations: int = 0
    delta_refreshes: int = 0
    delta_compactions: int = 0  # refreshes that hit the fragmentation
    #                             threshold and collated instead
    resident_uploads: int = 0   # full device-image uploads (1 per freeze)
    by_backend: dict = field(default_factory=dict)
