"""Backend interface and the host backend.

The host backend operates directly on the live
:class:`~repro_torch.core.index.DynamicIndex` (immediate access is inherited
for free) and serves every mode; the device backend, which needs an image
refresh protocol, lives in :mod:`repro_torch.engine.device_backend`.
"""

from __future__ import annotations

from ..core import query as hostq
from .types import Query, QueryResult


class UnsupportedQueryError(ValueError):
    """Raised when a forced backend cannot execute the query."""


class Backend:
    """Interface: ``execute_many`` over the engine's live state."""

    name = "base"

    def __init__(self, engine):
        self.engine = engine

    def execute_many(self, queries: list[Query]) -> list[QueryResult]:
        return [self.execute(q) for q in queries]

    def execute(self, query: Query) -> QueryResult:
        raise NotImplementedError


class HostBackend(Backend):
    """The paper-faithful numpy path: DAAT cursors with seek_GEQ skipping
    for boolean queries, vectorized TAAT for ranked modes (core/query.py)."""

    name = "host"

    def execute(self, query: Query) -> QueryResult:
        eng = self.engine
        idx = eng.index
        stats = eng.ranking_stats()   # deletion-aware (N, f_t, avgdl) or None
        if query.mode == "conjunctive":
            d = hostq.conjunctive_query(idx, query.terms)
            return QueryResult(d, None, self.name)
        if query.mode == "ranked_tfidf":
            d, s = hostq.ranked_disjunctive_taat(idx, query.terms, k=query.k,
                                                 stats=stats)
            return QueryResult(d, s, self.name)
        if query.mode == "bm25":
            d, s = hostq.ranked_bm25(idx, query.terms, eng.doclens_array(),
                                     k=query.k, stats=stats)
            return QueryResult(d, s, self.name)
        if query.mode == "phrase":
            if not idx.word_level:
                raise UnsupportedQueryError(
                    "phrase queries need a word-level index (§5.1)")
            d = hostq.phrase_query(idx, query.terms)
            return QueryResult(d, None, self.name)
        if query.mode == "proximity":
            if not idx.word_level:
                raise UnsupportedQueryError(
                    "proximity queries need a word-level index (§5.1)")
            d = hostq.proximity_query(idx, query.terms, query.window)
            return QueryResult(d, None, self.name)
        if query.mode == "bm25_prox":
            if not idx.word_level:
                raise UnsupportedQueryError(
                    "bm25_prox queries need a word-level index (§5.1)")
            d, s = hostq.ranked_bm25_prox(idx, query.terms,
                                          eng.doclens_array(), k=query.k,
                                          stats=stats)
            return QueryResult(d, s, self.name)
        raise UnsupportedQueryError(f"unknown mode {query.mode!r}")
