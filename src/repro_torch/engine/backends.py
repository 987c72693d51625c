"""Backend interface, the host, tiered and kernel backends.

The host and kernel backends operate directly on the live
:class:`~repro_torch.core.index.DynamicIndex` (immediate access is inherited
for free): the host backend serves every mode with the paper's cursors, the
kernel backend the doc-level term modes through the hand-written kernels.
The tiered backend serves the frozen docid prefix from the compressed
:class:`~repro_torch.core.static_index.StaticIndex` tier published by the
lifecycle (:mod:`repro_torch.core.lifecycle`) and reads the dynamic index
only past the tier horizon.  The device backend, which needs an image
refresh protocol, lives in :mod:`repro_torch.engine.device_backend`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import query as hostq
from ..core.index import group_occurrences
from ..kernels import registry
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


class TieredView:
    """Index-like facade over static tier + dynamic suffix (disjoint ranges).

    ``postings(term)`` concatenates the tier's compressed list (all docids
    <= ``horizon``) with the dynamic postings strictly past the horizon —
    read via a ``PostingsCursor`` sought to ``horizon + 1``, so the frozen
    prefix of the live chains is skipped block-at-a-time, never decoded.
    Because docids are ordinal and append-only, the concatenation equals the
    full dynamic list exactly; feeding this view to the host TAAT scorers
    (which take any object with ``num_docs``/``postings``) therefore yields
    results byte-identical to the host backend, while the bulk of each list
    is served from its most compressed form.

    Word-level engines get the same guarantees at occurrence granularity:
    ``postings`` concatenates occurrence streams (docids repeat, payload =
    w-gap) and ``cursor`` chains document-granular POSITIONAL cursors — a
    :class:`~repro_torch.core.static_index.StaticWordCursor` over the tier with a
    :class:`~repro_torch.core.query.WordPostingsCursor` over the suffix — so
    phrase evaluation never materializes either tier.  A document's
    occurrences never straddle the horizon (each document's postings are
    written before the next document starts), which is what makes the
    per-document position lists exact across the chain.
    """

    def __init__(self, engine, tier):
        self.engine = engine
        self.tier = tier                      # StaticTier | None
        self.horizon = 0 if tier is None else tier.num_docs

    @property
    def num_docs(self) -> int:
        return self.engine.index.num_docs

    @property
    def word_level(self) -> bool:
        return self.engine.index.word_level

    @property
    def tombstones(self) -> set:
        """The live tombstone set — deleted docids are masked across BOTH
        tiers (the static tier may still hold docs tombstoned after its
        freeze; the next encode compacts them away)."""
        return self.engine.index.tombstones

    def ft(self, term) -> int:
        """f_t with the dynamic index's semantics, from the engine's O(1)
        global counters (operator-ordering heuristics, e.g. the proximity
        rarest-first lead, read this — never a chain walk)."""
        tid = self.engine.term_id(term)
        return self.engine._fts[tid] if tid is not None else 0

    def suffix_postings(self, term) -> tuple[np.ndarray, np.ndarray]:
        """Dynamic postings with docid > horizon (cursor-skipped prefix)."""
        idx = self.engine.index
        h = idx.lookup(term)
        if h is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        c = hostq.PostingsCursor(idx.store, h)
        if not c.seek_geq(self.horizon + 1):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        ds, fs = [], []
        while True:
            ds.append(c.docid)
            fs.append(c.payload)
            if not c.next():
                break
        return (np.asarray(ds, dtype=np.int64),
                np.asarray(fs, dtype=np.int64))

    def postings(self, term) -> tuple[np.ndarray, np.ndarray]:
        d2, f2 = self.suffix_postings(term)
        if self.tier is None:
            return d2, f2
        d1, f1 = self.tier.index.postings(term)
        if len(d1) == 0:
            return d2, f2
        return np.concatenate([d1, d2]), np.concatenate([f1, f2])

    def doc_postings(self, term) -> tuple[np.ndarray, np.ndarray]:
        """Document-granular postings across both tiers: (unique docids,
        doc-level f_{t,d}) — what the ranked scorers consume.

        The frozen prefix comes from ``StaticIndex.doc_postings`` (docid +
        count streams only; the w-gap stream is never decoded), the suffix
        from grouping the cursor-skipped occurrence stream of
        ``suffix_postings``.  Documents never straddle the horizon, so
        concatenation is exact — identical arrays to grouping the full
        dynamic stream."""
        if not self.engine.index.word_level:
            return self.postings(term)
        docc, _wg = self.suffix_postings(term)
        d2, f2 = group_occurrences(docc)
        if self.tier is None:
            return d2, f2
        d1, f1 = self.tier.index.doc_postings(term)
        if len(d1) == 0:
            return d2, f2
        return np.concatenate([d1, d2]), np.concatenate([f1, f2])

    def cursor(self, term):
        """One chained DAAT cursor across both tiers (None = no postings).

        Word-level indexes chain positional, document-granular cursors
        (payload = f_{t,d}, ``positions()`` live), ready for both the
        conjunctive and the phrase operators."""
        parts = []
        if self.tier is not None:
            parts.append(self.tier.index.postings_iter(term))
        idx = self.engine.index
        h = idx.lookup(term)
        if h is not None:
            c = hostq.PostingsCursor(idx.store, h)
            if self.horizon == 0 or c.seek_geq(self.horizon + 1):
                parts.append(hostq.WordPostingsCursor(c)
                             if idx.word_level else c)
        chained = hostq.ChainedCursor(parts)
        return None if chained.exhausted else chained


class TieredBackend(Backend):
    """Serve each query from the static tier + dynamic suffix, exactly.

    Boolean conjunctive runs DAAT over :class:`~repro_torch.core.query.
    ChainedCursor`s (seek_GEQ skipping inside the compressed tier via its
    bp128 skip tables); ranked modes reuse the host TAAT scorers over the
    :class:`TieredView` (document-granular via ``doc_postings``, so
    word-level f_{t,d}/f_t are doc-level and idf/BM25 statistics are the
    live collection's — the same contract the device backend's frozen+delta
    merge enforces).  Word-level engines additionally get the positional
    modes: ``phrase`` and ``proximity`` run positional DAAT over chained
    static+dynamic word cursors, ``bm25_prox`` scores BM25 + MinDist
    through the same cursors.  Works with no tier published yet (the view
    degenerates to the pure dynamic path), so routing to it is always safe.
    """

    name = "tiered"

    def view(self) -> TieredView:
        return TieredView(self.engine, self.engine.static_tier())

    def execute(self, query: Query) -> QueryResult:
        eng = self.engine
        view = self.view()
        stats = eng.ranking_stats()   # deletion-aware (N, f_t, avgdl) or None
        if query.mode in ("phrase", "proximity", "bm25_prox") \
                and not eng.index.word_level:
            raise UnsupportedQueryError(
                f"{query.mode} queries need a word-level index (§5.1)")
        if query.mode == "phrase":
            # one fresh positional cursor per phrase slot, in phrase order
            d = hostq.phrase_from_cursors(
                [view.cursor(t) for t in query.terms])
            d = hostq._drop_dead(d, hostq._tombstones(view))
            return QueryResult(d, None, self.name)
        if query.mode == "proximity":
            # one positional cursor per UNIQUE term + its multiplicity:
            # repeated query terms must bind distinct positions
            d = hostq.proximity_query(view, query.terms, query.window)
            return QueryResult(d, None, self.name)
        if query.mode == "bm25_prox":
            d, s = hostq.ranked_bm25_prox(view, query.terms,
                                          eng.doclens_array(), k=query.k,
                                          stats=stats)
            return QueryResult(d, s, self.name)
        if query.mode == "conjunctive":
            cursors = []
            for t in query.terms:
                c = view.cursor(t)
                if c is None:
                    return QueryResult(np.zeros(0, np.int64), None, self.name)
                tid = eng.term_id(t)
                cursors.append((eng._fts[tid] if tid is not None else 0, c))
            if not cursors:
                return QueryResult(np.zeros(0, np.int64), None, self.name)
            # rarest-first via the engine's O(1) global f_t counters
            cursors.sort(key=lambda p: p[0])
            d = hostq.conjunctive_from_cursors([c for _, c in cursors])
            d = hostq._drop_dead(d, hostq._tombstones(view))
            return QueryResult(d, None, self.name)
        if query.mode == "ranked_tfidf":
            d, s = hostq.ranked_disjunctive_taat(view, query.terms,
                                                 k=query.k, stats=stats)
            return QueryResult(d, s, self.name)
        if query.mode == "bm25":
            d, s = hostq.ranked_bm25(view, query.terms, eng.doclens_array(),
                                     k=query.k, stats=stats)
            return QueryResult(d, s, self.name)
        raise UnsupportedQueryError(f"unknown mode {query.mode!r}")


class KernelBackend(Backend):
    """Serve doc-level queries through the hand-written kernels, on any
    growth policy.  The counterpart of the reference's ``PallasBackend``
    (``repro/engine/backends.py``), under the name ``"kernel"``.

    On a device-capable engine (Const growth, doc-level) the three
    term-query modes run the fused path: one ``fused_query`` launch per
    (mode, k) group over the engine's resident frozen+delta images, shared
    with the device backend.

    An index without device images (Triangle or Expon growth) takes the
    per-op path: each term's postings are decoded on the host (the live
    chains are host memory) and copied to ``engine.device``, where a
    conjunctive query of two or more terms runs one ``intersect`` launch
    for all its further lists and a ranked query one ``topk_score``
    launch, then a top-k.  On a CUDA device the ops launch their kernels;
    on the CPU they run their plain versions.
    """

    name = "kernel"

    def __init__(self, engine, resident=None):
        super().__init__(engine)
        self.resident = resident  # shared ResidentImageManager (or None)

    def execute_many(self, queries: list[Query]) -> list[QueryResult]:
        eng = self.engine
        if self.resident is None or not eng.device_capable:
            return super().execute_many(queries)
        # lazy import: device_backend imports this module for Backend
        from .device_backend import fused_execute, serve_groups
        return serve_groups(self.resident, queries, lambda batch, mode, k:
                            fused_execute(eng, self.resident, batch, mode, k,
                                          name=self.name))

    # -- inputs of the per-op path (also what chip_smoke.py times) --------

    def conjunctive_lists(self, query: Query) -> list[np.ndarray] | None:
        """Each term's docids (int32, tombstones included), shortest first;
        None when a term has no postings (the answer is empty)."""
        idx = self.engine.index
        lists = []
        for t in query.terms:
            docids, _ = idx.postings(t)
            if len(docids) == 0:
                return None
            lists.append(docids.astype(np.int32))
        lists.sort(key=len)
        return lists

    def ranked_postings(self, query: Query):
        """``(docids int32, weights float32, offsets int32)`` of a ranked
        query: its terms' live postings concatenated term by term, weighted
        on the host exactly as the reference's kernel backend weights them,
        and the bounds [0, ..., M] of the terms' segments; None without
        postings."""
        eng = self.engine
        idx = eng.index
        N = idx.num_docs
        stats = eng.ranking_stats()   # deletion-aware (N, f_t, avgdl) or None
        Ns = N if stats is None else stats.num_docs
        doclens = eng.doclens_array() if query.mode == "bm25" else None
        if query.mode != "bm25":
            avg = 0.0
        elif stats is not None:
            avg = stats.avg_doclen
        else:
            avg = float(doclens[1:N + 1].mean()) if N else 0.0
        dead = hostq._tombstones(idx)
        all_d, all_w = [], []
        for t in query.terms:
            docids, fs = idx.postings(t)
            if dead and len(docids):
                keep = ~np.isin(docids, np.fromiter(dead, np.int64,
                                                    count=len(dead)))
                docids, fs = docids[keep], fs[keep]
            if len(docids) == 0:
                continue
            ft = len(docids) if stats is None else stats.doc_ft(t)
            if query.mode == "bm25":
                w = hostq.bm25_weight(fs.astype(np.float64),
                                      doclens[docids], avg, ft, Ns)
            else:
                w = hostq.tfidf_weight(fs, ft, Ns)
            all_d.append(docids.astype(np.int32))
            all_w.append(w.astype(np.float32))
        if not all_d:
            return None
        offsets = np.cumsum([0] + [len(d) for d in all_d], dtype=np.int32)
        return np.concatenate(all_d), np.concatenate(all_w), offsets

    # -- mode implementations -------------------------------------------

    def _conjunctive(self, query: Query) -> QueryResult:
        lists = self.conjunctive_lists(query) if query.terms else None
        if lists is None:
            return QueryResult.empty(query.mode, self.name)
        hit = np.ones(len(lists[0]), bool)
        if len(lists) > 1:
            # the bounds of the further lists, the shortest list and the
            # further lists in one buffer: one copy, one launch
            n, na = len(lists) - 1, len(lists[0])
            bounds = np.cumsum([0] + [len(x) for x in lists[1:]])
            buf = torch.from_numpy(np.concatenate(
                [bounds.astype(np.int32), *lists])).to(self.engine.device)
            flags = registry.get("intersect").fn(
                buf[n + 1:n + 1 + na], buf[n + 1 + na:], offsets=buf[:n + 1])
            hit = flags.cpu().numpy()      # the one copy back
        d = hostq._drop_dead(lists[0][hit].astype(np.int64),
                             hostq._tombstones(self.engine.index))
        return QueryResult(d, None, self.name)

    def _ranked(self, query: Query) -> QueryResult:
        inputs = self.ranked_postings(query)
        if inputs is None:
            return QueryResult.empty(query.mode, self.name)
        docids, weights = (torch.from_numpy(x).to(self.engine.device)
                           for x in inputs[:2])
        n_docs = self.engine.index.num_docs + 1
        scores = registry.get("topk_score").fn(docids, weights, n_docs,
                                               offsets=inputs[2])
        # canonical order (score desc, docid asc), as jax.lax.top_k gives:
        # a stable descending sort (torch.topk promises no tie order)
        top_s, top_d = torch.sort(scores, descending=True, stable=True)
        k = min(query.k, n_docs)
        top_s, top_d = top_s[:k].cpu().numpy(), top_d[:k].cpu().numpy()
        keep = top_s > 0
        return QueryResult(top_d[keep].astype(np.int64),
                           top_s[keep].astype(np.float64), self.name)

    def execute(self, query: Query) -> QueryResult:
        if query.mode == "conjunctive":
            return self._conjunctive(query)
        if query.mode in ("ranked_tfidf", "bm25"):
            return self._ranked(query)
        raise UnsupportedQueryError(
            f"KernelBackend does not implement mode {query.mode!r}")
