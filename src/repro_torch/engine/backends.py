"""Backend interface, the host backend and the kernel backend.

The host and kernel backends operate directly on the live
:class:`~repro_torch.core.index.DynamicIndex` (immediate access is inherited
for free): the host backend serves every mode with the paper's cursors, the
kernel backend the doc-level term modes through the hand-written kernels.
The device backend, which needs an image refresh protocol, lives in
:mod:`repro_torch.engine.device_backend`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import query as hostq
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
