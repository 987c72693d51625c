"""The plain reference of the immediate-access index: plain NumPy and
PyTorch, independent of the program.

It is handed the documents, deletes and queries the benchmark generated,
and works out again, for each query, the live documents ingested before it,
the collection's statistics, the conjunctive set and every document's
ranked score:

* docid ``d`` is the ``d``-th document ingested (1-based);
* a query at horizon ``H`` with deletes ``dead`` sees the documents
  ``1..H`` not in ``dead``; ``N`` counts them, ``f_t`` counts those that
  hold term ``t``, ``avgdl`` is their mean length in words;
* conjunctive: the docids that hold every query term, ascending;
* ranked_tfidf: a document's score is the sum over the query terms it
  holds of ``log1p(f) * log1p(N / f_t)``;
* bm25: the sum of ``widf * f (k1 + 1) / (f + k1 (1 - b) + k1 b dl /
  avgdl)`` with ``widf = log1p((N - f_t + 0.5) / (f_t + 0.5))``.

Scores are computed in the dtype asked for: float64 to judge the program,
a lower precision for the control.
"""

from __future__ import annotations

import numpy as np
import torch


class Collection:
    """Every document a run offers (the resident collection, then the
    window's documents in arrival order), inverted once: per term id the
    docids that hold it, ascending, with their in-document counts."""

    def __init__(self, docs: list[np.ndarray], universe: int):
        n = len(docs)
        lens = np.fromiter((len(d) for d in docs), np.int64, count=n)
        self.doclens = np.concatenate([[0], lens])           # by docid
        self.cum_len = np.cumsum(self.doclens)
        docid = np.repeat(np.arange(1, n + 1, dtype=np.int64), lens)
        terms = (np.concatenate(docs).astype(np.int64) if n
                 else np.zeros(0, np.int64))
        key, f = np.unique(terms * (n + 1) + docid, return_counts=True)
        t = key // (n + 1)
        self.post_doc = (key % (n + 1)).astype(np.int64)     # by term, docid
        self.post_f = f.astype(np.int64)
        self.ptr = np.searchsorted(t, np.arange(universe + 1))
        self.num_docs = n

    def postings(self, t: int, horizon: int, alive: np.ndarray):
        """(docids, counts) of term ``t`` among the visible documents."""
        lo, hi = self.ptr[t], self.ptr[t + 1]
        d = self.post_doc[lo:hi]
        cut = int(np.searchsorted(d, horizon, side="right"))
        d, f = d[:cut], self.post_f[lo:lo + cut]
        keep = alive[d]
        return d[keep], f[keep]


class View:
    """What one query sees: documents ``1..horizon`` less ``dead``."""

    def __init__(self, coll: Collection, horizon: int, dead):
        self.coll = coll
        self.horizon = int(horizon)
        self.alive = np.zeros(coll.num_docs + 1, bool)
        self.alive[1:self.horizon + 1] = True
        dead = np.asarray(sorted(dead), np.int64)
        dead = dead[dead <= self.horizon]
        self.alive[dead] = False
        self.n = self.horizon - len(dead)
        live_len = coll.cum_len[self.horizon] - coll.doclens[dead].sum()
        self.avgdl = live_len / self.n if self.n else 0.0

    def conjunctive(self, terms) -> np.ndarray:
        out = None
        for t in terms:
            d, _ = self.coll.postings(t, self.horizon, self.alive)
            out = d if out is None else np.intersect1d(out, d,
                                                       assume_unique=True)
        return np.zeros(0, np.int64) if out is None else out

    def scores(self, terms, mode: str, scoring: dict,
               dtype=torch.float64) -> torch.Tensor:
        """Every visible document's score (index = docid), in ``dtype``;
        terms are added in query order."""
        acc = torch.zeros(self.horizon + 1, dtype=dtype)
        N = torch.tensor(float(self.n), dtype=dtype)
        for t in terms:
            d, f = self.coll.postings(t, self.horizon, self.alive)
            if len(d) == 0:
                continue
            ft = torch.tensor(float(len(d)), dtype=dtype)
            fv = torch.from_numpy(f).to(dtype)
            if mode == "ranked_tfidf":
                w = torch.log1p(fv) * torch.log1p(N / ft)
            elif mode == "bm25":
                k1 = torch.tensor(float(scoring["bm25_k1"]), dtype=dtype)
                b = torch.tensor(float(scoring["bm25_b"]), dtype=dtype)
                avgdl = torch.tensor(float(self.avgdl), dtype=dtype)
                dl = torch.from_numpy(self.coll.doclens[d]).to(dtype)
                widf = torch.log1p((N - ft + 0.5) / (ft + 0.5))
                w = widf * (fv * (k1 + 1.0)) / (
                    fv + k1 * (1.0 - b) + k1 * b * dl / avgdl)
            else:
                raise ValueError(f"not a ranked mode: {mode!r}")
            acc.index_add_(0, torch.from_numpy(d), w.to(dtype))
        return acc

    def top_k(self, terms, mode: str, k: int, scoring: dict,
              dtype=torch.float64):
        """(docids, scores) of the ``k`` best documents with a positive
        score, in canonical order: score descending, docid ascending."""
        s = self.scores(terms, mode, scoring, dtype).double().numpy()
        d = np.flatnonzero(s > 0)
        order = np.lexsort((d, -s[d]))[:k]
        return d[order], s[d[order]]
