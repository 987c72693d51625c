"""Recsys data substrate: synthetic Criteo-like batches + table specs.

DLRM table sizes follow the MLPerf Criteo-1TB configuration (row counts
capped at 40M, 26 sparse fields); sampling is deterministic per step for
fault-tolerant replay, power-law over rows (real CTR id traffic is heavily
skewed, which is what makes the embedding lookup the hot path).

A copy of the JAX package's ``data/recsys.py``, which is numpy only: the
same seed and step give the same arrays in both packages, bit for bit.
:class:`ModelBatches`, the batches of each recsys model, is the port's.
"""

from __future__ import annotations

import numpy as np

# MLPerf DLRM (Criteo 1TB, day-sharded) per-field row counts, 40M cap.
CRITEO_TABLE_ROWS = [
    40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36,
]
N_DENSE = 13
N_SPARSE = 26


class RecsysBatches:
    """Deterministic synthetic (dense, sparse ids, label) batches."""

    def __init__(self, batch: int, table_rows=None, n_dense: int = N_DENSE,
                 seed: int = 0, hist_len: int = 0):
        self.batch = batch
        self.table_rows = list(table_rows or CRITEO_TABLE_ROWS)
        self.n_dense = n_dense
        self.seed = seed
        self.hist_len = hist_len

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed << 32) ^ step)
        dense = rng.lognormal(0.0, 1.0,
                              (self.batch, self.n_dense)).astype(np.float32)
        sparse = np.stack([
            (rng.zipf(1.2, self.batch).astype(np.int64) - 1) % rows
            for rows in self.table_rows], axis=1).astype(np.int32)
        label = (rng.random(self.batch) < 0.25).astype(np.float32)
        out = {"dense": dense, "sparse": sparse, "label": label}
        if self.hist_len:
            out["history"] = rng.integers(
                0, self.table_rows[0],
                (self.batch, self.hist_len)).astype(np.int32)
            out["hist_mask"] = (rng.random(
                (self.batch, self.hist_len)) < 0.8).astype(np.float32)
            out["target"] = rng.integers(
                0, self.table_rows[0], self.batch).astype(np.int32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ModelBatches:
    """Deterministic batches for one recsys model, keyed by step, with the
    keys of ``configs.common.RecsysArch._batch_specs``.  The port's own:
    the reference trains only DLRM on data (``launch/train.py``), so each
    model's ids come from where the reference draws ids of that kind, or
    from the model's paper:

    * ``dlrm``: ``RecsysBatches(batch, cfg.table_rows, cfg.n_dense)``'s
      ``dense``, ``sparse`` and ``label``: the reference's Criteo-like
      draw, Zipf(1.2) ids in each categorical field;
    * ``din``: ``RecsysBatches``' ``history``, ``hist_mask``, ``target``
      and ``label`` over one table of ``cfg.n_items`` rows, ``hist_len`` =
      ``cfg.seq_len``: the reference's own item draw, uniform ids;
    * ``sasrec``: a history of ``seq_len + 1`` items drawn as DIN's
      (``seq`` its first ``seq_len``, ``pos`` the next item at each
      position, ``seq_mask`` the mask of ``pos``), and one negative a
      position drawn uniformly over ``cfg.n_items``, as the SASRec paper
      samples them (arXiv:1808.09781, "Network Training"; it also keeps
      the negative out of the user's history, which a uniform draw over
      the full 1,000,448-item table breaks at about one position in
      20,000);
    * ``twotower``: ``user_feats`` the hashed user feature ids of
      ``n_user_feats`` fields of ``n_users_vocab`` rows, drawn as the
      reference draws Criteo's categorical fields, ``user_mask`` the
      history mask, ``item`` uniform over ``n_items`` as the reference
      draws item ids, and ``logq`` the log of each item's frequency in the
      batch (the in-batch sampling probability that the loss corrects
      for).

    The negatives and the two-tower's items come from a second generator
    keyed by ``(seed, step)``, apart from ``RecsysBatches``' stream.
    """

    def __init__(self, kind: str, cfg, batch: int, seed: int = 0):
        if kind not in ("dlrm", "din", "sasrec", "twotower"):
            raise ValueError(kind)
        self.kind = kind
        self.cfg = cfg
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        c, B, seed = self.cfg, self.batch, self.seed
        if self.kind == "dlrm":
            return RecsysBatches(B, c.table_rows, c.n_dense,
                                 seed).batch_at(step)
        if self.kind == "din":
            b = RecsysBatches(B, [c.n_items], seed=seed,
                              hist_len=c.seq_len).batch_at(step)
            return {k: b[k] for k in ("history", "hist_mask", "target",
                                      "label")}
        rng = np.random.default_rng([seed, step])
        if self.kind == "sasrec":
            S = c.seq_len
            b = RecsysBatches(B, [c.n_items], seed=seed,
                              hist_len=S + 1).batch_at(step)
            h = b["history"]
            neg = rng.integers(0, c.n_items, (B, S)).astype(np.int32)
            return {"seq": h[:, :-1], "pos": h[:, 1:], "neg": neg,
                    "seq_mask": b["hist_mask"][:, 1:]}
        F = c.n_user_feats
        b = RecsysBatches(B, [c.n_users_vocab] * F, seed=seed,
                          hist_len=F).batch_at(step)
        item = rng.integers(0, c.n_items, B).astype(np.int32)
        _, inverse, counts = np.unique(item, return_inverse=True,
                                       return_counts=True)
        return {"user_feats": b["sparse"], "user_mask": b["hist_mask"],
                "item": item,
                "logq": np.log(counts[inverse] / B).astype(np.float32)}
