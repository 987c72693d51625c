"""Token pipeline for LM training and serving.

Deterministic synthetic token streams (seeded per step index) so that a
restarted worker regenerates exactly the batch it crashed on — the data-side
half of fault-tolerant training.  Real-corpus ingestion reuses
data.docstream + a hash vocabulary.

A copy of the JAX package's ``data/lm.py``, which is numpy only: the same
seed and step give the same batch in both packages.
"""

from __future__ import annotations

import numpy as np


class TokenBatches:
    """Infinite deterministic (tokens, labels) batches keyed by step."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed << 32) ^ step)
        toks = rng.integers(0, self.vocab,
                            (self.batch, self.seq_len + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def text_to_tokens(terms: list[str], vocab: int) -> np.ndarray:
    """Hash terms into a fixed id space (for docstream corpora)."""
    import zlib
    return np.asarray([zlib.crc32(t.encode()) % vocab for t in terms],
                      dtype=np.int32)
