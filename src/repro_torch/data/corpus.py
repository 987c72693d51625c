"""Synthetic Zipfian docstream generator calibrated to paper Table 5.

WSJ1/Robust04/Wikipedia are not redistributable offline, so compression and
throughput experiments run on synthetic streams with matched statistics:

  * term frequencies Zipf(s≈1.07) over a large vocabulary universe — giving
    the paper's "very high fraction of low f values, many small g values,
    larger g accompanied by low f" joint distribution that Double-VByte
    exploits (§3.5);
  * document lengths log-normal with mean ≈ `words_per_doc` (WSJ1: 434);
  * vocabulary growth follows Heaps' law automatically (sampling without
    universe exhaustion).

Generation is vectorized numpy and streams documents, so gigabyte-scale
collections never materialize in memory at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Iterator

import numpy as np


@dataclass
class CorpusSpec:
    n_docs: int = 10_000
    words_per_doc: float = 434.5          # WSJ1 (Table 5)
    zipf_s: float = 1.07
    universe: int = 500_000               # vocabulary universe size
    seed: int = 0

    def scaled(self, n_docs: int) -> "CorpusSpec":
        return CorpusSpec(n_docs=n_docs, words_per_doc=self.words_per_doc,
                          zipf_s=self.zipf_s, universe=self.universe,
                          seed=self.seed)


WSJ1_LIKE = CorpusSpec(n_docs=98_732, words_per_doc=434.5)
ROBUST04_LIKE = CorpusSpec(n_docs=528_155, words_per_doc=527.3)
WIKIPEDIA_LIKE = CorpusSpec(n_docs=6_477_362, words_per_doc=377.4,
                            universe=5_000_000)


def _term_name(i: int) -> str:
    # compact deterministic term strings, ~7 chars average like English
    return np.base_repr(i + 31, 36).lower()


@lru_cache(maxsize=4)
def term_table(universe: int) -> tuple[str, ...]:
    """Every term name of a universe, rendered once: ``_term_name`` per
    token would dominate the ingest of a paper-scale stream."""
    return tuple(_term_name(i) for i in range(universe))


class SyntheticCorpus:
    """Streaming synthetic docstream."""

    def __init__(self, spec: CorpusSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        ranks = np.arange(1, spec.universe + 1, dtype=np.float64)
        p = ranks ** (-spec.zipf_s)
        self._probs = p / p.sum()
        # Document-length log-normal tuned so the mean matches the spec
        self._len_mu = np.log(spec.words_per_doc) - 0.125
        self._len_sigma = 0.5

    def doc_terms(self) -> Iterator[list[str]]:
        """Yield documents as term lists (term ids rendered to strings)."""
        names = term_table(self.spec.universe)
        for ids in self.doc_term_ids():
            yield [names[i] for i in ids.tolist()]

    def doc_term_ids(self) -> Iterator[np.ndarray]:
        spec = self.spec
        batch = 256  # draw lengths in batches for speed
        emitted = 0
        while emitted < spec.n_docs:
            take = min(batch, spec.n_docs - emitted)
            lens = np.maximum(
                2, self.rng.lognormal(self._len_mu, self._len_sigma,
                                      take)).astype(np.int64)
            total = int(lens.sum())
            draws = self.rng.choice(spec.universe, size=total, p=self._probs)
            off = 0
            for L in lens:
                yield draws[off:off + int(L)]
                off += int(L)
            emitted += take

    def stats_estimate(self) -> dict:
        return {"n_docs": self.spec.n_docs,
                "words_per_doc": self.spec.words_per_doc,
                "universe": self.spec.universe}
