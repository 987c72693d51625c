"""The benchmark's one traffic generator: a pure function of the seed.

It makes everything a run feeds the system and the reference alike:

* the resident collection: WSJ1-like documents (paper Table 5), term ranks
  drawn from Zipf(s) over a universe of term ids and document lengths
  log-normal with the configured mean, as the program's own synthetic
  stream draws them (a frozen copy of its distribution, drawn by inverse
  CDF in bulk);
* the query pool: 1 to ``max_terms`` distinct terms a query, drawn by Zipf
  rank among the terms the resident collection holds, modes in the mix's
  fixed cycle, one ``k``;
* the arrivals of an ``immediate`` mix: ``per_batch`` documents before
  each query batch, every ``delete_every``-th arrival a delete of a
  document that is live at that point, drawn uniformly; drawn in chunks,
  as many as the window needs.

A run offers a fixed sequence of work, and every seed the same sizes in
another order, so that neither the host's speed nor the seed changes how
much work a query batch carries: the arrivals come a fixed number a batch
(not by the clock, so a slow batch does not make the next one heavier),
and the documents' lengths and the queries' term counts are one fixed set
(drawn once from the stream ``BASE``), shuffled by the seed. Each purpose
draws from its own stream of one ``SeedSequence``, so a change to one
never shifts another. Nothing here reads a clock or any state outside its
arguments.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: stream keys, one independent generator each
COLLECTION, WINDOW_DOCS, QUERIES, WARMUP, ARRIVALS, SAMPLE = range(6)
#: the seed of the sizes every run shares, and its streams
BASE, BASE_RESIDENT, BASE_WINDOW = 0, 100, 101
#: query batches whose arrivals are drawn together
CHUNK_BATCHES = 64


def generator(seed: int, stream: int, *part: int) -> np.random.Generator:
    """The generator of one purpose (and part of it).  Any whole number is
    a seed: it is taken modulo 2**64, so large and negative ones work."""
    ss = np.random.SeedSequence(int(seed) % 2**64,
                                spawn_key=(stream, *part))
    return np.random.default_rng(ss)


def shuffled(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return x[rng.permutation(len(x))]


def term_name(i: int) -> str:
    """Compact deterministic term strings, ~7 characters like English."""
    return np.base_repr(i + 31, 36).lower()


def term_names(universe: int) -> list[str]:
    return [term_name(i) for i in range(universe)]


class Zipf:
    """Zipf(s) over ranks ``0 .. universe-1``, drawn by inverse CDF."""

    def __init__(self, universe: int, s: float):
        p = np.arange(1, universe + 1, dtype=np.float64) ** -float(s)
        self.cdf = np.cumsum(p / p.sum())
        self.universe = universe

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        u = rng.random(n)
        return np.minimum(np.searchsorted(self.cdf, u, side="right"),
                          self.universe - 1).astype(np.int32)


def doc_lengths(coll: dict, stream: int, n: int, *part: int) -> np.ndarray:
    """The fixed set of ``n`` document lengths every run shares:
    log-normal with mean ``words_per_doc`` (sigma ``doclen_sigma``; at
    least 2 words)."""
    sigma = float(coll["doclen_sigma"])
    mu = np.log(float(coll["words_per_doc"])) - sigma * sigma / 2
    rng = generator(BASE, stream, *part)
    return np.maximum(2, rng.lognormal(mu, sigma, n)).astype(np.int64)


def draw_docs(lens: np.ndarray, zipf: Zipf,
              rng: np.random.Generator) -> list[np.ndarray]:
    """Documents of the lengths ``lens``, shuffled by ``rng``, as arrays of
    term ids drawn by Zipf rank."""
    if len(lens) == 0:
        return []
    lens = shuffled(lens, rng)
    ids = zipf.draw(rng, int(lens.sum()))
    return np.split(ids, np.cumsum(lens)[:-1])


@dataclass
class Queries:
    """A pool of queries: ``terms[i]`` a tuple of distinct term ids,
    ``modes[i]`` its mode, all with one ``k``."""

    terms: list[tuple[int, ...]]
    modes: list[str]
    k: int


def mode_cycle(weights: dict) -> list[str]:
    """The modes in a fixed cycle: ``{"a": 1, "b": 2}`` -> a, b, b."""
    return [m for m, w in weights.items() for _ in range(int(w))]


def draw_queries(spec: dict, known: np.ndarray, zipf: Zipf,
                 rng: np.random.Generator, n: int) -> Queries:
    """``n`` queries of ``min_terms``..``max_terms`` distinct terms drawn by
    Zipf rank, each term one that ``known`` (a bool per term id) marks.
    The term counts are the same for every seed (each count equally
    often), shuffled by ``rng``; a term drawn again in a query, or
    unknown, is drawn anew."""
    lo, hi = int(spec["min_terms"]), int(spec["max_terms"])
    cycle = mode_cycle(spec["modes"])
    sizes = shuffled(lo + np.arange(n) % (hi - lo + 1), rng)
    pending = list(range(n))
    have: list[list[int]] = [[] for _ in range(n)]
    while pending:
        need = [int(sizes[i]) - len(have[i]) for i in pending]
        draws = zipf.draw(rng, 2 * sum(need) + 64).tolist()
        off = 0
        for i, k in zip(pending, need):
            for t in draws[off:off + k]:
                if known[t] and t not in have[i]:
                    have[i].append(t)
            off += k
        pending = [i for i in pending if len(have[i]) < sizes[i]]
    modes = [cycle[i % len(cycle)] for i in range(n)]
    return Queries([tuple(h) for h in have], modes, int(spec["k"]))


class Arrivals:
    """Documents and deletes offered in the window, in arrival order,
    ``per_batch`` of them before each query batch.  ``delete[i]`` is the
    docid arrival i deletes, or 0 when it is a document, whose term ids
    are then ``docs[doc_of[i]]``.

    They are drawn in chunks of :data:`CHUNK_BATCHES` batches, chunk c from
    its own streams of the seed, in order: set-up draws the chunks it
    expects the window to use, and :meth:`before` draws the next one when
    a faster program outruns them, so the window never runs out.  Chunk c
    is the same whenever it is drawn."""

    def __init__(self, spec: dict | None, coll: dict, zipf: Zipf, seed: int,
                 n_resident: int):
        self.per_batch = int(spec["per_batch"]) if spec else 0
        self.every = int(spec["delete_every"]) if spec else 0
        self.coll, self.zipf, self.seed = coll, zipf, seed
        self.n_resident = self.ndocs = n_resident
        self.dead: set[int] = set()
        self.delete: list[int] = []
        self.doc_of: list[int] = []
        self.docs: list[np.ndarray] = []
        self.rng = generator(seed, ARRIVALS)

    def __len__(self) -> int:
        return len(self.delete)

    def draw(self, n_batches: int) -> None:
        """Draw chunks until the arrivals of ``n_batches`` batches are
        there."""
        while self.per_batch and len(self) < self.per_batch * n_batches:
            self._chunk(len(self) // (self.per_batch * CHUNK_BATCHES))

    def _chunk(self, c: int) -> None:
        first, every, rng = len(self), self.every, self.rng
        docs0 = self.ndocs
        for i in range(first, first + self.per_batch * CHUNK_BATCHES):
            if every and i % every == every - 1 and len(self.dead) < self.ndocs:
                while True:
                    d = int(rng.integers(1, self.ndocs + 1))
                    if d not in self.dead:
                        break
                self.dead.add(d)
                self.delete.append(d)
                self.doc_of.append(-1)
            else:
                self.delete.append(0)
                self.doc_of.append(self.ndocs - self.n_resident)
                self.ndocs += 1
        self.docs += draw_docs(
            doc_lengths(self.coll, BASE_WINDOW, self.ndocs - docs0, c),
            self.zipf, generator(self.seed, WINDOW_DOCS, c))

    def before(self, batch: int) -> range:
        """The arrivals due before query batch ``batch`` (0-based)."""
        self.draw(batch + 1)
        lo = batch * self.per_batch
        return range(lo, min(lo + self.per_batch, len(self)))


@dataclass
class Traffic:
    """Everything one run of a cell offers, made from its seed."""

    resident: list[np.ndarray]      # the set-up collection, docids 1..n
    known: np.ndarray               # bool per term id: in the collection
    queries: Queries                # the window's pool, cycled in order
    warmup: Queries                 # warm-up batches, never checked
    arrivals: Arrivals


def make_traffic(cfg: dict, mix: dict, seed: int,
                 seconds: float) -> Traffic:
    coll = cfg["collection"]
    zipf = Zipf(int(coll["universe"]), float(coll["zipf_s"]))
    resident = draw_docs(doc_lengths(coll, BASE_RESIDENT, int(cfg["n_docs"])),
                         zipf, generator(seed, COLLECTION))
    known = np.zeros(zipf.universe, bool)
    for d in resident:
        known[d] = True
    q = mix["queries"]
    queries = draw_queries(q, known, zipf, generator(seed, QUERIES),
                           int(q["pool"]))
    warmup = draw_queries(q, known, zipf, generator(seed, WARMUP),
                          int(q["batch"]) * int(mix["warmup_batches"]))
    docs = mix.get("documents")
    arrivals = Arrivals(docs, coll, zipf, seed, len(resident))
    if docs:
        arrivals.draw(int(np.ceil(float(docs["drawn_ahead_per_s"]) * seconds)))
    return Traffic(resident, known, queries, warmup, arrivals)
