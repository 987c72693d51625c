"""Query processing over the dynamic index (paper §3.6, §4.6).

Two query modes, both operating on the live block structure while ingest
continues (immediate access):

  * conjunctive Boolean, document-at-a-time, with ``seek_GEQ`` skipping that
    touches only each block's leading b-gap and n_ptr (§3.2: "an indexed
    sequential access mode") — Culpepper & Moffat-style adaptive DAAT;
  * top-k disjunctive ranking with the paper's TF×IDF model
        w_{t,d} = log(1 + f_{t,d}) * log(1 + N / f_t)
    tracked in a min-heap (§4.6).

All ranked scorers (TF×IDF, BM25, and the position-aware ``bm25_prox``)
consume DOCUMENT-granular statistics on word-level indexes via the
positional cursor protocol (``WordPostingsCursor`` / ``StaticWordCursor`` /
``ChainedCursor``): f_{t,d} is the per-document occurrence count and f_t
the document frequency — never the §5.1 occurrence stream's w-gaps or
occurrence totals.  Phrase and proximity operators run positional DAAT over
the same cursors, so every mode serves identically from the dynamic chains
and the compressed static tier.  Ranked ties follow one canonical order
everywhere: higher score first, then lower docid.

A vectorized term-at-a-time scorer and a brute-force oracle are included for
benchmarks and tests.

These functions are the HOST backend of the unified query engine
(``repro_torch.engine``): callers that want planner-driven routing across the
host / device-oracle / Pallas backends should go through
``Engine.execute(Query(...))`` rather than calling these directly; the
engine guarantees identical results across backends (differential-tested)
and keeps the device images refreshed incrementally.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np

from .blockstore import H, BlockStore
from .dvbyte import dvbyte_decode_from
from .index import DynamicIndex, group_occurrences


class PostingsCursor:
    """A DAAT cursor over one term's chain supporting next()/seek_GEQ().

    Maintains (docid, payload) of the current posting.  ``seek_GEQ`` advances
    block-at-a-time using only the leading b-gap of each block — the paper's
    skip mechanism — then decodes within the final candidate block.
    """

    __slots__ = ("store", "h_ptr", "_blocks", "_bi", "_pos", "_end",
                 "_block_first_d", "_prev_block_first_d", "docid", "payload",
                 "_exhausted", "_first_in_block", "_nx")

    def __init__(self, store: BlockStore, h_ptr: int):
        self.store = store
        self.h_ptr = h_ptr
        # materialize chain slot list once (ptr, z, is_tail)
        self._blocks = list(store.chain_slots(h_ptr))
        self._bi = 0
        self._nx = store.get_nx(h_ptr * store.B)
        self._prev_block_first_d = 0
        self._block_first_d = 0
        self.docid = 0
        self.payload = 0
        self._exhausted = False
        self._enter_block(0)
        self.next()

    # -- block helpers ---------------------------------------------------

    def _block_bounds(self, bi: int):
        store = self.store
        ptr, z, is_tail = self._blocks[bi]
        base = ptr * store.B
        if ptr == self.h_ptr:
            start = store.head_fixed + int(store.I[base + store.head_fixed - 1])
        else:
            start = H
        cap = store.B if store.const_mode else store.block_size_at(z)
        end = base + (self._nx if is_tail else cap)
        return base, base + start, end

    def _enter_block(self, bi: int) -> None:
        self._bi = bi
        _, pos, end = self._block_bounds(bi)
        self._pos = pos
        self._end = end
        self._first_in_block = True

    def _peek_block_first_d(self, bi: int, prev_first_d: int) -> int:
        """First docid of block bi, reading only its leading b-gap."""
        _, pos, _ = self._block_bounds(bi)
        (major, minor), _ = dvbyte_decode_from(self.store.I, pos,
                                               self.store.F)
        if self.store.word_level:
            return prev_first_d + (minor - 1)
        return prev_first_d + major

    # -- iteration --------------------------------------------------------

    def next(self) -> bool:
        """Advance to the next posting; False when exhausted."""
        store = self.store
        while True:
            if self._pos >= self._end or store.I[self._pos] == 0:
                if self._bi + 1 >= len(self._blocks):
                    self._exhausted = True
                    return False
                self._prev_block_first_d = self._block_first_d
                self._enter_block(self._bi + 1)
                continue
            (major, minor), self._pos = dvbyte_decode_from(
                store.I, self._pos, store.F)
            if store.word_level:
                g = minor - 1
                self.payload = major
            else:
                g = major
                self.payload = minor
            if self._first_in_block and self._bi > 0:
                self.docid = self._prev_block_first_d + g  # b-gap
            else:
                self.docid = self.docid + g
            if self._first_in_block:
                self._block_first_d = self.docid
                self._first_in_block = False
            return True

    def seek_geq(self, target: int) -> bool:
        """Position on the first posting with docid >= target.

        Word-level chains must not hop a block whose first docid EQUALS the
        target: the target document's earlier occurrences may end the
        current block, and a seek must land on its FIRST occurrence (the
        w-gap there is the absolute position — the invariant
        ``WordPostingsCursor`` and the tiered suffix reader rely on).
        Doc-level docids are unique, so the equal-hop stays (it skips
        decoding the current block entirely).
        """
        if self._exhausted:
            return False
        # fast block skip: hop while the NEXT block still starts <= target
        # (strictly < for word-level, see above)
        while self._bi + 1 < len(self._blocks):
            nxt_first = self._peek_block_first_d(self._bi + 1,
                                                 self._block_first_d)
            if (nxt_first < target
                    or (nxt_first == target and not self.store.word_level)):
                self._prev_block_first_d = self._block_first_d
                self._enter_block(self._bi + 1)
                self.docid = 0  # will be set by the b-gap on first next()
                self.next()
                self._block_first_d = self.docid
            else:
                break
        while self.docid < target:
            if not self.next():
                return False
        return True

    @property
    def exhausted(self) -> bool:
        return self._exhausted


class WordPostingsCursor:
    """Document-granular view over a word-level occurrence cursor.

    A word-level :class:`PostingsCursor` yields one entry per OCCURRENCE
    (docid repeats, payload = w-gap).  This wrapper groups the run of equal
    docids into one step: ``docid`` advances over unique documents,
    ``payload`` is the doc's occurrence count f_{t,d}, and ``positions()``
    returns the doc's absolute word positions (cumulative w-gaps).  It is
    the dynamic-chain counterpart of :class:`~repro_torch.core.static_index.
    StaticWordCursor`, so phrase/conjunctive evaluation is uniform across
    tiers.  The wrapped cursor must be positioned on the FIRST occurrence
    of its current document (true after construction or any ``seek_geq`` —
    occurrences are stored in (d, w) order, so a docid-targeted seek always
    lands on a document's first occurrence).
    """

    __slots__ = ("_cur", "_pending", "_positions", "docid", "payload",
                 "_exhausted")

    def __init__(self, cur: "PostingsCursor"):
        self._cur = cur
        self._exhausted = cur.exhausted
        self.docid = 0
        self.payload = 0
        self._positions = np.zeros(0, dtype=np.int64)
        self._pending = False
        if not self._exhausted:
            self._gather()

    def _gather(self) -> None:
        """Consume the current document's occurrence run; leaves the wrapped
        cursor parked on the next document's first occurrence (or spent)."""
        cur = self._cur
        d = cur.docid
        ws = []
        w = 0
        while True:
            w += cur.payload          # w-gap -> absolute position
            ws.append(w)
            if not cur.next() or cur.docid != d:
                break
        self.docid = d
        self.payload = len(ws)
        self._positions = np.asarray(ws, dtype=np.int64)
        self._pending = not cur.exhausted

    def positions(self) -> np.ndarray:
        """Absolute word positions of the current document, ascending."""
        return self._positions

    def next(self) -> bool:
        if self._exhausted:
            return False
        if not self._pending:
            self._exhausted = True
            return False
        self._gather()
        return True

    def seek_geq(self, target: int) -> bool:
        if self._exhausted:
            return False
        if self.docid >= target:
            return True
        if not self._pending or not self._cur.seek_geq(target):
            self._exhausted = True
            return False
        self._gather()
        return True

    @property
    def exhausted(self) -> bool:
        return self._exhausted


def word_cursor(index: DynamicIndex, term) -> WordPostingsCursor | None:
    """Document-granular positional cursor over a word-level dynamic index
    (None if the term is unknown)."""
    h = index.lookup(term)
    if h is None:
        return None
    return WordPostingsCursor(PostingsCursor(index.store, h))


def doc_cursor(index: DynamicIndex, term):
    """Document-granular DAAT cursor over any dynamic index: the raw
    :class:`PostingsCursor` for doc-level chains, the
    :class:`WordPostingsCursor` wrapper for word-level ones — so ``payload``
    is f_{t,d} in both cases (None if the term is unknown)."""
    h = index.lookup(term)
    if h is None:
        return None
    c = PostingsCursor(index.store, h)
    return WordPostingsCursor(c) if index.word_level else c


def positional_cursor(index, term):
    """Document-granular POSITIONAL cursor over ``index``: a tiered view's
    chained static+dynamic cursor when the object provides ``cursor``
    (:class:`~repro_torch.engine.backends.TieredView`), else a dynamic
    :func:`word_cursor`.  The uniform entry point of the proximity and
    position-aware ranked operators."""
    factory = getattr(index, "cursor", None)
    if factory is not None:
        return factory(term)
    return word_cursor(index, term)


class ChainedCursor:
    """Concatenate cursors over disjoint, ascending docid ranges.

    The tiered engine path chains a :class:`~repro_torch.core.static_index.
    StaticPostingsCursor` over the frozen tier (docids <= horizon) with a
    :class:`PostingsCursor` sought past the horizon — one DAAT cursor over
    the whole collection, same ``next``/``seek_geq`` protocol.  ``None`` and
    initially-exhausted parts are dropped.  When the parts are positional
    (word-level) cursors, ``positions()`` delegates to the active part, so
    a chained cursor is itself a valid phrase-operator input.
    """

    __slots__ = ("_cs", "_i", "docid", "payload", "_exhausted")

    def __init__(self, cursors):
        self._cs = [c for c in cursors if c is not None and not c.exhausted]
        self._i = 0
        self.docid = 0
        self.payload = 0
        self._exhausted = not self._cs
        if not self._exhausted:
            self._adopt()

    def _adopt(self) -> None:
        c = self._cs[self._i]
        self.docid = c.docid
        self.payload = c.payload

    def next(self) -> bool:
        if self._exhausted:
            return False
        if self._cs[self._i].next():
            self._adopt()
            return True
        self._i += 1
        if self._i < len(self._cs):
            self._adopt()
            return True
        self._exhausted = True
        return False

    def seek_geq(self, target: int) -> bool:
        if self._exhausted:
            return False
        while self._i < len(self._cs):
            if self._cs[self._i].seek_geq(target):
                self._adopt()
                return True
            self._i += 1
        self._exhausted = True
        return False

    def positions(self) -> np.ndarray:
        """Word positions of the current document (positional parts only)."""
        return self._cs[self._i].positions()

    @property
    def exhausted(self) -> bool:
        return self._exhausted


# --------------------------------------------------------------------------
# term statistics (planner inputs)
# --------------------------------------------------------------------------


class TermStats(NamedTuple):
    """Cheap per-term observables: f_t is one head-block field read, the
    chain length one link walk.  The engine planner routes on these."""

    ft: int = 0
    nblocks: int = 0


class CollectionStats(NamedTuple):
    """Collection-wide ranking statistics for scoring a PARTITION exactly.

    A document-partitioned shard sees only its own slice of the collection,
    so its local N, f_t, and average document length are biased estimators
    of the global ones — scoring with them breaks the byte-identical-merge
    contract every other backend honors.  A fan-out layer (``ShardedEngine``)
    maintains these three globally at ingest and hands them to every ranked
    scorer, which then weights each posting with exactly the numbers a
    single-engine oracle over the full stream would use; per-shard top-k
    merge is then exact (same doubles, same canonical tie order).

    ``ft`` maps term bytes to the global DOCUMENT frequency (never the
    word-level occurrence count — the same doc-granularity rule as
    :func:`doc_ft`).
    """

    num_docs: int
    avg_doclen: float
    ft: dict
    fts_cache: dict | None = None   # id(vocab list) -> aligned f_t array

    def doc_ft(self, term) -> int:
        tb = term.encode() if isinstance(term, str) else term
        return self.ft.get(tb, 0)

    def fts_for(self, vocab) -> "np.ndarray":
        """Global f_t aligned to an engine's term-id vocabulary (the array
        shape device images rebase their metadata with).

        With a ``fts_cache`` (the fleet maintains one, keyed by the
        identity of each engine's append-only vocab list and value-updated
        incrementally at ingest), only the suffix of terms interned since
        the last call pays a dict lookup — a device refresh never re-walks
        the whole vocabulary.  Callers must treat the returned array as
        read-only (it IS the live cache entry)."""
        if self.fts_cache is None:
            return np.asarray([self.ft.get(tb, 0) for tb in vocab],
                              dtype=np.int64)
        arr = self.fts_cache.get(id(vocab))
        V = len(vocab)
        if arr is None:
            arr = np.asarray([self.ft.get(tb, 0) for tb in vocab],
                             dtype=np.int64)
        elif len(arr) < V:
            ext = np.asarray([self.ft.get(tb, 0) for tb in vocab[len(arr):]],
                             dtype=np.int64)
            arr = np.concatenate([arr, ext]) if len(arr) else ext
        self.fts_cache[id(vocab)] = arr
        return arr


def _tombstones(index):
    """The index-like's tombstone set, or None when empty/absent.  Every
    query operator masks members of this set — deleted documents' postings
    stay in the chains (the docid space is never renumbered), so serving
    correctness lives here."""
    dead = getattr(index, "tombstones", None)
    return dead if dead else None


def _drop_dead(docids: np.ndarray, dead) -> np.ndarray:
    """Filter tombstoned docids out of a result/postings array."""
    if not dead or len(docids) == 0:
        return docids
    deadarr = np.fromiter(dead, dtype=np.int64, count=len(dead))
    return docids[~np.isin(docids, deadarr)]


def _live_postings(index, term, dead):
    """Document-granular postings with tombstoned docs removed — the shape
    every deletion-aware ranked scorer accumulates from (so live document
    frequency is simply ``len(docids)``)."""
    docids, fs = _doc_level_postings(index, term)
    if not dead or len(docids) == 0:
        return docids, fs
    deadarr = np.fromiter(dead, dtype=np.int64, count=len(dead))
    keep = ~np.isin(docids, deadarr)
    return docids[keep], fs[keep]


def term_stats(index: DynamicIndex, term) -> TermStats:
    h_ptr = index.lookup(term)
    if h_ptr is None:
        return TermStats(0, 0)
    store = index.store
    return TermStats(store.get_ft(h_ptr * store.B),
                     sum(1 for _ in store.chain_slots(h_ptr)))


def doc_ft(index, term) -> int:
    """Document frequency |{d : t ∈ d}| — the f_t every ranked scorer needs.

    Doc-level indexes read it from the head block (their stored f_t already
    counts documents); word-level chains store one posting per OCCURRENCE
    (§5.1), so their stored f_t is an occurrence count and the document
    frequency must be recovered by counting unique docids (one decode pass
    — dynamic chains have no cheaper document-granular statistic)."""
    if not getattr(index, "word_level", False):
        return index.ft(term)
    docids, _ = _doc_level_postings(index, term)
    return len(docids)


def _doc_level_postings(index, term):
    """(unique docids, doc-level f_{t,d}) — uniform over doc- and word-level
    indexes, and over index-like views.  Prefers the object's own
    ``doc_postings`` (DynamicIndex, StaticIndex, TieredView — the tiered
    view serves the frozen prefix from the compressed ⟨d,w⟩ image without
    touching positions); otherwise groups the raw occurrence stream."""
    grouped = getattr(index, "doc_postings", None)
    if grouped is not None:
        return grouped(term)
    docids, seconds = index.postings(term)
    if not getattr(index, "word_level", False):
        return docids, seconds
    return group_occurrences(docids)


# --------------------------------------------------------------------------
# conjunctive Boolean (DAAT with skipping)
# --------------------------------------------------------------------------


def conjunctive_query(index: DynamicIndex, terms) -> np.ndarray:
    """All docids containing every query term (sorted ascending, unique).

    Word-level indexes run the same DAAT loop over document-granular
    :class:`WordPostingsCursor` wrappers, so the occurrence streams'
    repeated docids never reach the intersection."""
    if not terms:
        return np.zeros(0, dtype=np.int64)
    ptrs = []
    for t in terms:
        h = index.lookup(t)
        if h is None:
            return np.zeros(0, dtype=np.int64)
        ptrs.append(h)
    # rarest-first ordering minimizes candidate count
    ptrs.sort(key=lambda h: index.store.get_ft(h * index.store.B))
    cursors = [PostingsCursor(index.store, h) for h in ptrs]
    if index.word_level:
        cursors = [WordPostingsCursor(c) for c in cursors]
    return _drop_dead(conjunctive_from_cursors(cursors), _tombstones(index))


def conjunctive_from_cursors(cursors) -> np.ndarray:
    """DAAT AND over any positioned postings cursors (``PostingsCursor``,
    ``StaticPostingsCursor``, ``ChainedCursor`` — anything speaking the
    ``next``/``seek_geq`` protocol).  Callers order rarest-first; an
    initially-exhausted (or missing) cursor makes the intersection empty."""
    if not cursors or any(c is None or c.exhausted for c in cursors):
        return np.zeros(0, dtype=np.int64)
    out = []
    lead = cursors[0]
    while not lead.exhausted:
        d = lead.docid
        ok = True
        for c in cursors[1:]:
            if not c.seek_geq(d):
                return np.asarray(out, dtype=np.int64)
            if c.docid != d:
                ok = False
                d = c.docid  # next candidate
                break
        if ok:
            out.append(d)
            if not lead.next():
                break
        else:
            if not lead.seek_geq(d):
                break
    return np.asarray(out, dtype=np.int64)


# --------------------------------------------------------------------------
# ranked disjunctive top-k (§4.6)
# --------------------------------------------------------------------------


def tfidf_weight(f_td: np.ndarray, f_t: int, N: int) -> np.ndarray:
    return np.log1p(f_td) * np.log1p(N / f_t)


def _topk_by_score(scores: np.ndarray, k: int):
    """Top-k of a dense score accumulator under the canonical tie order:
    higher score first, then LOWER docid.  One lexsort over the nonzero
    candidates — selection and ordering share the same comparator, so the
    DAAT heap, the TAAT scorers, and the tiered backend can never disagree
    on which documents sit at a tied k boundary."""
    nz = np.flatnonzero(scores)
    order = np.lexsort((nz, -scores[nz]))[:k]
    top = nz[order]
    return top.astype(np.int64), scores[top]


def ranked_disjunctive(index: DynamicIndex, terms, k: int = 10,
                       stats: CollectionStats | None = None):
    """DAAT top-k with a min-heap of "best seen so far" (paper §4.6).

    Runs over DOCUMENT-granular cursors (:func:`doc_cursor`), so on
    word-level indexes ``payload`` is f_{t,d} — never a w-gap — and the idf
    uses the true document frequency (:func:`doc_ft`), not the §5.1
    occurrence count.  Ties at the k boundary follow the canonical order
    (higher score, then lower docid): the heap compares full ``(score, -d)``
    tuples, which is exactly that order inverted.

    ``stats`` (a :class:`CollectionStats`) rebases N and f_t to the full
    collection when ``index`` is one shard of a partitioned fleet.

    Returns (docids, scores) sorted by descending score, docid ascending
    within ties.
    """
    dead = _tombstones(index)
    if stats is None:
        N = index.num_docs - (len(dead) if dead else 0)
    else:
        N = stats.num_docs
    cursors = []
    idfs = []
    for t in terms:
        c = doc_cursor(index, t)
        if c is None:
            continue
        if stats is None:
            # live document frequency: an index that never saw the dead
            # documents would count exactly the surviving ones
            ft = (len(_live_postings(index, t, dead)[0]) if dead
                  else doc_ft(index, t))
        else:
            ft = stats.doc_ft(t)
        if ft <= 0:
            continue    # every containing doc is dead ≡ unknown term
        cursors.append(c)
        idfs.append(np.log1p(N / ft))
    if not cursors:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64))
    heap: list[tuple[float, int]] = []  # (score, -docid) min-heap
    while True:
        # candidate = min current docid among live cursors
        live = [c for c in cursors if not c.exhausted]
        if not live:
            break
        d = min(c.docid for c in live)
        if dead is not None and d in dead:
            # skipped BEFORE the size-k heap: a dead entry would evict a
            # live one at the boundary, not just vanish from the output
            for c in cursors:
                if not c.exhausted and c.docid == d:
                    c.next()
            continue
        score = 0.0
        for c, idf in zip(cursors, idfs):
            if not c.exhausted and c.docid == d:
                score += np.log1p(c.payload) * idf
                c.next()
        if len(heap) < k:
            heapq.heappush(heap, (score, -d))
        elif (score, -d) > heap[0]:
            heapq.heapreplace(heap, (score, -d))
    items = sorted(heap, key=lambda x: (-x[0], -x[1]))
    return (np.asarray([-d for _, d in items], dtype=np.int64),
            np.asarray([s for s, _ in items], dtype=np.float64))


def ranked_disjunctive_taat(index, terms, k: int = 10,
                            stats: CollectionStats | None = None):
    """Vectorized term-at-a-time scorer (identical results, numpy-fast).

    The paper notes (§4.2) TAAT shares the document-sorted index requirement,
    so this is a legitimate execution strategy over the same structure.
    Accepts any index-like with ``num_docs`` + postings access (DynamicIndex,
    TieredView, sharded fan-outs); word-level indexes are scored through
    :func:`_doc_level_postings`, so f_{t,d}/f_t are document-level — the
    occurrence stream's repeated docids and w-gap payloads never reach the
    accumulator.  ``stats`` rebases N and f_t to the full collection when
    ``index`` is one shard of a partitioned fleet (the accumulator stays
    sized by the LOCAL docid space; only the idf arithmetic goes global).
    """
    N = index.num_docs
    dead = _tombstones(index)
    if stats is None:
        Ns = N - (len(dead) if dead else 0)
    else:
        Ns = stats.num_docs
    scores = np.zeros(N + 1, dtype=np.float64)
    touched = False
    for t in terms:
        # dead docs never reach the accumulator, so live df is len(docids)
        docids, fs = _live_postings(index, t, dead)
        if len(docids) == 0:
            continue
        touched = True
        ft = len(docids) if stats is None else stats.doc_ft(t)
        scores[docids] += tfidf_weight(fs, ft, Ns)
    if not touched:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64))
    return _topk_by_score(scores, k)


# --------------------------------------------------------------------------
# brute-force oracle (tests)
# --------------------------------------------------------------------------


def brute_conjunctive(index: DynamicIndex, terms) -> np.ndarray:
    sets = []
    for t in terms:
        docids, _ = index.postings(t)
        sets.append(set(int(x) for x in docids))
    if not sets:
        return np.zeros(0, dtype=np.int64)
    inter = set.intersection(*sets)
    dead = _tombstones(index)
    if dead:
        inter -= dead
    return np.asarray(sorted(inter), dtype=np.int64)


# --------------------------------------------------------------------------
# BM25 ranked querying (paper §6.2's stated future work)
# --------------------------------------------------------------------------
#
# "Our immediate next goal will be to consider how to integrate responsive
#  querying modes ... using similarity scoring models such as BM25."
# The only extra state BM25 needs beyond the paper's index is the document-
# length array, which §3.6 explicitly places outside the core index ("we
# consider that to be not part of the core inverted index").  DynamicIndex
# callers maintain it trivially at ingest: doclens.append(len(terms)).


def _live_avg_doclen(doclens: np.ndarray, N: int, dead) -> float:
    """Average document length over LIVE docs only — the avgdl an index
    that never ingested the tombstoned documents would report."""
    if not N:
        return 0.0
    total = float(doclens[1:N + 1].sum())
    live_n = N
    if dead:
        deadarr = np.fromiter(dead, dtype=np.int64, count=len(dead))
        total -= float(doclens[deadarr].sum())
        live_n -= len(dead)
    return total / live_n if live_n else 0.0


def bm25_weight(f_td, doclen, avg_len, f_t, N, k1=0.9, b=0.4):
    idf = np.log(1.0 + (N - f_t + 0.5) / (f_t + 0.5))
    tf = (f_td * (k1 + 1.0)) / (
        f_td + k1 * (1.0 - b + b * doclen / max(avg_len, 1e-9)))
    return idf * tf


def ranked_bm25(index, terms, doclens: np.ndarray,
                k: int = 10, k1: float = 0.9, b: float = 0.4,
                stats: CollectionStats | None = None):
    """Top-k BM25 (TAAT; doclens is 1-indexed via position 0 padding).

    Like :func:`ranked_disjunctive_taat`, accepts any index-like and scores
    word-level indexes through document-granular postings, so f_{t,d} and
    f_t are doc-level everywhere.  ``stats`` rebases N, f_t, AND the average
    document length to the full collection when ``index`` is one shard of a
    partitioned fleet (``doclens`` stays the shard-local array — each doc's
    own length is partition-invariant).  Returns (docids, scores) by
    descending score, docid ascending within ties."""
    N = index.num_docs
    dead = _tombstones(index)
    if stats is None:
        Ns = N - (len(dead) if dead else 0)
        avg = _live_avg_doclen(doclens, N, dead)
    else:
        Ns = stats.num_docs
        avg = stats.avg_doclen
    scores = np.zeros(N + 1, dtype=np.float64)
    for t in terms:
        docids, fs = _live_postings(index, t, dead)
        if len(docids) == 0:
            continue
        ft = len(docids) if stats is None else stats.doc_ft(t)
        scores[docids] += bm25_weight(
            fs.astype(np.float64), doclens[docids], avg, ft, Ns, k1, b)
    return _topk_by_score(scores, k)


# --------------------------------------------------------------------------
# phrase querying over the word-level index (the paper's §1.1 motivation
# for word-level postings: "to support phrase or proximity querying modes")
# --------------------------------------------------------------------------


def phrase_from_cursors(cursors) -> np.ndarray:
    """Documents where ``cursors`` (one POSITIONAL cursor per phrase slot,
    in phrase order) align consecutively: doc matches iff some position p
    has cursors[i] occurring at p+i for every i.

    Works over anything speaking the positional protocol —
    :class:`WordPostingsCursor` (dynamic chains), :class:`~repro_torch.core.
    static_index.StaticWordCursor` (compressed tier), and
    :class:`ChainedCursor` chains of the two — so the tiered backend
    evaluates phrases without materializing either tier.  DAAT over docids
    with ``seek_geq`` skipping; positions are intersected (with slot
    offsets) only on documents containing every term.  Cursor order is
    semantic (slot i's positions shift by i), hence no rarest-first
    reordering here."""
    if not cursors or any(c is None or c.exhausted for c in cursors):
        return np.zeros(0, dtype=np.int64)
    out = []
    lead = cursors[0]
    while not lead.exhausted:
        d = lead.docid
        ok = True
        for c in cursors[1:]:
            if not c.seek_geq(d):
                return np.asarray(out, dtype=np.int64)
            if c.docid != d:
                ok = False
                d = c.docid
                break
        if ok:
            starts = lead.positions()
            for i, c in enumerate(cursors[1:], start=1):
                starts = np.intersect1d(starts, c.positions() - i,
                                        assume_unique=True)
                if len(starts) == 0:
                    break
            if len(starts):
                out.append(d)
            if not lead.next():
                break
        else:
            if not lead.seek_geq(d):
                break
    return np.asarray(out, dtype=np.int64)


def phrase_query(index: DynamicIndex, terms) -> np.ndarray:
    """Documents containing ``terms`` as a consecutive phrase (word-level
    index required).  One positional DAAT pass via
    :func:`phrase_from_cursors` — repeated phrase terms get independent
    cursors, one per slot."""
    if not index.word_level:
        raise ValueError("phrase_query needs a word-level index (§5.1)")
    if not terms:
        return np.zeros(0, dtype=np.int64)
    return _drop_dead(phrase_from_cursors([word_cursor(index, t)
                                           for t in terms]),
                      _tombstones(index))


# --------------------------------------------------------------------------
# proximity querying (§1.1's "phrase or proximity querying modes"): DAAT over
# the positional cursor protocol — no wholesale decode of any tier
# --------------------------------------------------------------------------


def _window_match(pos_lists, counts, window: int) -> bool:
    """True iff some window of span <= ``window`` contains >= counts[i]
    DISTINCT positions of term i for every i — the injective-binding
    semantics for repeated query terms (a doc with one occurrence of "a"
    must NOT match the query ["a", "a"]).  Two-pointer sweep over the
    merged position list: the maximal window ending at each rightmost
    occurrence dominates every sub-window, so the sweep is complete."""
    positions = np.concatenate(pos_lists)
    labels = np.concatenate(
        [np.full(len(ws), i) for i, ws in enumerate(pos_lists)])
    order = np.argsort(positions, kind="stable")
    positions, labels = positions[order], labels[order]
    have = [0] * len(pos_lists)
    satisfied = 0
    left = 0
    for right in range(len(positions)):
        lr = labels[right]
        have[lr] += 1
        if have[lr] == counts[lr]:
            satisfied += 1
        while positions[right] - positions[left] > window:
            ll = labels[left]
            if have[ll] == counts[ll]:
                satisfied -= 1
            have[ll] -= 1
            left += 1
        if satisfied == len(pos_lists):
            return True
    return False


def proximity_from_cursors(cursors, window: int, counts=None) -> np.ndarray:
    """Documents where the cursors' terms co-occur within ``window`` words.

    One POSITIONAL document-granular cursor per UNIQUE query term;
    ``counts[i]`` is that term's multiplicity in the query — a match must
    bind that many DISTINCT positions of it inside one window.  Like
    :func:`phrase_from_cursors`, works over anything speaking the
    positional protocol (``WordPostingsCursor``, ``StaticWordCursor``,
    ``ChainedCursor``), so the tiered backend evaluates proximity without
    materializing either tier: DAAT over docids with ``seek_geq`` skipping,
    positions touched only on documents containing every term."""
    if counts is None:
        counts = [1] * len(cursors)
    if not cursors or any(c is None or c.exhausted for c in cursors):
        return np.zeros(0, dtype=np.int64)
    out = []
    lead = cursors[0]
    while not lead.exhausted:
        d = lead.docid
        ok = True
        for c in cursors[1:]:
            if not c.seek_geq(d):
                return np.asarray(out, dtype=np.int64)
            if c.docid != d:
                ok = False
                d = c.docid
                break
        if ok:
            # payload = f_{t,d}: a doc lacking m occurrences can't bind them
            if (all(c.payload >= m for c, m in zip(cursors, counts))
                    and _window_match([c.positions() for c in cursors],
                                      counts, window)):
                out.append(d)
            if not lead.next():
                break
        else:
            if not lead.seek_geq(d):
                break
    return np.asarray(out, dtype=np.int64)


def proximity_query(index, terms, window: int) -> np.ndarray:
    """Documents where all ``terms`` co-occur within ``window`` words
    (word-level index required; repeated terms bind distinct positions).
    Accepts a DynamicIndex or a tiered view (anything
    :func:`positional_cursor` serves)."""
    if not getattr(index, "word_level", False):
        raise ValueError("proximity_query needs a word-level index")
    if not terms:
        return np.zeros(0, dtype=np.int64)
    need: dict = {}
    for t in terms:
        need[t] = need.get(t, 0) + 1
    items = list(need.items())
    ft = getattr(index, "ft", None)
    if ft is not None:
        # unlike phrase, proximity is term-order-symmetric: lead with the
        # rarest term so the DAAT loop skips instead of enumerating the
        # most common term's documents (f_t is an O(1) head-block read on
        # the dynamic index, an engine counter on the tiered view)
        items.sort(key=lambda kv: ft(kv[0]))
    return _drop_dead(proximity_from_cursors(
        [positional_cursor(index, t) for t, _ in items],
        window, [m for _, m in items]), _tombstones(index))


# --------------------------------------------------------------------------
# position-aware ranked querying: BM25 + MinDist proximity bonus (Tao & Zhai
# 2007, "An exploration of proximity measures in information retrieval") —
# the §5.1 payoff for carrying word positions into the ranked path
# --------------------------------------------------------------------------


def min_pair_dist(pos_lists):
    """Minimum |p - q| over occurrences p, q of two DIFFERENT terms, or
    None when fewer than two of the lists are non-empty.  The closest
    cross-term pair is always adjacent in the merged position order (any
    position between them would form a closer pair with one end), so one
    linear scan over the merge suffices."""
    lists = [p for p in pos_lists if p is not None and len(p)]
    if len(lists) < 2:
        return None
    positions = np.concatenate(lists)
    labels = np.concatenate(
        [np.full(len(p), i) for i, p in enumerate(lists)])
    order = np.argsort(positions, kind="stable")
    positions, labels = positions[order], labels[order]
    gaps = np.diff(positions)[labels[1:] != labels[:-1]]
    return int(gaps.min()) if len(gaps) else None


def ranked_bm25_prox(index, terms, doclens: np.ndarray, k: int = 10,
                     k1: float = 0.9, b: float = 0.4, alpha: float = 1.0,
                     stats: CollectionStats | None = None):
    """Position-aware top-k: BM25 plus the MinDist additive term —

        score(d) = BM25(d) + ln(alpha + exp(-delta(d)))

    where delta(d) is the minimum distance between occurrences of two
    DISTINCT query terms in d (delta = +inf, i.e. bonus = ln(alpha), when
    fewer than two distinct terms are present; the default alpha = 1 makes
    that bonus exactly 0).  Word-level only — the whole point is consuming
    positions on the ranked path.  Evaluated through the document-granular
    positional cursors (:func:`positional_cursor`), so a TieredView serves
    it from the compressed ⟨d,w⟩ tier byte-identically to the host path.
    Returns (docids, scores) by descending score, docid ascending on ties.
    """
    if not getattr(index, "word_level", False):
        raise ValueError("ranked_bm25_prox needs a word-level index")
    N = index.num_docs
    dead = _tombstones(index)
    if stats is None:
        Ns = N - (len(dead) if dead else 0)
        avg = _live_avg_doclen(doclens, N, dead)
    else:
        Ns = stats.num_docs
        avg = stats.avg_doclen
    # pass 1 — the plain BM25 TAAT accumulation over doc-level postings
    # (the tiered view's doc_postings never touches the w-gap stream);
    # tombstoned docs are dropped at the gather, so they neither score nor
    # count toward presence in the positional pass
    uniq = list(dict.fromkeys(terms))
    gathered = {t: _live_postings(index, t, dead) for t in uniq}
    scores = np.zeros(N + 1, dtype=np.float64)
    for t in terms:  # repeated query terms contribute per slot, as in BM25
        ds, fs = gathered[t]
        if len(ds) == 0:
            continue
        ft = len(ds) if stats is None else stats.doc_ft(t)
        scores[ds] += bm25_weight(fs.astype(np.float64), doclens[ds], avg,
                                  ft, Ns, k1, b)
    # pass 2 — positions only where the bonus can be nonzero: docs holding
    # >= 2 distinct query terms, visited by a fresh seek_geq-skipping
    # positional cursor (lazy ⟨d,w⟩ block decode on the static tier)
    present = np.zeros(N + 1, dtype=np.int64)
    for t in uniq:
        present[gathered[t][0]] += 1
    multi = np.flatnonzero(present >= 2)
    pos_of: dict = {t: {} for t in uniq}
    for t in uniq:
        need = multi[np.isin(multi, gathered[t][0], assume_unique=True)]
        if len(need) == 0:
            continue
        c = positional_cursor(index, t)
        for d in need:  # ascending, and every d is in the term's list
            c.seek_geq(int(d))
            pos_of[t][int(d)] = c.positions()
    # every matched doc gets exactly one bonus addition: ln(alpha) when
    # fewer than two distinct terms are present (delta = +inf), else the
    # full MinDist term — BM25 weights are > 0, so multi ⊆ nonzero
    nz = np.flatnonzero(scores)
    scores[nz[present[nz] < 2]] += np.log(alpha)
    for d in multi:
        delta = min_pair_dist([pos_of[t].get(int(d)) for t in uniq])
        scores[d] += np.log(alpha + np.exp(-float(delta)))
    return _topk_by_score(scores, k)
