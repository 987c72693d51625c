"""DynamicIndex: the immediate-access index of paper §3 (ingest side).

Combines the BlockStore (Figure 3 / Algorithm 1) with the vocabulary hash
array of §3.2: "a hash array of 32-bit integers that stores block offsets ...
twice the size of the collection vocabulary (using an extensible hashing
technique) ... a simple linear advance collision resolution technique",
giving O(|t|+1) expected lookup.  The hash array stores h_ptr+1 (0 = empty
slot) and is costed at ``4 * len(hash)`` bytes, which equals the paper's
``8v`` when the load factor is 1/2.

Documents are ordinal, 1-based (d-gaps must be >= 1).  ``add_document``
implements §3.3: parse, sort-count term occurrences, then one ``add_posting``
per unique term (doc-level) or per occurrence (word-level §5.1).

Ingest and query may interleave freely: the structure is always consistent
after each ``add_document`` returns (the paper's immediate-access property).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from .blockstore import BlockStore, H
from .extensible import GrowthPolicy, make_policy
from .prepare import PreparedDoc, prepare_batch

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def fnv1a(term: bytes) -> int:
    """FNV-1a 64-bit hash, folded to 32 bits (cheap, good avalanche)."""
    h = _FNV_OFFSET
    for b in term:
        h = np.uint64((int(h) ^ b) * int(_FNV_PRIME) & 0xFFFFFFFFFFFFFFFF)
    return (int(h) ^ (int(h) >> 32)) & 0xFFFFFFFF


def group_occurrences(docids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(unique docids, run-length counts) of a non-decreasing occurrence
    stream — the one implementation of the doc-level grouping invariant
    (word-level postings repeat a docid once per occurrence, so the
    run-lengths ARE the per-document f_{t,d}), shared by the dynamic index,
    the query helpers, and the tiered view."""
    if len(docids) == 0:
        return docids, docids.copy()
    udocs, counts = np.unique(docids, return_counts=True)
    return udocs, counts.astype(np.int64)


class DynamicIndex:
    """An immediate-access dynamic inverted index (document- or word-level)."""

    def __init__(self, B: int = 64, growth: str | GrowthPolicy = "const",
                 F: int | None = None, word_level: bool = False,
                 expon_k: float = 1.1, initial_hash_bits: int = 10):
        policy = (growth if isinstance(growth, GrowthPolicy)
                  else make_policy(growth, B, expon_k))
        if F is None:
            F = 3 if word_level else 4  # paper defaults (§3.5, §5.1)
        self.store = BlockStore(B=B, policy=policy, F=F, word_level=word_level)
        self.word_level = word_level
        self.F = F
        self.hash = np.zeros(1 << initial_hash_bits, dtype=np.uint32)
        self.vocab_size = 0
        self.num_docs = 0
        self.num_postings = 0
        self.num_words = 0
        # deleted docids (docid SPACE is never renumbered — postings stay in
        # the BlockStore and every serving path masks members of this set;
        # the next static freeze drops them from the encoded tier instead)
        self.tombstones: set[int] = set()
        # host-side acceleration cache (pure cache of hash-array content; the
        # probe path below is the structure of record and tested against it)
        self._cache: dict[bytes, int] = {}

    # ------------------------------------------------------------------
    # vocabulary hash (§3.2)
    # ------------------------------------------------------------------

    def _probe(self, term: bytes):
        """Return (h_ptr or None, slot_index) via linear probing."""
        mask = len(self.hash) - 1
        i = fnv1a(term) & mask
        while True:
            v = int(self.hash[i])
            if v == 0:
                return None, i
            h_ptr = v - 1
            if self.store.term_bytes(h_ptr * self.store.B) == term:
                return h_ptr, i
            i = (i + 1) & mask

    def _grow_hash(self) -> None:
        old = self.hash
        self.hash = np.zeros(len(old) * 2, dtype=np.uint32)
        mask = len(self.hash) - 1
        for v in old[old != 0]:
            h_ptr = int(v) - 1
            term = self.store.term_bytes(h_ptr * self.store.B)
            i = fnv1a(term) & mask
            while self.hash[i] != 0:
                i = (i + 1) & mask
            self.hash[i] = v

    def lookup(self, term) -> int | None:
        """Term -> head-block slot pointer, or None."""
        tb = term.encode() if isinstance(term, str) else term
        hit = self._cache.get(tb)
        if hit is not None:
            return hit
        h_ptr, _ = self._probe(tb)
        return h_ptr

    def _lookup_or_create(self, tb: bytes) -> int:
        hit = self._cache.get(tb)
        if hit is not None:
            return hit
        h_ptr, slot = self._probe(tb)
        if h_ptr is None:
            if 2 * (self.vocab_size + 1) > len(self.hash):
                self._grow_hash()
                _, slot = self._probe(tb)
            h_ptr = self.store.new_head(tb)
            self.hash[slot] = h_ptr + 1
            self.vocab_size += 1
        self._cache[tb] = h_ptr
        return h_ptr

    # ------------------------------------------------------------------
    # ingest (§3.3)
    # ------------------------------------------------------------------

    def add_document(self, terms) -> int:
        """Ingest one document (a sequence of term strings/bytes).

        Returns the assigned ordinal document identifier (1-based).  The
        document is findable by queries the moment this method returns.
        """
        self.num_docs += 1
        d = self.num_docs
        self.num_words += len(terms)
        if self.word_level:
            # §5.1: one posting per occurrence, in word order (w is 1-based);
            # w-payload = w-gap since the previous same-doc occurrence.
            last_w: dict[bytes, int] = {}
            for w, t in enumerate(terms, start=1):
                tb = t.encode() if isinstance(t, str) else t
                h_ptr = self._lookup_or_create(tb)
                prev = last_w.get(tb)
                wgap = w if prev is None else w - prev
                last_w[tb] = w
                self.store.add_posting(h_ptr, d, wgap)
                self.num_postings += 1
        else:
            # sort-count within the document, then one posting per term
            counts = Counter(t.encode() if isinstance(t, str) else t
                             for t in terms)
            for tb, f in counts.items():
                h_ptr = self._lookup_or_create(tb)
                self.store.add_posting(h_ptr, d, f)
                self.num_postings += 1
        return d

    def add_documents(self, docs) -> list[int]:
        """Batched §3.3 ingest: returns the assigned docids, ascending.

        Answer-identical to a per-document :meth:`add_document` loop (same
        docids, same decoded chains, same vocabulary order), but the
        batch's postings are grouped per term first, so each term pays ONE
        chain-tail lookup and one staged Double-VByte append run
        (:meth:`BlockStore.append_run`) for the whole batch instead of the
        per-posting accessor walk.  Block ALLOCATION order differs from
        sequential ingest (all new heads first, overflow blocks per run),
        so the raw block array is not byte-comparable — every decoded
        answer is.

        ``docs`` may be raw term sequences or pre-tokenized
        :class:`~repro_torch.core.prepare.PreparedDoc` records (the pipelined
        write path prepares off the writer thread).
        """
        return self.add_prepared(prepare_batch(docs, self.word_level))

    def add_prepared(self, prepared: list[PreparedDoc]) -> list[int]:
        """Ingest pre-tokenized documents (see :meth:`add_documents`)."""
        word = self.word_level
        runs: dict[bytes, list] = {}
        dids: list[int] = []
        d = self.num_docs
        nw = np_ = 0
        for p in prepared:
            d += 1
            dids.append(d)
            nw += p.doclen
            if word:
                np_ += len(p.occs)
                for tb, wgap in p.occs:
                    try:
                        runs[tb].append((d, wgap))
                    except KeyError:
                        runs[tb] = [(d, wgap)]
            else:
                np_ += len(p.uniq)
                for tb, f in zip(p.uniq, p.counts):
                    try:
                        runs[tb].append((d, f))
                    except KeyError:
                        runs[tb] = [(d, f)]
        self.num_words += nw
        self.num_postings += np_
        self.num_docs = d
        # runs iterate in first-occurrence order across the batch — the
        # same head-creation (and engine intern) order sequential ingest
        # would have produced
        append_run = self.store.append_run
        lookup = self._lookup_or_create
        for tb, run in runs.items():
            append_run(lookup(tb), run)
        return dids

    def add_runs(self, ndocs: int, nwords: int, npostings: int,
                 groups) -> None:
        """Append pre-grouped per-term posting runs.

        The fused batch path: ``Engine.add_documents`` groups the batch's
        postings per term during its own interning/bookkeeping pass and
        hands the runs straight down — one traversal of the batch instead
        of the second one :meth:`add_prepared` would cost on top.

        ``groups`` is an iterable of ``(term_bytes, [(d, f), ...])`` with
        each run in ingest order and terms in first-occurrence order (the
        head-creation order a sequential ingest would have produced);
        counters advance by the caller-computed totals.
        """
        append_run = self.store.append_run
        lookup = self._lookup_or_create
        for tb, run in groups:
            append_run(lookup(tb), run)
        self.num_docs += ndocs
        self.num_words += nwords
        self.num_postings += npostings

    def delete_document(self, docid: int) -> None:
        """Tombstone one document (the takedown primitive).

        The docid keeps its ordinal meaning — postings stay in the
        BlockStore and ``num_docs`` is NOT decremented, so round-robin
        arithmetic, tier horizons, and device images are all unaffected.
        Serving paths mask tombstoned docids; the next static freeze drops
        them from the encoded tier (see ``StaticIndex.freeze``)."""
        if not 1 <= docid <= self.num_docs:
            raise ValueError(f"docid {docid} out of range "
                             f"[1, {self.num_docs}]")
        if docid in self.tombstones:
            raise ValueError(f"docid {docid} already deleted")
        self.tombstones.add(docid)

    def clone(self) -> "DynamicIndex":
        """Deep snapshot sharing no mutable state with the original.

        One memcpy of the block array plus the hash array — cheap relative
        to any decode pass.  The lifecycle freeze hands the clone to a
        background thread for static conversion while ingest continues into
        the original (single-writer model preserved: the clone has no
        writer at all)."""
        out = DynamicIndex.__new__(DynamicIndex)
        out.store = self.store.clone()
        out.word_level = self.word_level
        out.F = self.F
        out.hash = self.hash.copy()
        out.vocab_size = self.vocab_size
        out.num_docs = self.num_docs
        out.num_postings = self.num_postings
        out.num_words = self.num_words
        out.tombstones = set(self.tombstones)
        out._cache = {}
        return out

    # ------------------------------------------------------------------
    # read access
    # ------------------------------------------------------------------

    def postings(self, term):
        """Decode a term's postings: (docids, f) doc-level or (docids, wgaps)."""
        h_ptr = self.lookup(term)
        if h_ptr is None:
            return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
        return self.store.decode_postings(h_ptr)

    def doc_postings(self, term):
        """Document-granular postings: (unique docids, doc-level f_{t,d}).

        Identical to :meth:`postings` on doc-level indexes; word-level
        occurrence streams are grouped (docids are non-decreasing, so the
        run-lengths ARE the per-doc counts).  This is the shape every
        ranked scorer consumes — w-gaps must never be mistaken for term
        frequencies."""
        docids, seconds = self.postings(term)
        if not self.word_level:
            return docids, seconds
        return group_occurrences(docids)

    def ft(self, term) -> int:
        h_ptr = self.lookup(term)
        if h_ptr is None:
            return 0
        return self.store.get_ft(h_ptr * self.store.B)

    def head_ptrs(self):
        """All head-block slot pointers (via the hash array)."""
        return [int(v) - 1 for v in self.hash[self.hash != 0]]

    def terms(self):
        for h_ptr in self.head_ptrs():
            yield self.store.term_bytes(h_ptr * self.store.B), h_ptr

    # ------------------------------------------------------------------
    # space accounting (Tables 7/8/11/13: "all index costs")
    # ------------------------------------------------------------------

    def hash_bytes(self) -> int:
        return len(self.hash) * 4

    def total_bytes(self) -> int:
        return self.store.used_bytes() + self.hash_bytes()

    def bytes_per_posting(self) -> float:
        return self.total_bytes() / max(1, self.num_postings)

    def breakdown(self) -> dict:
        stats = self.store.component_breakdown(self.head_ptrs())
        stats["hash_bytes"] = self.hash_bytes()
        stats["total_bytes"] = self.total_bytes()
        stats["num_postings"] = self.num_postings
        stats["bytes_per_posting"] = self.bytes_per_posting()
        return stats

    def stats(self) -> dict:
        """Cheap O(1) summary counters (no chain walk, unlike
        ``breakdown``).  ``num_words`` counts every ingested token, so for
        word-level indexes ``bytes_per_posting`` IS the paper's §5.1
        bytes-per-word figure (one posting per occurrence) and for
        doc-level indexes ``bytes_per_word`` amortizes the index over the
        collection's token count (Table 11's denominator)."""
        return {
            "num_docs": self.num_docs,
            "deleted_docs": len(self.tombstones),
            "num_postings": self.num_postings,
            "num_words": self.num_words,
            "vocab_size": self.vocab_size,
            "word_level": self.word_level,
            "total_bytes": self.total_bytes(),
            "bytes_per_posting": self.bytes_per_posting(),
            "bytes_per_word": self.total_bytes() / max(1, self.num_words),
        }
