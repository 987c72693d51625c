"""Document pre-processing for the batched write path (ROADMAP: paper-scale
ingest, after Asadi & Lin's pipelined in-memory indexer).

Tokenization, term-byte encoding and within-document aggregation are pure
functions of the document — no index state — so they can run off the writer
thread (``serve.ingest_pipeline`` runs them on the submitting caller; the
per-shard writer threads then consume only :class:`PreparedDoc` records and
spend their time appending postings).

A :class:`PreparedDoc` carries exactly what both halves of an ingest need:

  * ``uniq``/``counts`` — unique term bytes in first-occurrence order with
    their within-document frequencies (doc-level postings, forward-index
    entries, df updates);
  * ``occs`` — the word-level occurrence stream ``(term, w-gap)`` in word
    order (§5.1: the w-payload is the gap to the previous occurrence of the
    SAME term in this document, or the absolute 1-based position for its
    first occurrence), ``None`` for doc-level preparation.

First-occurrence order matters: it is the order a sequential per-document
ingest interns terms in, and batch≡sequential parity (same term ids, same
vocabulary order, same forward-index entries) depends on reproducing it.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass


@dataclass(frozen=True)
class PreparedDoc:
    """One tokenized, aggregated document, ready for the writer thread."""

    doclen: int                                     # token count
    uniq: tuple[bytes, ...]                         # first-occurrence order
    counts: tuple[int, ...]                         # f_{t,d} per uniq entry
    occs: tuple[tuple[bytes, int], ...] | None = None  # word-level stream


def prepare_doc(terms, word_level: bool = False) -> PreparedDoc:
    """Tokenize one document (a sequence of term strings/bytes).

    Pure function — safe on any thread.  The byte encoding and the
    Counter-style aggregation here are exactly what ``add_document``
    performs inline; moving them off the writer thread is what lets the
    writer consume pre-mapped arrays only.
    """
    if word_level:
        counts: dict[bytes, int] = {}
        occs: list[tuple[bytes, int]] = []
        last_w: dict[bytes, int] = {}
        for w, t in enumerate(terms, start=1):
            tb = t.encode() if isinstance(t, str) else t
            prev = last_w.get(tb)
            occs.append((tb, w if prev is None else w - prev))
            last_w[tb] = w
            counts[tb] = counts.get(tb, 0) + 1
        return PreparedDoc(doclen=len(occs), uniq=tuple(counts),
                           counts=tuple(counts.values()), occs=tuple(occs))
    # doc-level: Counter's C-level counting keeps first-occurrence key
    # order (it is a dict), which the intern-order parity relies on.
    # Counting BEFORE encoding means only unique terms pay the encode.
    counts = Counter(terms)
    try:
        uniq = tuple(map(str.encode, counts))
    except TypeError:
        # bytes (or mixed str/bytes) tokens: a str token and its bytes
        # twin must merge, so encode every token first, then count
        tbs = [t.encode() if type(t) is str else t for t in terms]
        counts = Counter(tbs)
        return PreparedDoc(doclen=len(tbs), uniq=tuple(counts),
                           counts=tuple(counts.values()))
    cv = tuple(counts.values())
    return PreparedDoc(doclen=sum(cv), uniq=uniq, counts=cv)


def prepare_batch(docs, word_level: bool = False) -> list[PreparedDoc]:
    """Prepare a batch of documents (each a term sequence or an already
    prepared record, passed through unchanged)."""
    return [d if isinstance(d, PreparedDoc) else prepare_doc(d, word_level)
            for d in docs]


__all__ = ["PreparedDoc", "prepare_doc", "prepare_batch"]
