"""Static compressed inverted index (paper §3.1, Table 9 reference systems).

The dynamic shard is periodically frozen into a static, maximally-compressed
form (Figure 2).  We implement two static codecs standing in for the paper's
PISA baselines:

  * ``bp128``  — blocks of 128 d-gaps bit-packed at the per-block maximum
    width plus per-block skip data (the SIMD-BP128 layout of Lemire &
    Boytsov, as used by PISA-BP128);
  * ``interp`` — binary interpolative coding (Moffat & Stuiver), the
    PISA-Interp stand-in: docids coded recursively mid-first with minimal
    binary ranges; frequencies coded interpolatively over their prefix sums.

``freeze`` converts a DynamicIndex (one full decode + re-encode pass — the
paper's "fast conversion of the dynamic index to a 'normal' static compressed
inverted index"), and both codecs are measured in benchmarks/table9.

Beyond the offline Table-9 measurement, the static index is a live SERVING
tier (see ``core/lifecycle.py``): ``postings_iter`` returns a
:class:`StaticPostingsCursor` with the same ``next``/``seek_geq`` protocol as
``core.query.PostingsCursor``, so DAAT conjunctive evaluation runs directly
over the compressed image.  For bp128 the cursor skips block-at-a-time using
a per-list skip table (last docid per 128-gap block, recorded at encode
time; the in-stream bit offsets are recovered from the existing 5-bit width
headers, so the only extra stored state is one docid per block).  Interp has
no block structure — its cursor decodes the list once and seeks by binary
search.

Word-level indexes (§5.1's ⟨d,w⟩ postings — the paper's "only a small amount
more for word-level indexing") freeze too: each term's occurrence stream is
regrouped into three streams — unique-docid d-gaps, per-doc position counts,
and the flat within-doc w-gap stream — each coded under the list's codec.
The docid stream keeps the exact doc-level block structure, so the bp128
skip table still skips BY DOCID and ``seek_geq`` is unchanged; positions are
decoded lazily (per 128-occurrence block) only when a phrase/proximity
operator asks for them via :meth:`StaticWordCursor.positions`.  Under interp
the counts are coded as strictly-increasing prefix sums (the frequency
trick) and the w-gaps as their own prefix-sum sequence, which is strictly
increasing because every w-gap is >= 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .index import DynamicIndex

# --------------------------------------------------------------------------
# bit-level IO
# --------------------------------------------------------------------------


class BitWriter:
    def __init__(self):
        self.words: list[int] = []
        self._cur = 0
        self._fill = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._cur |= (value & ((1 << nbits) - 1)) << self._fill
        self._fill += nbits
        while self._fill >= 32:
            self.words.append(self._cur & 0xFFFFFFFF)
            self._cur >>= 32
            self._fill -= 32

    def flush(self) -> np.ndarray:
        if self._fill:
            self.words.append(self._cur & 0xFFFFFFFF)
            self._cur = 0
            self._fill = 0
        return np.asarray(self.words, dtype=np.uint32)

    def bit_length(self) -> int:
        return 32 * len(self.words) + self._fill


class BitReader:
    def __init__(self, words: np.ndarray):
        self.words = words
        self.pos = 0

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        out = 0
        got = 0
        while got < nbits:
            w = int(self.words[self.pos >> 5])
            off = self.pos & 31
            take = min(32 - off, nbits - got)
            out |= ((w >> off) & ((1 << take) - 1)) << got
            got += take
            self.pos += take
        return out


def _bits_for(x: int) -> int:
    return max(1, int(x).bit_length())


# --------------------------------------------------------------------------
# binary interpolative coding
# --------------------------------------------------------------------------


def interp_encode(arr: np.ndarray, lo: int, hi: int, w: BitWriter) -> None:
    """Recursively encode a strictly-increasing sequence within [lo, hi]."""
    n = len(arr)
    if n == 0:
        return
    if hi - lo + 1 == n:
        return  # fully dense range: zero bits needed
    mid = n // 2
    x = int(arr[mid])
    a = lo + mid                 # minimum possible value of arr[mid]
    b = hi - (n - 1 - mid)       # maximum possible value
    span = b - a + 1
    if span > 1:
        w.write(x - a, _bits_for(span - 1))
    interp_encode(arr[:mid], lo, x - 1, w)
    interp_encode(arr[mid + 1:], x + 1, hi, w)


def interp_decode(n: int, lo: int, hi: int, r: BitReader, out: list) -> None:
    if n == 0:
        return
    if hi - lo + 1 == n:
        out.extend(range(lo, hi + 1))
        return
    mid = n // 2
    a = lo + mid
    b = hi - (n - 1 - mid)
    span = b - a + 1
    x = a + (r.read(_bits_for(span - 1)) if span > 1 else 0)
    left: list = []
    interp_decode(mid, lo, x - 1, r, left)
    out.extend(left)
    out.append(x)
    right: list = []
    interp_decode(n - 1 - mid, x + 1, hi, r, right)
    out.extend(right)


# --------------------------------------------------------------------------
# BP128-style bitpacking
# --------------------------------------------------------------------------

BP_BLOCK = 128


def bp_encode(values: np.ndarray, w: BitWriter) -> int:
    """Pack ``values`` in blocks of 128 at per-block max width.

    Returns total overhead bits (the 5-bit width headers)."""
    overhead = 0
    for i in range(0, len(values), BP_BLOCK):
        blk = values[i:i + BP_BLOCK]
        width = _bits_for(int(blk.max()))
        w.write(width, 5)
        overhead += 5
        for v in blk:
            w.write(int(v), width)
    return overhead


def bp_decode(n: int, r: BitReader) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    i = 0
    while i < n:
        cnt = min(BP_BLOCK, n - i)
        width = r.read(5)
        for j in range(cnt):
            out[i + j] = r.read(width)
        i += cnt
    return out


# --------------------------------------------------------------------------
# the static index
# --------------------------------------------------------------------------


@dataclass
class TermList:
    """One term's compressed postings plus serving metadata.

    ``d_last`` (bp128 only) is the skip table: the docid of the last posting
    in each 128-gap block, ascending — ``seek_geq`` binary-searches it to
    land on the one block that must be decoded.  ``d_bits``/``f_bits`` cache
    the bit offset of each docid/frequency block's 5-bit width header; they
    are *derived* from the headers on first cursor use, not stored, so they
    cost no index bytes.

    Word-level lists reuse the same record: ``n`` counts UNIQUE docids (so
    docid block geometry and the skip table are identical to doc-level),
    ``sum_f`` is the total occurrence count (= length of the w-gap stream),
    and ``sum_w`` bounds the interp prefix-sum coding of the w-gaps.
    ``w_bits`` / ``occ_before`` are the lazily-derived position-stream block
    offsets and the exclusive per-docid-block occurrence prefix counts.
    """

    n: int
    words: np.ndarray
    last_d: int
    sum_f: int
    d_last: np.ndarray | None = None   # (nblk,) skip table (bp128)
    d_bits: np.ndarray | None = None   # (nblk,) derived lazily
    f_bits: np.ndarray | None = None   # (nblk,) derived lazily
    sum_w: int = 0                     # word-level: sum of all w-gaps
    w_bits: np.ndarray | None = None   # word-level (bp128): derived lazily
    occ_before: np.ndarray | None = None  # word-level (bp128): derived
    blk_cache: dict | None = None      # decoded-block cache, lazily created
    #   by the first cursor: {block j: (docids, payloads)}.  Shared across
    #   cursors — serving creates a FRESH cursor per query, so without it
    #   every query re-runs the per-value bp128 unpack loops for the same
    #   hot blocks (the dominant cost of tiered conjunctive latency).  The
    #   arrays are read-only by contract; worst case it holds the decoded
    #   form of every touched block (~4× the compressed bytes, hot terms
    #   only).  Benign under concurrent readers: a lost race merely
    #   decodes a block twice.


class StaticIndex:
    """Frozen, maximally-compressed image of a dynamic index.

    ``word_level`` images store ⟨d,w⟩ occurrence streams (see the module
    docstring); doc-level images store ⟨d,f⟩.  ``epoch`` identifies the
    freeze generation this image belongs to (set by the lifecycle's
    :class:`~repro_torch.core.lifecycle.FreezeManager`; it keys the serving
    layer's query-result cache).
    """

    def __init__(self, codec: str = "bp128", word_level: bool = False):
        assert codec in ("bp128", "interp")
        self.codec = codec
        self.word_level = word_level
        self.terms: dict[bytes, int] = {}
        self.lists: list[TermList] = []
        self.num_docs = 0
        self.num_postings = 0
        self.epoch = 0

    # -- encode ---------------------------------------------------------

    @classmethod
    def freeze(cls, index: DynamicIndex, codec: str = "bp128") -> "StaticIndex":
        """One full decode + re-encode pass over a dynamic index — the
        paper's "fast conversion ... to a 'normal' static compressed
        inverted index".  Word-level indexes freeze too: the decoded
        occurrence stream (docids repeat, seconds = w-gaps) is regrouped
        by ``add_list``.

        Freeze-time compaction: tombstoned docids are dropped from every
        list — the tier is rebuilt anyway, so the dead documents' postings
        (and their share of the encoded bytes) vanish for free.  Dropping a
        word-level document's whole occurrence run is safe because w-gaps
        are INTRA-document (each doc's first occurrence carries its
        absolute position).  ``num_docs`` stays the docid HORIZON — the
        docid space is never renumbered, so the tiered merge arithmetic is
        untouched."""
        out = cls(codec, word_level=index.word_level)
        out.num_docs = index.num_docs
        dead = index.tombstones
        deadarr = (np.asarray(sorted(dead), dtype=np.int64) if dead
                   else None)
        for term, h_ptr in sorted(index.terms()):
            docids, seconds = index.store.decode_postings(h_ptr)
            if deadarr is not None and len(docids):
                keep = ~np.isin(docids, deadarr)
                docids, seconds = docids[keep], seconds[keep]
            out.add_list(term, docids, seconds)
        return out

    def _empty_list(self, tb: bytes) -> None:
        # empty and pathological lists must not crash a lifecycle swap
        self.terms[tb] = len(self.lists)
        self.lists.append(TermList(0, np.zeros(0, np.uint32), 0, 0,
                                   d_last=np.zeros(0, np.int64)))

    def add_list(self, term: bytes, docids: np.ndarray, seconds: np.ndarray):
        """Append one term's full postings list.

        Doc-level: ``docids`` strictly increasing, ``seconds`` = f_{t,d}.
        Word-level: occurrence streams — ``docids`` non-decreasing (one
        entry per occurrence) and ``seconds`` = w-gaps, exactly the shape
        ``BlockStore.decode_postings`` returns.
        """
        docids = np.asarray(docids, dtype=np.int64)
        seconds = np.asarray(seconds, dtype=np.int64)
        tb = bytes(term)
        if self.word_level:
            self._add_list_word(tb, docids, seconds)
            return
        fs = seconds
        n = len(docids)
        if n == 0:
            self._empty_list(tb)
            return
        w = BitWriter()
        d_last = None
        if self.codec == "interp":
            interp_encode(docids, 1, int(docids[-1]), w)
            # frequencies: strictly-increasing prefix sums, coded the same way
            csum = np.cumsum(fs)
            interp_encode(csum + np.arange(n), 1, int(csum[-1]) + n, w)
        else:
            gaps = np.diff(docids, prepend=0)
            bp_encode(gaps, w)
            bp_encode(fs, w)
            # skip table: last docid of each 128-gap block
            d_last = docids[np.minimum(
                np.arange(BP_BLOCK - 1, n + BP_BLOCK - 1, BP_BLOCK), n - 1)]
        self.terms[tb] = len(self.lists)
        self.lists.append(TermList(n, w.flush(), int(docids[-1]),
                                   int(fs.sum()), d_last=d_last))
        self.num_postings += n

    def _add_list_word(self, tb: bytes, docids: np.ndarray,
                       wgaps: np.ndarray) -> None:
        """Word-level encode: regroup the occurrence stream into unique-doc
        d-gaps + per-doc counts + the flat w-gap stream (all >= 1)."""
        n_occ = len(docids)
        if n_occ == 0:
            self._empty_list(tb)
            return
        # occurrence docids are non-decreasing: doc run-lengths = counts
        udocs, counts = np.unique(docids, return_counts=True)
        m = len(udocs)
        w = BitWriter()
        d_last = None
        if self.codec == "interp":
            interp_encode(udocs, 1, int(udocs[-1]), w)
            csum_c = np.cumsum(counts)
            interp_encode(csum_c + np.arange(m), 1, int(csum_c[-1]) + m, w)
            # w-gaps are >= 1, so their prefix sums are strictly increasing
            csum_w = np.cumsum(wgaps)
            interp_encode(csum_w, 1, int(csum_w[-1]), w)
        else:
            bp_encode(np.diff(udocs, prepend=0), w)
            bp_encode(counts, w)
            bp_encode(wgaps, w)
            d_last = udocs[np.minimum(
                np.arange(BP_BLOCK - 1, m + BP_BLOCK - 1, BP_BLOCK), m - 1)]
        self.terms[tb] = len(self.lists)
        self.lists.append(TermList(m, w.flush(), int(udocs[-1]), n_occ,
                                   d_last=d_last, sum_w=int(wgaps.sum())))
        self.num_postings += n_occ

    # -- decode ----------------------------------------------------------

    def _index_of(self, term) -> int | None:
        tb = term.encode() if isinstance(term, str) else bytes(term)
        return self.terms.get(tb)

    def postings(self, term) -> tuple[np.ndarray, np.ndarray]:
        """Full decode, mirroring ``DynamicIndex.postings`` exactly:
        doc-level -> (docids, f); word-level -> the occurrence stream
        (docids repeat per occurrence, seconds = w-gaps)."""
        ti = self._index_of(term)
        if ti is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        rec = self.lists[ti]
        if rec.n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if self.word_level:
            udocs, counts, wgaps = self._decode_word(rec)
            return np.repeat(udocs, counts), wgaps
        r = BitReader(rec.words)
        n = rec.n
        if self.codec == "interp":
            docids: list = []
            interp_decode(n, 1, rec.last_d, r, docids)
            shifted: list = []
            interp_decode(n, 1, rec.sum_f + n, r, shifted)
            csum = np.asarray(shifted, dtype=np.int64) - np.arange(n)
            fs = np.diff(csum, prepend=0)
            return np.asarray(docids, dtype=np.int64), fs
        gaps = bp_decode(n, r)
        fs = bp_decode(n, r)
        return np.cumsum(gaps), fs

    def word_postings(self, term
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Word-level grouped decode: (unique docids, per-doc counts,
        flat w-gap stream)."""
        if not self.word_level:
            raise ValueError("word_postings needs a word-level image")
        ti = self._index_of(term)
        if ti is None or self.lists[ti].n == 0:
            z = np.zeros(0, np.int64)
            return z, z.copy(), z.copy()
        return self._decode_word(self.lists[ti])

    def _decode_word_docs(self, rec: TermList, r: BitReader
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Decode the docid + count streams of a word-level list — the
        shared layout prefix under both codecs — leaving ``r`` positioned
        at the start of the w-gap stream."""
        m = rec.n
        if self.codec == "interp":
            udocs: list = []
            interp_decode(m, 1, rec.last_d, r, udocs)
            shifted: list = []
            interp_decode(m, 1, rec.sum_f + m, r, shifted)
            csum_c = np.asarray(shifted, dtype=np.int64) - np.arange(m)
            return np.asarray(udocs, dtype=np.int64), np.diff(csum_c,
                                                              prepend=0)
        gaps = bp_decode(m, r)
        counts = bp_decode(m, r)
        return np.cumsum(gaps), counts

    def _decode_word(self, rec: TermList
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        n_occ = rec.sum_f
        r = BitReader(rec.words)
        udocs, counts = self._decode_word_docs(rec, r)
        if self.codec == "interp":
            wsums: list = []
            interp_decode(n_occ, 1, rec.sum_w, r, wsums)
            wgaps = np.diff(np.asarray(wsums, dtype=np.int64), prepend=0)
        else:
            wgaps = bp_decode(n_occ, r)
        return udocs, counts, wgaps

    def doc_postings(self, term) -> tuple[np.ndarray, np.ndarray]:
        """Document-granular postings: (unique docids, doc-level f_{t,d}).

        The ranked serving path: word-level lists decode ONLY the docid and
        count streams (they are laid out ahead of the w-gap stream under
        both codecs), so scoring a term never pays for its positions."""
        ti = self._index_of(term)
        if ti is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        rec = self.lists[ti]
        if rec.n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if not self.word_level:
            return self.postings(term)
        return self._decode_word_docs(rec, BitReader(rec.words))

    def ft(self, term) -> int:
        """f_t with the dynamic index's semantics: documents containing the
        term (doc-level) / total occurrences (word-level, §5.1)."""
        ti = self._index_of(term)
        if ti is None:
            return 0
        rec = self.lists[ti]
        return rec.sum_f if self.word_level else rec.n

    def postings_iter(self, term) -> "StaticPostingsCursor | None":
        """A DAAT cursor over the compressed list (None if term unknown or
        empty).  Protocol-compatible with ``core.query.PostingsCursor``;
        word-level images return a :class:`StaticWordCursor`, which adds
        ``positions()`` and reports per-doc occurrence counts as payload."""
        ti = self._index_of(term)
        if ti is None or self.lists[ti].n == 0:
            return None
        if self.word_level:
            return StaticWordCursor(self, ti)
        return StaticPostingsCursor(self, ti)

    # -- persistence (core/persist.py) -----------------------------------

    def to_arrays(self) -> tuple[dict, dict]:
        """Decompose the image into (meta, flat numpy arrays) for
        persistence: the compressed word streams and per-list scalars are
        concatenated with exclusive-prefix offsets, the term bytes into one
        blob.  Only STORED state is included — the lazily-derived caches
        (``d_bits``/``w_bits``/``occ_before``/``blk_cache``) are rebuilt on
        first cursor use, so ``from_arrays`` inverts this exactly and a
        restored tier serves byte-identical results."""
        order = sorted(self.terms.items(), key=lambda kv: kv[1])
        term_bytes = [tb for tb, _ in order]
        meta = {"codec": self.codec, "word_level": self.word_level,
                "num_docs": self.num_docs, "num_postings": self.num_postings,
                "epoch": self.epoch, "num_lists": len(self.lists)}

        def offsets(lengths):
            out = np.zeros(len(lengths) + 1, np.int64)
            np.cumsum(np.asarray(lengths, np.int64), out=out[1:])
            return out

        def concat(parts, dtype):
            parts = [np.asarray(p, dtype) for p in parts]
            return (np.concatenate(parts) if parts
                    else np.zeros(0, dtype))

        d_lasts = [r.d_last if r.d_last is not None
                   else np.zeros(0, np.int64) for r in self.lists]
        arrays = {
            "term_blob": np.frombuffer(b"".join(term_bytes), np.uint8).copy(),
            "term_off": offsets([len(t) for t in term_bytes]),
            "n": np.asarray([r.n for r in self.lists], np.int64),
            "last_d": np.asarray([r.last_d for r in self.lists], np.int64),
            "sum_f": np.asarray([r.sum_f for r in self.lists], np.int64),
            "sum_w": np.asarray([r.sum_w for r in self.lists], np.int64),
            "words": concat([r.words for r in self.lists], np.uint32),
            "words_off": offsets([len(r.words) for r in self.lists]),
            "dlast": concat(d_lasts, np.int64),
            "dlast_off": offsets([len(d) for d in d_lasts]),
        }
        return meta, arrays

    @classmethod
    def from_arrays(cls, meta: dict, arrays: dict) -> "StaticIndex":
        """Inverse of :meth:`to_arrays`.  ``d_last`` presence follows the
        codec invariant: interp lists store no skip table (None) while
        empty lists always carry a zero-length one (``_empty_list``)."""
        out = cls(meta["codec"], word_level=meta["word_level"])
        out.num_docs = int(meta["num_docs"])
        out.num_postings = int(meta["num_postings"])
        out.epoch = int(meta["epoch"])
        blob = arrays["term_blob"].tobytes()
        toff, woff, doff = (arrays["term_off"], arrays["words_off"],
                            arrays["dlast_off"])
        for i in range(int(meta["num_lists"])):
            n = int(arrays["n"][i])
            if n == 0:
                d_last = np.zeros(0, np.int64)
            elif out.codec == "interp":
                d_last = None
            else:
                d_last = arrays["dlast"][doff[i]:doff[i + 1]].copy()
            rec = TermList(
                n=n,
                words=arrays["words"][woff[i]:woff[i + 1]].copy(),
                last_d=int(arrays["last_d"][i]),
                sum_f=int(arrays["sum_f"][i]),
                d_last=d_last,
                sum_w=int(arrays["sum_w"][i]))
            out.terms[blob[int(toff[i]):int(toff[i + 1])]] = len(out.lists)
            out.lists.append(rec)
        return out

    # -- accounting (Table 9: "including vocabulary and other files") ----

    def total_bytes(self) -> int:
        postings = sum(4 * len(rec.words) for rec in self.lists)
        # vocabulary: term bytes + (offset, n, last_d, sum_f) per term;
        # word-level lists additionally store sum_w (interp bound)
        per_term = 20 if self.word_level else 16
        vocab = sum(len(t) + 1 for t in self.terms) + per_term * len(self.lists)
        # bp128 skip table: one stored docid per block (offsets are derived)
        skip = sum(4 * len(rec.d_last) for rec in self.lists
                   if rec.d_last is not None)
        return postings + vocab + skip

    def bytes_per_posting(self) -> float:
        return self.total_bytes() / max(1, self.num_postings)

    # -- skip-table completion (derived from the 5-bit width headers) ----

    def _block_offsets(self, rec: TermList):
        """Bit offsets of every docid/frequency block header, recovered by
        walking the in-stream width headers (no decode of the packed
        values)."""
        if rec.d_bits is not None:
            return rec.d_bits, rec.f_bits
        nblk = (rec.n + BP_BLOCK - 1) // BP_BLOCK
        d_bits = np.zeros(nblk, np.int64)
        f_bits = np.zeros(nblk, np.int64)
        r = BitReader(rec.words)
        off = 0
        for arr in (d_bits, f_bits):
            for j in range(nblk):
                arr[j] = off
                cnt = min(BP_BLOCK, rec.n - j * BP_BLOCK)
                r.pos = off
                width = r.read(5)
                off += 5 + width * cnt
        rec.d_bits, rec.f_bits = d_bits, f_bits
        return d_bits, f_bits

    def _word_offsets(self, rec: TermList):
        """bp128 word-level stream geometry: bit offsets of every docid /
        count / w-gap block header, plus the exclusive occurrence-count
        prefix per docid block (``occ_before``) so ``positions()`` can map a
        (block, in-block doc) pair to its w-gap slice.  The offsets come
        from the width headers alone; ``occ_before`` needs one decode of the
        count blocks — done once per list, cached on the record."""
        if rec.d_bits is not None:
            return rec.d_bits, rec.f_bits, rec.w_bits, rec.occ_before
        nblkd = (rec.n + BP_BLOCK - 1) // BP_BLOCK
        nblkw = (rec.sum_f + BP_BLOCK - 1) // BP_BLOCK
        d_bits = np.zeros(nblkd, np.int64)
        c_bits = np.zeros(nblkd, np.int64)
        w_bits = np.zeros(nblkw, np.int64)
        r = BitReader(rec.words)
        off = 0
        for arr, total in ((d_bits, rec.n), (c_bits, rec.n),
                           (w_bits, rec.sum_f)):
            for j in range(len(arr)):
                arr[j] = off
                cnt = min(BP_BLOCK, total - j * BP_BLOCK)
                r.pos = off
                width = r.read(5)
                off += 5 + width * cnt
        occ_before = np.zeros(nblkd + 1, np.int64)
        for j in range(nblkd):
            cnt = min(BP_BLOCK, rec.n - j * BP_BLOCK)
            r.pos = int(c_bits[j])
            occ_before[j + 1] = occ_before[j] + int(bp_decode(cnt, r).sum())
        rec.d_bits, rec.f_bits = d_bits, c_bits
        rec.w_bits, rec.occ_before = w_bits, occ_before
        return d_bits, c_bits, w_bits, occ_before


class StaticPostingsCursor:
    """DAAT cursor over one compressed static list: ``next``/``seek_geq``
    with (docid, payload) state, the protocol of
    ``core.query.PostingsCursor``.

    bp128: decodes one 128-posting block at a time; ``seek_geq`` first
    binary-searches the skip table (``d_last``) so only the single candidate
    block is ever decoded.  interp: the recursion has no sub-list entry
    points, so the list is decoded once up front and sought by binary
    search.
    """

    __slots__ = ("static", "rec", "_blk", "_d", "_f", "_k",
                 "docid", "payload", "_exhausted")

    def __init__(self, static: StaticIndex, ti: int):
        self.static = static
        self.rec = static.lists[ti]
        self._blk = -1
        self._d: np.ndarray | None = None
        self._f: np.ndarray | None = None
        self._k = -1
        self.docid = 0
        self.payload = 0
        self._exhausted = self.rec.n == 0
        if not self._exhausted:
            self._load_block(0)
            self._advance_to(0, 0)

    # -- block machinery -------------------------------------------------

    def _nblocks(self) -> int:
        if self.static.codec == "interp":
            return 1
        return (self.rec.n + BP_BLOCK - 1) // BP_BLOCK

    def _load_block(self, j: int) -> None:
        rec = self.rec
        if rec.blk_cache is None:
            rec.blk_cache = {}
        hit = rec.blk_cache.get(j)
        if hit is not None:
            self._d, self._f = hit
            self._blk = j
            return
        if self.static.codec == "interp":
            # one "block" = the whole list
            r = BitReader(rec.words)
            docids: list = []
            interp_decode(rec.n, 1, rec.last_d, r, docids)
            shifted: list = []
            interp_decode(rec.n, 1, rec.sum_f + rec.n, r, shifted)
            csum = np.asarray(shifted, dtype=np.int64) - np.arange(rec.n)
            self._d = np.asarray(docids, dtype=np.int64)
            self._f = np.diff(csum, prepend=0)
            self._blk = 0
            rec.blk_cache[0] = (self._d, self._f)
            return
        d_bits, f_bits = self.static._block_offsets(rec)
        cnt = min(BP_BLOCK, rec.n - j * BP_BLOCK)
        r = BitReader(rec.words)
        r.pos = int(d_bits[j])
        gaps = bp_decode(cnt, r)
        r.pos = int(f_bits[j])
        fs = bp_decode(cnt, r)
        base = int(self.rec.d_last[j - 1]) if j > 0 else 0
        self._d = base + np.cumsum(gaps)
        self._f = fs
        self._blk = j
        rec.blk_cache[j] = (self._d, self._f)

    def _advance_to(self, j: int, k: int) -> None:
        self._k = k
        self.docid = int(self._d[k])
        self.payload = int(self._f[k])

    # -- protocol ---------------------------------------------------------

    def next(self) -> bool:
        if self._exhausted:
            return False
        if self._k + 1 < len(self._d):
            self._advance_to(self._blk, self._k + 1)
            return True
        if self._blk + 1 < self._nblocks():
            self._load_block(self._blk + 1)
            self._advance_to(self._blk, 0)
            return True
        self._exhausted = True
        return False

    def seek_geq(self, target: int) -> bool:
        """Position on the first posting with docid >= target."""
        if self._exhausted:
            return False
        if self.docid >= target:
            return True
        if target > self.rec.last_d:
            self._exhausted = True
            return False
        if self.static.codec == "bp128":
            # skip: first block whose last docid >= target
            j = int(np.searchsorted(self.rec.d_last, target, side="left"))
            if j > self._blk:
                self._load_block(j)
                self._advance_to(j, 0)
                if self.docid >= target:
                    return True
        k = int(np.searchsorted(self._d, target, side="left"))
        if k >= len(self._d):  # only when already in the final block
            self._exhausted = True
            return False
        self._advance_to(self._blk, k)
        return True

    @property
    def exhausted(self) -> bool:
        return self._exhausted


class StaticWordCursor(StaticPostingsCursor):
    """DAAT cursor over one compressed word-level list.

    Iterates UNIQUE docids (the shape every conjunctive/ranked consumer
    expects), with ``payload`` = the doc's occurrence count f_{t,d}; the
    within-doc word positions of the current document come from
    ``positions()`` — the protocol ``core.query.WordPostingsCursor`` speaks
    for the dynamic chains, so phrase evaluation is uniform across tiers.

    ``next``/``seek_geq`` (including the skip-table block jump) are
    inherited unchanged: the docid stream has the same 128-gap block
    geometry as a doc-level list.  Positions are decoded lazily: one
    128-occurrence w-gap block at a time, only when ``positions()`` is
    called (bp128); interp decodes the whole list once, like its doc-level
    cursor.
    """

    __slots__ = ("_c", "_ccum", "_occ0", "_wg", "_wg_blocks")

    def __init__(self, static: StaticIndex, ti: int):
        self._wg = None
        self._wg_blocks: dict[int, np.ndarray] = {}
        super().__init__(static, ti)

    # -- block machinery (docid + count streams) -------------------------

    def _load_block(self, j: int) -> None:
        rec = self.rec
        if self.static.codec == "interp":
            udocs, counts, wgaps = self.static._decode_word(rec)
            self._d = udocs
            self._c = counts
            self._ccum = np.cumsum(counts) - counts  # exclusive prefix
            self._occ0 = 0
            self._wg = wgaps
            self._blk = 0
            return
        d_bits, c_bits, _w_bits, occ_before = self.static._word_offsets(rec)
        cnt = min(BP_BLOCK, rec.n - j * BP_BLOCK)
        r = BitReader(rec.words)
        r.pos = int(d_bits[j])
        gaps = bp_decode(cnt, r)
        r.pos = int(c_bits[j])
        counts = bp_decode(cnt, r)
        base = int(rec.d_last[j - 1]) if j > 0 else 0
        self._d = base + np.cumsum(gaps)
        self._c = counts
        self._ccum = np.cumsum(counts) - counts
        self._occ0 = int(occ_before[j])
        self._blk = j

    def _advance_to(self, j: int, k: int) -> None:
        self._k = k
        self.docid = int(self._d[k])
        self.payload = int(self._c[k])

    # -- position access --------------------------------------------------

    def _wgap_range(self, lo: int, hi: int) -> np.ndarray:
        """w-gaps [lo, hi) of the flat occurrence stream (bp128: decode and
        cache only the 128-occurrence blocks that overlap the range)."""
        if self._wg is not None:          # interp: fully decoded
            return self._wg[lo:hi]
        rec = self.rec
        _d, _c, w_bits, _o = self.static._word_offsets(rec)
        parts = []
        for j in range(lo // BP_BLOCK, (hi - 1) // BP_BLOCK + 1):
            blk = self._wg_blocks.get(j)
            if blk is None:
                cnt = min(BP_BLOCK, rec.sum_f - j * BP_BLOCK)
                r = BitReader(rec.words)
                r.pos = int(w_bits[j])
                blk = bp_decode(cnt, r)
                self._wg_blocks[j] = blk
            s = j * BP_BLOCK
            parts.append(blk[max(lo - s, 0):hi - s])
        return np.concatenate(parts)

    def positions(self) -> np.ndarray:
        """Absolute word positions of the current document, ascending
        (cumulative sum of its w-gap slice)."""
        lo = self._occ0 + int(self._ccum[self._k])
        return np.cumsum(self._wgap_range(lo, lo + self.payload))
