"""The port's static compressed tier (``repro_torch.core.static_index``)
against the JAX package's.

One seeded stream goes through both packages' dynamic indexes and is
frozen by each package's ``StaticIndex.freeze``, for every cell of
{const, triangle} × {bp128, interp} × {doc, word}: ``to_arrays()`` must be
equal byte for byte (the codecs are integer code over numpy ``uint32`` /
``int64``), and each list must decode to the same postings in both.  The
codecs and cursors are held to the reference on edge lists and on
derandomized property draws (the same cases every run), and
``convert.static_from_jax`` carries a reference tier across unchanged.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as hst

from repro.core.index import DynamicIndex as JaxIndex
from repro.core.query import ChainedCursor as JaxChained
from repro.core.query import conjunctive_from_cursors as jax_conj
from repro.core.static_index import StaticIndex as JaxStatic
from repro_torch.convert import static_from_jax
from repro_torch.core.collate import collate, is_collated
from repro_torch.core.index import DynamicIndex
from repro_torch.core.query import (ChainedCursor, PostingsCursor,
                                    conjunctive_from_cursors)
from repro_torch.core.static_index import BP_BLOCK, StaticIndex

CODECS = ("bp128", "interp")
CELLS = [(g, c, w) for g in ("const", "triangle") for c in CODECS
         for w in (False, True)]
CELL_IDS = [f"{g}-{c}-{'word' if w else 'doc'}" for g, c, w in CELLS]

#: property draws: the same cases in every run, no example database
PROPERTY = settings(derandomize=True, database=None, max_examples=25,
                    deadline=None)


def _stream(seed=11, n=300, V=120):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(V)]
    probs = 1.0 / np.arange(1, V + 1) ** 1.07
    probs /= probs.sum()
    return vocab, [[vocab[i] for i in rng.choice(V, size=int(
        rng.integers(2, 40)), p=probs)] for _ in range(n)]


def assert_same_arrays(a: tuple, b: tuple) -> None:
    """Two ``to_arrays()`` outputs equal byte for byte, dtypes included."""
    (ma, xa), (mb, xb) = a, b
    assert ma == mb
    assert sorted(xa) == sorted(xb)
    for name in xa:
        assert xa[name].dtype == xb[name].dtype, name
        assert xa[name].tobytes() == xb[name].tobytes(), name


@pytest.fixture(scope="module")
def frozen_pairs():
    """(reference, port) static tiers of one stream, per cell."""
    vocab, docs = _stream()
    out = {}
    for growth, codec, word in CELLS:
        ref = JaxIndex(B=64, growth=growth, word_level=word)
        port = DynamicIndex(B=64, growth=growth, word_level=word)
        for d in docs:
            ref.add_document(d)
            port.add_document(d)
        out[growth, codec, word] = (JaxStatic.freeze(ref, codec),
                                    StaticIndex.freeze(port, codec), port)
    return vocab, out


@pytest.mark.parametrize("growth,codec,word", CELLS, ids=CELL_IDS)
def test_freeze_to_arrays_equal_reference(frozen_pairs, growth, codec,
                                          word):
    _, pairs = frozen_pairs
    ref, port, _ = pairs[growth, codec, word]
    assert_same_arrays(ref.to_arrays(), port.to_arrays())
    assert port.total_bytes() == ref.total_bytes()


@pytest.mark.parametrize("growth,codec,word", CELLS, ids=CELL_IDS)
def test_frozen_lists_decode_as_reference(frozen_pairs, growth, codec,
                                          word):
    vocab, pairs = frozen_pairs
    ref, port, idx = pairs[growth, codec, word]
    for t in vocab:
        for fn in ("postings", "doc_postings"):
            got, want = getattr(port, fn)(t), getattr(ref, fn)(t)
            assert [a.tolist() for a in got] == [a.tolist() for a in want]
        d, f = idx.postings(t)
        assert port.postings(t)[0].tolist() == d.tolist()
        assert port.ft(t) == ref.ft(t)
        if word:
            got, want = port.word_postings(t), ref.word_postings(t)
            assert [a.tolist() for a in got] == [a.tolist() for a in want]


@pytest.mark.parametrize("growth,codec,word", CELLS, ids=CELL_IDS)
def test_static_from_jax_carries_the_tier(frozen_pairs, growth, codec,
                                          word):
    vocab, pairs = frozen_pairs
    ref, port, _ = pairs[growth, codec, word]
    meta, arrays = ref.to_arrays()
    carried = static_from_jax(meta, arrays)
    assert isinstance(carried, StaticIndex)
    assert_same_arrays(carried.to_arrays(), port.to_arrays())
    for t in vocab[::7]:
        a, b = carried.postings_iter(t), ref.postings_iter(t)
        while a is not None and not a.exhausted:
            assert (a.docid, a.payload) == (b.docid, b.payload)
            if word:
                assert a.positions().tolist() == b.positions().tolist()
            assert a.next() == b.next()


@pytest.mark.parametrize("codec", CODECS)
def test_static_smaller_than_dynamic_and_collation_kept(codec):
    """Table 9 against Table 8: the frozen tier is smaller than the dynamic
    index; interp smaller than bp128; collation keeps every posting."""
    vocab, docs = _stream(seed=5)
    idx = DynamicIndex(B=48, growth="const")
    for d in docs:
        idx.add_document(d)
    col = collate(idx)
    assert is_collated(col) and not is_collated(idx)
    st = StaticIndex.freeze(col, codec)
    assert st.bytes_per_posting() < idx.bytes_per_posting()
    if codec == "interp":
        assert st.bytes_per_posting() < StaticIndex.freeze(
            idx, "bp128").bytes_per_posting()
    for t in vocab:
        assert [a.tolist() for a in st.postings(t)] == \
            [a.tolist() for a in idx.postings(t)]


# --------------------------------------------------------------------------
# edge lists, encoded by both packages
# --------------------------------------------------------------------------


def _both(codec, docids, fs, word=False):
    docids = np.asarray(docids, np.int64)
    fs = np.asarray(fs, np.int64)
    ref, port = JaxStatic(codec, word_level=word), StaticIndex(
        codec, word_level=word)
    ref.add_list(b"t", docids, fs)
    port.add_list(b"t", docids, fs)
    assert_same_arrays(ref.to_arrays(), port.to_arrays())
    d, f = port.postings(b"t")
    assert d.tolist() == docids.tolist() and f.tolist() == fs.tolist()
    return ref, port


EDGE_LISTS = {
    "empty": ([], []),
    "singleton": ([7], [3]),
    "docid-one": ([1], [1]),
    "dense": (list(range(1, 3 * BP_BLOCK + 18)), [1] * (3 * BP_BLOCK + 17)),
    "large-gaps": (np.cumsum(np.random.default_rng(8).integers(
        1, 1 << 24, 400)).tolist(),
        np.random.default_rng(9).integers(1, 100, 400).tolist()),
    "block-edge": (list(range(2, 2 * BP_BLOCK + 2, 1)), [2] * (2 * BP_BLOCK)),
}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", list(EDGE_LISTS))
def test_edge_lists_encode_as_reference(codec, name):
    docids, fs = EDGE_LISTS[name]
    ref, port = _both(codec, docids, fs)
    if not docids:
        assert port.postings_iter(b"t") is None and port.ft(b"t") == 0
        assert port.total_bytes() == ref.total_bytes() > 0
        return
    c = port.postings_iter(b"t")
    assert (c.docid, c.payload) == (docids[0], fs[0])
    for target in (0, docids[len(docids) // 2], docids[-1],
                   docids[-1] + 1):
        a, b = port.postings_iter(b"t"), ref.postings_iter(b"t")
        ok = a.seek_geq(target)
        assert ok == b.seek_geq(target)
        if ok:
            assert (a.docid, a.payload) == (b.docid, b.payload)


@pytest.mark.parametrize("codec", CODECS)
def test_chained_cursor_spans_tiers_as_reference(codec):
    """A static tier for the prefix chained with the dynamic suffix: the
    conjunctive answer equals the reference's chained answer and the
    dynamic index's own."""
    vocab, docs = _stream(seed=21, n=200)
    idx, ref_idx = DynamicIndex(B=64), JaxIndex(B=64)
    for d in docs[:120]:
        idx.add_document(d)
        ref_idx.add_document(d)
    st, ref_st = StaticIndex.freeze(idx, codec), JaxStatic.freeze(ref_idx,
                                                                   codec)
    for d in docs[120:]:
        idx.add_document(d)
        ref_idx.add_document(d)

    def chained(static, index, t, chained_cls):
        parts = [static.postings_iter(t)]
        c = PostingsCursor(index.store, index.lookup(t))
        if c.seek_geq(121):
            parts.append(c)
        return chained_cls(parts)

    for i in range(0, 40, 3):
        terms = (vocab[i], vocab[i + 1])
        got = conjunctive_from_cursors(
            [chained(st, idx, t, ChainedCursor) for t in terms])
        want = jax_conj([chained(ref_st, ref_idx, t, JaxChained)
                         for t in terms])
        full = np.intersect1d(idx.postings(terms[0])[0],
                              idx.postings(terms[1])[0])
        assert got.tolist() == want.tolist() == full.tolist()


# --------------------------------------------------------------------------
# derandomized properties: the port's codecs and cursors against the
# reference's on the same drawn lists
# --------------------------------------------------------------------------

gap_lists = hst.lists(
    hst.tuples(hst.integers(1, 1 << 26), hst.integers(1, 1 << 16)),
    min_size=0, max_size=3 * BP_BLOCK + 5)


@pytest.mark.parametrize("codec", CODECS)
@PROPERTY
@given(pairs=gap_lists, targets=hst.lists(hst.integers(0, 1 << 27),
                                          min_size=1, max_size=6))
def test_codec_and_seek_property(codec, pairs, targets):
    docids = np.cumsum([g for g, _ in pairs]).astype(np.int64)
    fs = np.asarray([f for _, f in pairs], np.int64)
    ref, port = _both(codec, docids, fs)
    a, b = port.postings_iter(b"t"), ref.postings_iter(b"t")
    if a is None:
        assert b is None and len(docids) == 0
        return
    for target in sorted(targets):
        ok = a.seek_geq(int(target))
        assert ok == b.seek_geq(int(target))
        if not ok:
            return
        assert (a.docid, a.payload) == (b.docid, b.payload)


word_lists = hst.lists(
    hst.tuples(hst.integers(1, 1 << 24),
               hst.lists(hst.integers(1, 1 << 20), min_size=1, max_size=6)),
    min_size=0, max_size=2 * BP_BLOCK + 9)


@pytest.mark.parametrize("codec", CODECS)
@PROPERTY
@given(docs=word_lists, targets=hst.lists(hst.integers(0, 1 << 25),
                                          min_size=1, max_size=6))
def test_word_codec_and_positions_property(codec, docs, targets):
    udocs = np.cumsum([g for g, _ in docs]).astype(np.int64)
    occ = np.asarray([int(d) for d, (_, ws) in zip(udocs, docs)
                      for _ in ws], np.int64)
    wgaps = np.asarray([w for _, ws in docs for w in ws], np.int64)
    ref, port = _both(codec, occ, wgaps, word=True)
    got, want = port.word_postings(b"t"), ref.word_postings(b"t")
    assert [x.tolist() for x in got] == [x.tolist() for x in want]
    a, b = port.postings_iter(b"t"), ref.postings_iter(b"t")
    if a is None:
        assert b is None and len(udocs) == 0
        return
    for target in sorted(targets):
        ok = a.seek_geq(int(target))
        assert ok == b.seek_geq(int(target))
        if not ok:
            return
        assert (a.docid, a.payload) == (b.docid, b.payload)
        assert a.positions().tolist() == b.positions().tolist()


@pytest.mark.parametrize("text", [
    "Fast DYNAMIC index-ing, 2022!", "", "  a  b ",
    "x" * 47 + " mixedCASE_words42and7more", "émigré naïve ok"])
def test_docstream_as_reference(text):
    """The port's docstream tokenizer and line format are the reference's
    (paper §4.1: alpha runs, lower-cased, 20-character chunks)."""
    from repro.data import docstream as ref
    from repro_torch.data import docstream as port
    assert port.tokenize(text) == ref.tokenize(text)
    line = port.to_docstream_line("D7", port.tokenize(text))
    assert line == ref.to_docstream_line("D7", ref.tokenize(text))
    assert list(port.parse_docstream([line, "", line])) == \
        list(ref.parse_docstream([line, "", line]))
