"""The CUDA ``fused_query`` kernel against its plain version, on the card.

Imports no jax: the images are built by the port alone, from seeded
documents, so the file runs where the card is (``python -m pytest -q -m gpu
tests/test_torch_gpu_kernels.py``; ``chip_smoke.py`` runs it in phase 2).
Every test skips without a CUDA device, which it decides when it runs.

The kernel splits each query's cap+1 docid columns into ranges of W
docids, one CUDA block each (``kernel.ranges_for``).  The documents put the
cases that this split can get wrong at known docids: a term in every
document (its chain blocks straddle range edges), a term on each side of
range edges, two identical documents on either side of an edge (tied
scores), a rare term in one block, a run of deleted documents covering
whole ranges, and an engine with an empty delta.  Each launch is held
against ``ref.fused_tile`` on the same tensors: bitmaps equal, docids
equal, scores within rtol 1e-6, a second launch bit-identical, and a
ranked result the same bits whatever the number of ranges.
"""

from unittest import mock

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

MODES = ("conjunctive", "ranked_tfidf", "bm25")
N_DOCS = 700                # docid capacity 1,024: cap+1 = 1,025 columns
FREEZE_AT = 600
EDGE_DOCS = (159, 160, 287, 288, 319, 320, 575, 576)
TIE_DOCS = (159, 160)       # identical documents across the edge at 160
ONE_DOCS = (5, 400, 690)    # a rare term: one chain block per image
DEAD = tuple(range(320, 480)) + (650, 651, 652)
#: ranges per query: one, a few, edges at multiples of 160 (R = 8), and
#: the kernel's own rule on this card (None)
RANGES = (1, 4, 8, None)
QUERIES = (("all",), ("edge",), ("tie",), ("one",), ("all", "edge"),
           ("all", "tie", "edge"), ("f0", "f1", "all"), ("f3", "one"),
           ("f2", "f5", "f7", "f11"), ("all", "f4"))


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _documents() -> list[list[str]]:
    """Docid d (1-based) is ``docs[d - 1]``: ``all`` 1-3 times in every
    document, seeded filler, and the special terms at their docids."""
    rng = np.random.default_rng(23)
    docs = []
    for d in range(1, N_DOCS + 1):
        words = ["all"] * int(rng.integers(1, 4))
        words += [f"f{i}" for i in rng.integers(0, 40, int(rng.integers(2,
                                                                        12)))]
        if d in EDGE_DOCS:
            words.append("edge")
        if d in ONE_DOCS:
            words.append("one")
        docs.append(words)
    docs[TIE_DOCS[1] - 1] = docs[TIE_DOCS[0] - 1] = ["all", "tie", "f1",
                                                     "f1", "edge"]
    return docs


def _engine(dev, with_delta: bool):
    from repro_torch.engine import Engine
    docs = _documents()
    eng = Engine(B=64, growth="const", delta_compact_frac=None, device=dev)
    frozen = FREEZE_AT if with_delta else N_DOCS
    eng.add_documents(docs[:frozen])
    eng.collate_now()
    if with_delta:
        eng.add_documents(docs[frozen:])
        for d in DEAD:
            eng.delete_document(d)
    eng.resident.refresh()
    return eng


@pytest.fixture(scope="module")
def engines():
    """(frozen + delta + deletes, all frozen with an empty delta)."""
    dev = _card()
    return {"delta": _engine(dev, True), "no delta": _engine(dev, False)}


def _prepared(eng, queries, mode, k):
    from repro_torch.engine import Query
    from repro_torch.engine.device_backend import pack_queries
    from repro_torch.kernels.fused_query.ops import prepare
    res = eng.resident
    qs = [Query(terms=t, mode=mode, k=k) for t in queries]
    live, qt, qm, caps = pack_queries(eng, res, qs, mode)
    assert len(live) == len(qs)
    return prepare(res.images, qt, qm, mode=mode, max_blocks=caps,
                   doclens=res._doclens if mode == "bm25" else None,
                   n_stat=res._n_stat, avg_stat=res._avg_stat,
                   alive=res._alive)


def _same_bits(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same_bits(x, y) for x, y in zip(a, b))
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _n_sm(args, ranges):
    """The SM count for which the kernel's rule asks for ``ranges`` ranges
    for this batch (None: the card's own); the rule then cuts the ranges
    to as many as their width needs."""
    if ranges is None:
        return torch.cuda.get_device_properties(0).multi_processor_count
    return ranges * args["nterms"].shape[0] // 2


def _held(eng, queries, mode, k=10, ranges=None):
    """Launch twice with ``ranges`` docid ranges a query, hold against the
    plain version; returns (args, out)."""
    from repro_torch.kernels.fused_query import kernel
    from repro_torch.kernels.fused_query.ref import fused_tile
    args = _prepared(eng, queries, mode, k)
    n_sm = _n_sm(args, ranges)
    with mock.patch.object(kernel, "_sm_count", lambda device: n_sm):
        first = kernel.fused_query_kernel(mode=mode, k=k, **args)
        second = kernel.fused_query_kernel(mode=mode, k=k, **args)
    plain = fused_tile(mode=mode, k=k, **args)
    torch.cuda.synchronize()
    assert _same_bits(first, second), "a rerun is not bit-identical"
    if mode == "conjunctive":
        assert torch.equal(first.cpu(), plain.cpu())
    else:
        assert torch.equal(first[0].cpu(), plain[0].cpu())
        np.testing.assert_allclose(first[1].cpu().numpy(),
                                   plain[1].cpu().numpy(), rtol=1e-6, atol=0)
    return args, first


def _split(args, ranges):
    """(R, W) of the launch: ranges, docids per range."""
    from repro_torch.kernels.fused_query.kernel import ranges_for
    return ranges_for(args["nterms"].shape[0], args["cap"],
                      _n_sm(args, ranges))


@pytest.mark.parametrize("k", [10, 40], ids=["k10", "k40"])
@pytest.mark.parametrize("ranges", RANGES, ids=lambda r: f"R{r or 'rule'}")
@pytest.mark.parametrize("which", ["delta", "no delta"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_equals_plain_version(engines, mode, which, ranges, k):
    """Every query at once; a ranked result has the same bits for any
    number of ranges; cap+1 is not a multiple of the range width."""
    eng = engines[which]
    args, out = _held(eng, QUERIES, mode, k, ranges)
    R, W = _split(args, ranges)
    assert (args["cap"] + 1) % W != 0 and (R - 1) * W < args["cap"] + 1
    if mode != "conjunctive" and ranges != 1:
        _, one = _held(eng, QUERIES, mode, k, 1)
        assert _same_bits(out, one)


@pytest.mark.parametrize("mode", MODES)
def test_chain_block_straddles_range_edges(engines, mode):
    """``all`` is in every document: its chain blocks cross the edges of
    every range width used here."""
    from repro_torch.kernels.fused_query.ref import _part_postings
    eng = engines["delta"]
    for ranges in (4, 8, None):
        args, _ = _held(eng, [("all",)], mode, 10, ranges)
        _, W = _split(args, ranges)
        docid, _f, valid, _w, _s = _part_postings(args["parts"][0],
                                                  args["F"])
        lo = torch.where(valid, docid, 1 << 30).amin(dim=2)[0]
        hi = torch.where(valid, docid, -1).amax(dim=2)[0]
        used = hi >= 0
        assert bool(((lo[used] // W) != (hi[used] // W)).any())


@pytest.mark.parametrize("mode", MODES)
def test_docids_each_side_of_range_edges(engines, mode):
    eng = engines["delta"]
    for ranges in (8, None):
        args, out = _held(eng, [("edge",), ("all", "edge")], mode, 10,
                          ranges)
        _, W = _split(args, ranges)
        assert any(d % W == 0 and d - 1 in EDGE_DOCS for d in EDGE_DOCS)
        if mode == "conjunctive":
            got = torch.nonzero(out[0]).flatten().tolist()
            assert got == [d for d in EDGE_DOCS if d not in DEAD]


@pytest.mark.parametrize("mode", MODES)
def test_one_range(engines, mode):
    for which in engines:
        _held(engines[which], QUERIES, mode, 10, 1)


@pytest.mark.parametrize("mode", MODES)
def test_one_term_one_block(engines, mode):
    eng = engines["no delta"]
    args, _ = _held(eng, [("one",)], mode, 10, None)
    assert int((args["parts"][0][2] > 0).sum()) == 1


@pytest.mark.parametrize("mode", MODES)
def test_empty_delta_part(engines, mode):
    eng = engines["no delta"]
    assert eng.resident.delta_blocks == 0
    args, _ = _held(eng, QUERIES, mode, 10, None)
    assert int((args["parts"][1][2] > 0).sum()) == 0


@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("mode", ["ranked_tfidf", "bm25"])
def test_zeros_fill_the_list_in_docid_order(engines, mode, k):
    """``one`` scores three documents; the rest of the list is zeros, the
    smallest docids first (docid 0 included), as the plain version sorts."""
    for ranges in (1, 8, None):
        _, (top_d, top_s) = _held(engines["no delta"], [("one",)], mode, k,
                                  ranges)
        d, s = top_d[0].tolist(), top_s[0].tolist()
        assert sorted(d[:3]) == list(ONE_DOCS) and min(s[:3]) > 0
        assert s[3:] == [0.0] * (k - 3)
        assert d[3:] == [x for x in range(k + 1) if x not in ONE_DOCS][:k - 3]


@pytest.mark.parametrize("mode", MODES)
def test_every_docid_of_a_range_dead(engines, mode):
    """Docids 320-479 are dead: range 2 whole at R = 8 (W = 160), ranges
    10-14 under the kernel's rule for two queries (W = 32)."""
    eng = engines["delta"]
    for ranges in (8, None):
        args, out = _held(eng, [("all",), ("all", "f1")], mode, 40, ranges)
        R, W = _split(args, ranges)
        whole = [r for r in range(R)
                 if all(d in DEAD for d in range(r * W, (r + 1) * W))]
        assert whole
        picked = (torch.nonzero(out[0]).flatten() if mode == "conjunctive"
                  else out[0][0][out[1][0] > 0]).tolist()
        assert picked and not set(picked) & set(DEAD)


@pytest.mark.parametrize("mode", ["ranked_tfidf", "bm25"])
def test_ties_across_a_range_edge(engines, mode):
    """Documents 159 and 160 are identical, and 160 starts a range."""
    for ranges in (8, None):
        args, (top_d, top_s) = _held(engines["no delta"], [("tie",)], mode,
                                     10, ranges)
        _, W = _split(args, ranges)
        assert TIE_DOCS[1] % W == 0
        assert top_d[0, :2].tolist() == list(TIE_DOCS)
        assert top_s[0, 0].item() == top_s[0, 1].item() > 0


@pytest.mark.parametrize("mode", MODES)
def test_rerun_bit_identical(engines, mode):
    from repro_torch.kernels.fused_query.kernel import fused_query_kernel
    args = _prepared(engines["delta"], QUERIES, mode, 10)
    runs = [fused_query_kernel(mode=mode, k=10, **args) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(_same_bits(runs[0], r) for r in runs[1:])
