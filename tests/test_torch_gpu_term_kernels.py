"""The CUDA ``dvbyte_decode`` and ``intersect`` kernels against their plain
versions, on the card.

Imports no jax: inputs are built by the port alone, from seeds, so the file
runs where the card is (``python -m pytest -q -m gpu
tests/test_torch_gpu_term_kernels.py``; ``chip_smoke.py`` runs it in phase
2).  Every test skips without a CUDA device, which it decides when it runs.

``dvbyte_decode``: a half-warp decodes one block, two a warp, eight a
CTA.  The cases are the chain blocks a seeded
Const engine gathers (escapes at F = 4, heads past H, tails, empty slots)
and constructed rows (:func:`constructed_rows`, which the CPU tests also
hold the kernel's numpy mirror to): escape runs of odd and even length,
5-byte codes, a null tail, ``start > H``, ``end < B``, ``end <= start``,
``end > B``, an escape primary whose consumed value is the block's last
code, and random bytes; NB = 1, NB off a warp's two and a CTA's eight
blocks, blocks narrower than 64 bytes and blocks at an odd address (the
kernel's one-element path).

``intersect``: one launch for a and n further lists.  The cases: an empty
list, a list of one docid, PAD in a and in the lists, a wholly below or
above a list, windows across the 256-element tiles of a, a window longer
than the 2,048 docids staged at once, and 1-4 further lists.

Each launch is held bit for bit against the plain version on the same
tensors, and a second launch is bit-identical to the first.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.blockstore import H
from repro_torch.core.dvbyte import vbyte_encode_array

pytestmark = pytest.mark.gpu

F = 4
B = 64
PAD = np.iinfo(np.int32).max


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# dvbyte_decode
# --------------------------------------------------------------------------


def _row(values, start=H, end=None, fill=0, width=B, lead=0x80):
    """One block: ``values`` VByte-coded from ``start`` (bytes before it
    ``lead``, after the codes ``fill``); ``end`` defaults to the end of the
    codes."""
    code = vbyte_encode_array(np.asarray(values, np.uint64))
    row = np.full(width, fill, np.uint8)
    row[:max(0, min(start, width))] = lead
    s = max(start, 0)
    n = max(0, min(len(code), width - s))
    row[s:s + n] = code[:n]
    return row, start, s + n if end is None else end


#: cases of :func:`constructed_rows` whose payload prefix sums leave
#: [0, 2^31): bytes no block store writes, where only the port's plain
#: version, which takes each value as a difference of wrapped int32 prefix
#: sums, is the yardstick
ANY_BYTES = ("prefix sums past 2^31", "random bytes")


def constructed_rows(seed: int = 5, width: int = B):
    """name -> (blocks (n, width) uint8, start (n,) int32, end (n,) int32)
    at F = 4 (an escape is a value divisible by 4)."""
    rng = np.random.default_rng(seed)
    cases = {
        "escape runs of odd length": [_row([5, 8, 2, 8, 8, 8, 3, 1])],
        "escape runs of even length": [_row([8, 8, 8, 8, 6]),
                                       _row([1, 8, 8, 12, 16, 5, 2])],
        "5-byte codes": [_row([2 ** 28 + 1, 2 ** 29 + 4, 9, 2 ** 28 + 3]),
                         _row([7, 2 ** 29 + 4, 2 ** 28 + 5, 12, 2 ** 28])],
        "a null tail": [_row([9, 13, 8, 1], end=width)],
        "start > H": [_row([6, 8, 3, 10], start=9),
                      _row([7, 11], start=23)],
        "end < B": [_row([3] * 40, end=37), _row([2 ** 20, 2 ** 21] * 8,
                                                  end=29)],
        "end <= start": [_row([5, 6, 7], start=20, end=5),
                         _row([5, 6, 7], start=12, end=12),
                         _row([5, 6, 7], start=70, end=80)],
        "end > B, start < 0": [_row(list(range(1, 70)), start=-3, end=100),
                               _row([8, 4, 5, 9] * 20, start=0, end=200)],
        "a consumed value is the last code": [_row([3, 8, 2]),
                                              _row([5, 8, 9, 8, 2 ** 29])],
        "an escape with nothing after it": [_row([3, 8]),
                                            _row([1, 2, 8], end=width)],
        "a consumed value lanes away": [
            (np.concatenate([vbyte_encode_array(np.asarray([8], np.uint64)),
                             np.full(40, 0x80, np.uint8), [1],
                             np.zeros(B - 42, np.uint8)])[:width]
             .astype(np.uint8), 0, width)],
        "no terminator": [(np.full(width, 0xFF, np.uint8), 0, width)],
        "all zero": [(np.zeros(width, np.uint8), 0, width)],
        # up to 30 values below 2^26: prefix sums stay below 2^31
        "random codes": [_row(rng.integers(1, 2 ** int(rng.integers(3, 27)),
                                           int(rng.integers(1, 30))),
                              start=int(rng.integers(0, 12)))
                         for _ in range(24)],
        # past here, rows the block store cannot emit
        "prefix sums past 2^31": [
            _row([2 ** 30 + 7, 2 ** 28 + 1, 12, 2 ** 31 - 1, 2 ** 30, 3]),
            _row([2 ** 31 - 4, 2 ** 31 - 1, 5, 8, 2 ** 31 - 2, 1])],
        "random bytes": [(rng.integers(0, 256, width).astype(np.uint8),
                          int(rng.integers(-4, width)),
                          int(rng.integers(0, width + 8)))
                         for _ in range(24)],
    }
    out = {}
    for name, rows in cases.items():
        out[name] = (np.stack([r[0][:width] for r in rows]),
                     np.asarray([r[1] for r in rows], np.int32),
                     np.asarray([r[2] for r in rows], np.int32))
    return out


def _decode_held(blocks, start, end):
    """One decode launch held against the plain version; returns it."""
    from repro_torch.core.device_index import decode_blocks
    from repro_torch.kernels.dvbyte_decode.kernel import dvbyte_decode_kernel
    first = dvbyte_decode_kernel(blocks, start, end, F)
    second = dvbyte_decode_kernel(blocks, start, end, F)
    plain = decode_blocks(blocks, start, end, F)
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, plain):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, b)
        assert torch.equal(a, c)
    return first


@pytest.fixture(scope="module")
def chain_blocks():
    """The chain blocks a seeded Const engine on the card gathers for 32
    ranked queries, per image: (blocks, start, end)."""
    dev = _card()
    from repro_torch.core.device_index import gather_chains
    from repro_torch.engine import Engine, Query
    from repro_torch.engine.device_backend import pack_queries
    rng = np.random.default_rng(41)
    V = 200
    names = [f"t{i}" for i in range(V)]
    p = 1.0 / np.arange(1, V + 1) ** 1.07
    p /= p.sum()
    docs = [[names[i] for i in rng.choice(V, size=int(rng.integers(4, 90)),
                                          p=p)] for _ in range(700)]
    eng = Engine(B=B, growth="const", delta_compact_frac=None, device=dev)
    eng.add_documents(docs[:500])
    eng.collate_now()
    eng.add_documents(docs[500:])
    res = eng.resident
    res.refresh()
    qs = []
    while len(qs) < 32:
        terms = tuple(dict.fromkeys(
            names[i] for i in rng.choice(V, size=int(rng.integers(1, 5)),
                                         p=p)))
        if all(eng.term_id(t) is not None for t in terms):
            qs.append(Query(terms=terms, mode="ranked_tfidf", k=10))
    _live, qt, qm, _caps = pack_queries(eng, res, qs, "ranked_tfidf")
    return [gather_chains(img, qt, qm, mb)
            for img, mb in zip(res.images, res.max_blocks)]


@pytest.mark.parametrize("image", [0, 1], ids=["frozen", "delta"])
def test_decode_chain_blocks(chain_blocks, image):
    blocks, start, end = chain_blocks[image]
    g, f, v = _decode_held(blocks, start, end)
    assert bool(v.any()) and bool((end == 0).any())
    if image == 0:   # the frozen chains hold escapes, heads and tails
        assert bool((f[v] >= F).any())
        assert bool((start > H).any())
        assert bool(((end > 0) & (end < B)).any())


@pytest.mark.parametrize("case", list(constructed_rows()))
def test_decode_constructed_rows(case):
    dev = _card()
    blocks, start, end = (torch.from_numpy(x).to(dev)
                          for x in constructed_rows()[case])
    _decode_held(blocks, start, end)


def _all_rows(width=B):
    rows = constructed_rows(width=width).values()
    return tuple(torch.from_numpy(np.concatenate(x)) for x in zip(*rows))


@pytest.mark.parametrize("nb", [1, 2, 15, 17, 31, 32, 33, 255, 256, 257,
                                1001])
def test_decode_row_counts(nb):
    """NB = 1 and NB off a warp's two blocks and a CTA's eight."""
    dev = _card()
    blocks, start, end = _all_rows()
    reps = -(-nb // blocks.shape[0])
    blocks, start, end = (x.repeat(reps, *([1] * (x.dim() - 1)))[:nb].to(dev)
                          for x in (blocks, start, end))
    _decode_held(blocks, start, end)


@pytest.mark.parametrize("width", [1, 7, 32, 63])
def test_decode_narrow_blocks(width):
    """B < 64: the one-element path, positions past B absent."""
    dev = _card()
    _decode_held(*(x.to(dev) for x in _all_rows(width)))


def test_decode_unaligned_blocks():
    """Blocks whose base is one byte off: the one-element path."""
    dev = _card()
    blocks, start, end = (x.to(dev) for x in _all_rows())
    flat = torch.zeros(blocks.numel() + 1, dtype=torch.uint8, device=dev)
    flat[1:] = blocks.flatten()
    shifted = flat[1:].view(blocks.shape)
    assert shifted.data_ptr() % 4 == 1
    _decode_held(shifted, start, end)


def test_decode_refuses_wide_blocks():
    dev = _card()
    from repro_torch.kernels.dvbyte_decode.kernel import dvbyte_decode_kernel
    blocks = torch.zeros((4, 65), dtype=torch.uint8, device=dev)
    bounds = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bytes"):
        dvbyte_decode_kernel(blocks, bounds, bounds, F)


# --------------------------------------------------------------------------
# intersect
# --------------------------------------------------------------------------


def _sorted(g, n, lo, hi):
    return np.unique(g.integers(lo, hi, n)).astype(np.int32)


def intersect_cases(seed: int = 19):
    """name -> (a, [further lists]) of sorted int32 docids."""
    g = np.random.default_rng(seed)
    pad = np.full(30, PAD, np.int32)
    dense = np.arange(1, 20_001, dtype=np.int32)
    return {
        "an empty list": (_sorted(g, 900, 1, 5000), [np.zeros(0, np.int32)]),
        "an empty list among others": (
            _sorted(g, 900, 1, 5000),
            [_sorted(g, 2000, 1, 5000), np.zeros(0, np.int32)]),
        "a list of one docid": (_sorted(g, 900, 1, 5000),
                                [np.asarray([1234], np.int32)]),
        "PAD in a and in the lists": (
            np.concatenate([_sorted(g, 700, 1, 3000), pad]),
            [np.concatenate([_sorted(g, 1500, 1, 3000), pad[:7]]),
             np.concatenate([_sorted(g, 2500, 1, 3000), pad[:1]])]),
        "a of PAD only": (pad.copy(), [_sorted(g, 50, 1, 100)]),
        "a wholly below the list": (_sorted(g, 600, 1, 1000),
                                    [_sorted(g, 600, 2000, 3000)]),
        "a wholly above the list": (_sorted(g, 600, 5000, 9000),
                                    [_sorted(g, 600, 1, 3000)]),
        "windows across tile edges": (
            dense[::3].copy(), [dense[::2].copy(), dense[::5].copy()]),
        "a window longer than the buffer": (
            np.asarray([1, 9_000, 19_999], np.int32), [dense.copy()]),
        "wide tiles over a long list": (
            _sorted(g, 3000, 1, 200_000),
            [np.arange(1, 200_001, dtype=np.int32)]),
        "lengths off the tiles": (_sorted(g, 1000, 1, 4000)[:257],
                                  [_sorted(g, 3000, 1, 4000)[:2049]]),
        **{f"{n} further lists": (
            _sorted(g, 4000, 1, 60_000),
            [_sorted(g, int(g.integers(8000, 40_000)), 1, 60_000)
             for _ in range(n)]) for n in (1, 2, 3, 4)},
        "nine further lists": (
            _sorted(g, 3000, 1, 5000),
            [_sorted(g, 4500, 1, 5000) for _ in range(9)]),
        "Path A's round-2 shape, 3 further lists": (
            np.sort(g.choice(np.arange(1, 98_733), 91_737,
                             replace=False)).astype(np.int32),
            [np.arange(1, 98_733, dtype=np.int32),
             _sorted(g, 90_000, 1, 98_733), _sorted(g, 95_000, 1, 98_733)]),
    }


def _on(dev, a, lists):
    bounds = np.cumsum([0] + [len(x) for x in lists]).astype(np.int32)
    return (torch.from_numpy(a).to(dev),
            torch.from_numpy(np.concatenate(lists)).to(dev),
            torch.from_numpy(bounds).to(dev))


@pytest.mark.parametrize("case", list(intersect_cases()))
def test_intersect_cases(case):
    dev = _card()
    from repro_torch.kernels.intersect.kernel import intersect_kernel
    from repro_torch.kernels.intersect.ref import intersect_all_ref
    a, lists = intersect_cases()[case]
    ta, tb, off = _on(dev, a, lists)
    first = intersect_kernel(ta, tb, off)
    second = intersect_kernel(ta, tb, off)
    plain = intersect_all_ref(ta, tb, off)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, plain)
    want = (a != PAD) & np.logical_and.reduce([np.isin(a, x) for x in lists])
    assert np.array_equal(first.cpu().numpy(), want)


@pytest.mark.parametrize("case", ["2 further lists",
                                  "PAD in a and in the lists"])
def test_intersect_one_list_form(case):
    """Without offsets, ``b`` is one list: the n = 1 case of the op."""
    dev = _card()
    from repro_torch.kernels.intersect import ops
    from repro_torch.kernels.intersect.ref import intersect_ref
    a, lists = intersect_cases()[case]
    ta, tb = (torch.from_numpy(x).to(dev) for x in (a, lists[0]))
    got = ops.intersect_sorted(ta, tb)
    assert torch.equal(got, ops.intersect_sorted(ta, tb))
    assert torch.equal(got, intersect_ref(ta, tb))


def test_intersect_empty_a_launches_nothing():
    dev = _card()
    from repro_torch.kernels.intersect import kernel
    before = kernel.launches
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    b = torch.arange(1, 10, dtype=torch.int32, device=dev)
    assert kernel.intersect_kernel(none, b).shape == (0,)
    assert kernel.launches == before


def test_intersect_counts_one_launch_for_all_lists():
    dev = _card()
    from repro_torch.kernels.intersect import kernel
    a, lists = intersect_cases()["4 further lists"]
    before = kernel.launches
    kernel.intersect_kernel(*_on(dev, a, lists))
    assert kernel.launches == before + 1
