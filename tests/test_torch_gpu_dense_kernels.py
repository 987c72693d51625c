"""The CUDA ``topk_score`` and ``retrieval_dot`` kernels against their
plain versions, on the card.

Imports no jax: inputs are built by the port alone, from seeds, so the file
runs where the card is (``python -m pytest -q -m gpu
tests/test_torch_gpu_dense_kernels.py``; ``chip_smoke.py`` runs it in
phase 2).  Every test skips without a CUDA device, which it decides when it
runs.  The CPU tests that hold the plain versions to the JAX package's ops
are ``tests/test_torch_topk_score.py`` and
``tests/test_torch_retrieval_dot.py``.

``topk_score``: segments of distinct ascending docids, docid 0 present,
n_docs at the kernel's ``TILE`` docids a CUDA block and one off it, a
segment inside one tile, an empty segment, and 16, 17 and 40 segments (a
block stages 16 a pass); every launch equals the plain version bit for
bit, and a second launch the first.

``retrieval_dot``: float32 and bf16 standard-normal rows, n off its two
rows a warp and 16 a block, d off its 256-float pass and not a multiple of
4, q past its 8-row query tile, n = 0, and C's base one row and one float
along; within rtol 1e-5, atol 2e-5 of the plain version (both sum float32
in other orders), a second launch bit-identical to the first.  Rows of
small integers, whose products and sums are exact in float32 in any order,
at d = 4,100 and at the blocking edges: equal to the plain version bit for
bit.  (At d = 4,100, standard-normal rows round past rtol 1e-5 / atol
2e-5 in either order: float32 sums of 4,100 products miss the exact
product by up to ~9e-5 on the card and on the CPU alike.)
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.retrieval_dot import ops
from repro_torch.kernels.retrieval_dot.ref import retrieval_dot_ref
from repro_torch.kernels.topk_score import kernel
from repro_torch.kernels.topk_score.ref import score_ref

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# --------------------------------------------------------------------------
# topk_score
# --------------------------------------------------------------------------


def _postings(nseg, n_docs, seed, with_zero=False):
    rng = np.random.default_rng(seed)
    ds, ws, offsets = [], [], [0]
    for _ in range(nseg):
        n = int(rng.integers(1, n_docs // 2))
        d = np.sort(rng.choice(np.arange(1, n_docs), size=n, replace=False))
        if with_zero:
            d = np.concatenate([[0], d[:-1]])
        ds.append(d.astype(np.int32))
        ws.append((rng.random(n) * 5).astype(np.float32))
        offsets.append(offsets[-1] + n)
    return np.concatenate(ds), np.concatenate(ws), offsets


CASES = [(1, 1500, False), (3, 2048, False), (4, 777, True), (2, 40, True)]


def _run(rng, lo, hi, n):
    return np.sort(rng.choice(np.arange(lo, hi), size=n, replace=False))


#: n_docs at a multiple of the tile and one off it
N_DOCS = {"n_docs T-1": lambda t: t - 1, "n_docs T": lambda t: t,
          "n_docs T+1": lambda t: t + 1, "n_docs 2T-1": lambda t: 2 * t - 1,
          "n_docs 2T+1": lambda t: 2 * t + 1}


def _edge_postings(case):
    """Postings at the kernel's tile edges (``kernel.TILE`` docids a CUDA
    block): (docids, weights, offsets, n_docs)."""
    tile = kernel.TILE
    rng = np.random.default_rng(sum(map(ord, case)))
    if case in N_DOCS:
        n_docs = N_DOCS[case](tile)
        parts = [_run(rng, 1, n_docs, n_docs // 2) for _ in range(3)]
    elif case == "a segment inside one tile":
        n_docs = 6 * tile - 3
        parts = [_run(rng, 1, n_docs, 4 * tile),
                 _run(rng, 2 * tile + 5, 3 * tile - 5, tile // 3),
                 _run(rng, 1, n_docs, 5 * tile)]
    else:                           # an empty segment between full ones
        n_docs = 5 * tile + 1
        parts = [_run(rng, 1, n_docs, 3 * tile), _run(rng, 0, 1, 0),
                 _run(rng, 1, n_docs, 4 * tile)]
    offsets = np.cumsum([0] + [len(p) for p in parts]).tolist()
    d = np.concatenate(parts).astype(np.int32)
    return d, (rng.random(len(d)) * 5).astype(np.float32), offsets, n_docs


EDGES = [*N_DOCS, "a segment inside one tile",
         "an empty segment between full ones"]


def _score_exact(d, w, offsets, n_docs, plain_offsets=None):
    from repro_torch.kernels.topk_score.kernel import score_kernel
    dt, wt = torch.from_numpy(d).cuda(), torch.from_numpy(w).cuda()
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    first = score_kernel(dt, wt, n_docs, off)
    second = score_kernel(dt, wt, n_docs, off)
    plain = score_ref(dt, wt, n_docs, plain_offsets)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert torch.equal(first.cpu().view(torch.int32),
                       plain.cpu().view(torch.int32))


@pytest.mark.parametrize("nseg,n_docs,with_zero", CASES)
def test_cuda_kernel_matches_plain_version(nseg, n_docs, with_zero):
    _need_card()
    d, w, offsets = _postings(nseg, n_docs, seed=nseg + n_docs,
                              with_zero=with_zero)
    _score_exact(d, w, offsets, n_docs)


@pytest.mark.parametrize("case", EDGES + ["16 segments", "17 segments",
                                          "40 segments"])
def test_cuda_kernel_matches_plain_version_at_tile_edges(case):
    _need_card()
    if case in EDGES:
        d, w, offsets, n_docs = _edge_postings(case)
    else:                       # a block stages 16 segments a pass
        n_docs = 20_000
        d, w, offsets = _postings(int(case.split()[0]), n_docs, seed=3)
    _score_exact(d, w, offsets, n_docs, offsets)


# --------------------------------------------------------------------------
# retrieval_dot
# --------------------------------------------------------------------------


SHAPES = [(8, 700, 96), (1, 2048, 256), (17, 333, 64), (3, 1000, 30)]
#: at the kernel's blocking: n off its 2 rows a warp and 16 a block, d off
#: its 256-float pass and d % 4 != 0, q past its 8-row query tile
EDGE_SHAPES = [(1, 7, 256), (1, 4099, 256), (17, 4099, 30), (2, 333, 31),
               (9, 17, 260)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
RTOL, ATOL = 1e-5, 2e-5


def _inputs(q, n, d, dtype, integer=False):
    """(q, cand) on the card, standard normal values from a seed, rounded
    to ``dtype``; with ``integer``, integers in [-2, 2] instead."""
    rng = np.random.default_rng(q * n + d)
    if integer:
        qv = rng.integers(-2, 3, (q, d)).astype(np.float32)
        cv = rng.integers(-2, 3, (n, d)).astype(np.float32)
    else:
        qv = rng.standard_normal((q, d)).astype(np.float32)
        cv = rng.standard_normal((n, d)).astype(np.float32)
    return (torch.from_numpy(qv).to(DTYPES[dtype]).cuda(),
            torch.from_numpy(cv).to(DTYPES[dtype]).cuda())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q,n,d", SHAPES + EDGE_SHAPES + [(1, 0, 256)])
def test_cuda_retrieval_dot_matches_plain_version(q, n, d, dtype):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tq, tc = _inputs(q, n, d, dtype)
    first = ops.candidate_scores(tq, tc)
    second = ops.candidate_scores(tq, tc)
    assert torch.equal(first, second)            # bit-identical rerun
    np.testing.assert_allclose(first.cpu().numpy(),
                               retrieval_dot_ref(tq, tc).cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q,n,d", EDGE_SHAPES + [(2, 333, 4100)])
def test_cuda_retrieval_dot_exact_on_integer_rows(q, n, d, dtype):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tq, tc = _inputs(q, n, d, dtype, integer=True)
    got = ops.candidate_scores(tq, tc)
    assert torch.equal(got, retrieval_dot_ref(tq, tc))


@pytest.mark.parametrize("offset", ["one row", "one float"])
def test_cuda_retrieval_dot_matches_plain_version_at_an_offset_base(offset):
    """C's base one row along (aligned) or one float along (unaligned: the
    kernel's scalar loop)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tq, flat = _inputs(8, 334, 256, "f32")
    cand = flat[1:] if offset == "one row" else \
        flat.flatten()[1:1 + 333 * 256].view(333, 256)
    first = ops.candidate_scores(tq, cand)
    assert torch.equal(first, ops.candidate_scores(tq, cand))
    np.testing.assert_allclose(first.cpu().numpy(),
                               retrieval_dot_ref(tq, cand).cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
