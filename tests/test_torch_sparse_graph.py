"""The port's segment ops (``repro_torch.sparse.ops``: ``segment_max``,
``segment_mean``, ``segment_softmax``, ``coalesce_edges``) and graph
substrate (``repro_torch.data.graph``) against the JAX package's, on the
CPU.

* Segment ops: the same numpy inputs (1-D and (E, 3) data, float32 and
  int32, empty segments, ties for a maximum, out-of-range ids, negative
  ids) through both.  Maxima, counts and int results exactly; float
  results within rtol 1e-6; the gradients of ``segment_max`` (a tie's
  gradient split evenly), ``segment_mean`` and ``segment_softmax``
  against ``jax.grad`` within rtol 1e-6.
* ``coalesce_edges``: where ``n * n < 2**31`` the two orders are equal bit
  for bit.  Past it the reference's int32 key wraps (x64 is off), so its
  order is not sorted by destination, and the port's is: both sides are
  pinned.
* ``data/graph.py``: ``synthetic_power_law``, ``edges_coo``,
  ``neighbor_sample`` under the same ``np.random.Generator`` and
  ``pad_block`` return the reference's arrays bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graph as jgraph
from repro.sparse import ops as jops
from repro_torch.data import graph as tgraph
from repro_torch.sparse import ops as tops

RTOL = 1e-6
NUM_SEGMENTS = 7


def _inputs(seed: int, shape, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Data of ``shape`` and segment ids over [-2, NUM_SEGMENTS + 2):
    segments 3 and 5 are empty, a few ids are out of range (negative or
    past the end), and the first two rows tie for their segment's
    maximum."""
    rng = np.random.default_rng(seed)
    n = shape[0]
    ids = rng.choice([0, 1, 2, 4, 6], size=n)
    ids[-3:] = [-1, NUM_SEGMENTS, NUM_SEGMENTS + 1]
    if np.issubdtype(dtype, np.integer):
        data = rng.integers(-50, 50, shape).astype(dtype)
    else:
        data = rng.standard_normal(shape).astype(dtype)
    ids[:2] = 2
    data[1] = data[0]
    data[0] = data[1] = np.abs(data).max() + 1   # the maximum of segment 2
    return data, ids.astype(np.int32)


CASES = [((40,), np.float32), ((40, 3), np.float32), ((40,), np.int32),
         ((33, 3), np.int32)]


@pytest.mark.parametrize("shape,dtype", CASES)
def test_segment_max_matches(shape, dtype):
    data, ids = _inputs(0, shape, dtype)
    want = np.asarray(jops.segment_max(jnp.asarray(data), jnp.asarray(ids),
                                       NUM_SEGMENTS))
    got = tops.segment_max(torch.from_numpy(data), torch.from_numpy(ids),
                           NUM_SEGMENTS).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the empty segments hold the dtype's identity
    ident = -np.inf if dtype == np.float32 else np.iinfo(dtype).min
    assert (got[3] == ident).all() and (got[5] == ident).all()


@pytest.mark.parametrize("shape,dtype", CASES)
def test_segment_mean_matches(shape, dtype):
    data, ids = _inputs(1, shape, dtype)
    want = np.asarray(jops.segment_mean(jnp.asarray(data), jnp.asarray(ids),
                                        NUM_SEGMENTS))
    got = tops.segment_mean(torch.from_numpy(data), torch.from_numpy(ids),
                            NUM_SEGMENTS).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert (got[3] == 0).all() and (got[5] == 0).all()


def test_segment_mean_counts_exactly():
    """A mean of ones is 1 in a filled segment and 0 in an empty one,
    whatever the count: the counts are exact."""
    _, ids = _inputs(2, (40,), np.float32)
    ones = np.ones(40, np.float32)
    want = np.asarray(jops.segment_mean(jnp.asarray(ones), jnp.asarray(ids),
                                        NUM_SEGMENTS))
    got = tops.segment_mean(torch.from_numpy(ones), torch.from_numpy(ids),
                            NUM_SEGMENTS).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 1, 1, 0, 1, 0, 1])


@pytest.mark.parametrize("shape", [(40,), (40, 3)])
def test_segment_softmax_matches(shape):
    """Out-of-range ids included: the reference reads the clamped
    segment's maximum and sum back (an id past the end reads the last,
    empty segment: inf), and so does the port."""
    data, ids = _inputs(3, shape, np.float32)
    want = np.asarray(jops.segment_softmax(jnp.asarray(data),
                                           jnp.asarray(ids), NUM_SEGMENTS))
    got = tops.segment_softmax(torch.from_numpy(data), torch.from_numpy(ids),
                               NUM_SEGMENTS).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    inside = (ids >= 0) & (ids < NUM_SEGMENTS)
    sums = np.zeros((NUM_SEGMENTS, *shape[1:]))
    np.add.at(sums, ids[inside], got[inside])
    np.testing.assert_allclose(sums[[0, 1, 2, 4, 6]], 1.0, rtol=1e-5)


def _grads(fn_j, fn_t, data, ids, weights):
    """jax.grad and torch's autograd of sum(weights * fn(data))."""
    w = jnp.asarray(weights)
    want = jax.grad(lambda x: jnp.sum(
        w * fn_j(x, jnp.asarray(ids), NUM_SEGMENTS)))(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    out = fn_t(x, torch.from_numpy(ids), NUM_SEGMENTS)
    (torch.from_numpy(weights) * out).sum().backward()
    return x.grad.numpy(), np.asarray(want)


@pytest.mark.parametrize("shape", [(40,), (40, 3)])
def test_segment_max_gradient_splits_a_tie(shape):
    data, ids = _inputs(4, shape, np.float32)
    rng = np.random.default_rng(4)
    weights = rng.standard_normal((NUM_SEGMENTS, *shape[1:])).astype(
        np.float32)
    weights[3] = weights[5] = 0            # -inf rows times 0 would be NaN
    got, want = _grads(jops.segment_max, tops.segment_max, data, ids, weights)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # the two tied rows of segment 2 take half its weight each
    np.testing.assert_allclose(got[0], weights[2] / 2, rtol=RTOL)
    np.testing.assert_allclose(got[1], weights[2] / 2, rtol=RTOL)
    assert (got[-3:] == 0).all()           # out-of-range ids: no gradient


@pytest.mark.parametrize("op", ["segment_mean", "segment_softmax"])
@pytest.mark.parametrize("shape", [(40,), (40, 3)])
def test_segment_gradients_match(op, shape):
    data, ids = _inputs(5, shape, np.float32)
    rng = np.random.default_rng(5)
    if op == "segment_softmax":
        ids = np.where((ids >= 0) & (ids < NUM_SEGMENTS), ids, 0).astype(
            np.int32)                       # no inf in the gradient
        weights = rng.standard_normal(shape).astype(np.float32)
    else:
        weights = rng.standard_normal((NUM_SEGMENTS, *shape[1:])).astype(
            np.float32)
    got, want = _grads(getattr(jops, op), getattr(tops, op), data, ids,
                       weights)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("n,m", [(50, 300), (1000, 4000), (46340, 2000)])
def test_coalesce_edges_equals_the_reference_below_the_wrap(n, m):
    assert n * n < 2 ** 31
    rng = np.random.default_rng(n)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    src[:5], dst[:5] = 3, 7                 # duplicate edges: a stable sort
    js, jd, jo = jops.coalesce_edges(jnp.asarray(src), jnp.asarray(dst), n)
    ts, td, to = tops.coalesce_edges(torch.from_numpy(src),
                                     torch.from_numpy(dst), n)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert ts.dtype == torch.int32 and td.dtype == torch.int32


def test_coalesce_edges_past_the_wrap_only_the_port_sorts():
    """n = 100,000: ``dst * n`` passes 2**31 and the reference's int32 key
    wraps, so its order is not sorted by destination (C4); the port's
    int64 key sorts by (dst, src)."""
    n, m = 100_000, 1000
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    key = jnp.asarray(dst).astype(jnp.int64) * n + jnp.asarray(src)
    assert key.dtype == jnp.int32                   # x64 off: int32
    js, jd, _ = jops.coalesce_edges(jnp.asarray(src), jnp.asarray(dst), n)
    assert not (np.diff(np.asarray(jd)) >= 0).all()
    ts, td, to = tops.coalesce_edges(torch.from_numpy(src),
                                     torch.from_numpy(dst), n)
    want = np.lexsort((src, dst))
    np.testing.assert_array_equal(to.numpy(), want)
    np.testing.assert_array_equal(td.numpy(), dst[want])
    np.testing.assert_array_equal(ts.numpy(), src[want])


@pytest.mark.parametrize("n,deg,seed", [(200, 5, 0), (1000, 12, 3)])
def test_synthetic_power_law_and_coo_bit_for_bit(n, deg, seed):
    jg = jgraph.synthetic_power_law(n, deg, seed=seed)
    tg = tgraph.synthetic_power_law(n, deg, seed=seed)
    assert (tg.n_nodes, tg.n_edges) == (jg.n_nodes, jg.n_edges) == \
        (n, n * deg)
    for a, b in ((tg.indptr, jg.indptr), (tg.indices, jg.indices)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert [tg.degree(v) for v in range(0, n, 37)] == \
        [jg.degree(v) for v in range(0, n, 37)]
    for a, b in zip(tgraph.edges_coo(tg), jgraph.edges_coo(jg)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fanouts,seed", [([5, 3], 0), ([4, 4, 2], 1),
                                          ([20], 2)])
def test_neighbor_sample_and_pad_block_bit_for_bit(fanouts, seed):
    """The sampler under two generators of one seed; a fanout above some
    degrees (sampled with replacement) and nodes of degree 0."""
    jg = jgraph.synthetic_power_law(300, 6, seed=seed)
    tg = tgraph.synthetic_power_law(300, 6, seed=seed)
    seeds = np.random.default_rng(seed).choice(300, 16, replace=False)
    jb = jgraph.neighbor_sample(jg, seeds, fanouts,
                                np.random.default_rng(seed + 10))
    tb = tgraph.neighbor_sample(tg, seeds, fanouts,
                                np.random.default_rng(seed + 10))
    assert len(tb) == len(jb) == len(fanouts)
    for t, j in zip(tb, jb):
        for f in ("src", "dst", "mask", "nodes"):
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b)
        n_pad = len(j.nodes) + 17
        tp, jp = tgraph.pad_block(t, n_pad), jgraph.pad_block(j, n_pad)
        np.testing.assert_array_equal(tp.nodes, jp.nodes)
        assert len(tp.nodes) == n_pad


def test_power_law_hot_spot():
    """The generator's destinations are zipf(1.5) mod n: node 1 takes about
    1/zeta(1.5) = 38 % of the edges."""
    g = tgraph.synthetic_power_law(20_000, 10, seed=0)
    share = float(np.mean(g.indices == 1))
    assert 0.36 < share < 0.40
