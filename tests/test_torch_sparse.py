"""The port's embedding bags and segment sums against the JAX package's.

The same table, ids, offsets and weights, made from a seed with numpy, go
through ``repro.sparse.ops`` and ``repro_torch.sparse.ops`` on the CPU.
Tolerance rtol 1e-6 (atol 1e-7 for sums that cancel to near zero): both
sides add the same float32 rows, possibly in another order.  Ids past the
table read its last row, as a JAX gather clamps them; negative ids count
from the end.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import ops as jops
from repro_torch.sparse import ops

RTOL, ATOL = 1e-6, 1e-7
ROWS, D = 50, 12


def _table(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (ROWS, D)).astype(np.float32)


def _fixed(seed, with_oob):
    rng = np.random.default_rng(seed)
    hi = ROWS + 20 if with_oob else ROWS
    ids = rng.integers(0, hi, (6, 5)).astype(np.int32)
    if with_oob:
        ids[0, 0], ids[1, 2] = ROWS, -3      # one past the end; from the end
    w = (rng.random((6, 5)) < 0.7).astype(np.float32) * rng.random((6, 5),
                                                                   np.float32)
    return ids, w


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("with_oob", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_fixed_bags_match_jax(mode, weighted, with_oob):
    table = _table()
    ids, w = _fixed(1, with_oob)
    kw = {"weights": w} if weighted else {}
    want = jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              mode=mode, **{k: jnp.asarray(v)
                                            for k, v in kw.items()})
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            mode=mode, **{k: torch.from_numpy(v)
                                          for k, v in kw.items()})
    assert got.shape == (6, D)
    _close(got, want)


def _flat(seed, with_oob):
    rng = np.random.default_rng(seed)
    hi = ROWS + 20 if with_oob else ROWS
    ids = rng.integers(0, hi, 23).astype(np.int32)
    if with_oob:
        ids[3] = ROWS
    offsets = np.array([0, 4, 4, 9, 17], np.int32)   # bag 1 is empty
    w = rng.random(23).astype(np.float32)
    return ids, offsets, w


@pytest.mark.parametrize("with_oob", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_flat_bags_match_jax(mode, weighted, with_oob):
    table = _table(2)
    ids, offsets, w = _flat(3, with_oob)
    kw = {"weights": w} if weighted else {}
    want = jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              offsets=jnp.asarray(offsets), mode=mode,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            offsets=torch.from_numpy(offsets), mode=mode,
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (len(offsets), D)
    _close(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_flat_max_is_the_bag_maximum(weighted):
    """The flat form's ``max`` (the reference's flat form returns the sum):
    equal bags give the fixed form's maximum, which the reference computes;
    an empty bag gives zeros."""
    table = _table(4)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, ROWS + 5, (4, 6)).astype(np.int32)
    w = rng.random((4, 6)).astype(np.float32)
    kw_j = {"weights": jnp.asarray(w)} if weighted else {}
    want = jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              mode="max", **kw_j)
    flat = torch.from_numpy(ids.reshape(-1))
    kw_t = {"weights": torch.from_numpy(w.reshape(-1))} if weighted else {}
    got = ops.embedding_bag(torch.from_numpy(table), flat,
                            offsets=torch.tensor([0, 6, 12, 18]), mode="max",
                            **kw_t)
    _close(got, want)
    got = ops.embedding_bag(torch.from_numpy(table), flat[:6],
                            offsets=torch.tensor([0, 6]), mode="max")
    assert torch.equal(got[1], torch.zeros(D))


@pytest.mark.parametrize("num_segments", [1, 4, 9])
def test_segment_sum_matches_jax(num_segments):
    rng = np.random.default_rng(num_segments)
    data = rng.standard_normal((40, 3)).astype(np.float32)
    seg = rng.integers(-2, num_segments + 2, 40).astype(np.int32)  # drops
    want = jops.segment_sum(jnp.asarray(data), jnp.asarray(seg), num_segments)
    got = ops.segment_sum(torch.from_numpy(data), torch.from_numpy(seg),
                          num_segments)
    _close(got, want)
    got1 = ops.segment_sum(torch.from_numpy(data[:, 0]),
                           torch.from_numpy(seg), num_segments)
    _close(got1, jops.segment_sum(jnp.asarray(data[:, 0]), jnp.asarray(seg),
                                  num_segments))


def test_take_rows_clamps_like_a_jax_gather():
    table = _table(6)
    ids = np.array([0, ROWS - 1, ROWS, ROWS + 1000, -1, -ROWS, -ROWS - 7],
                   np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    got = ops.take_rows(torch.from_numpy(table), torch.from_numpy(ids))
    assert np.array_equal(got.numpy(), want)


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        ops.embedding_bag(torch.zeros(3, 2),
                          torch.zeros(1, 2, dtype=torch.int64), mode="min")
