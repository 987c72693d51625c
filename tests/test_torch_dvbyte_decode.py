"""The port's block decode and ``query_step`` against the JAX package's.

A JAX engine (Const growth, B = 64, F = 4) with a mid-stream freeze and a
post-freeze delta builds the resident (frozen, delta) images; their fields
are carried across with ``repro_torch.convert.image_from_arrays``, so both
packages decode the same blocks and answer the same query batches.

* ``decode_blocks``: exact against the JAX ``decode_blocks`` on every
  valid position (the reference leaves values at consumed positions, the
  port zeroes them) and exact, all positions, against the JAX Pallas
  ``dvbyte_decode_blocks`` in interpret mode.
* ``query_step`` in all four modes on both images, the JAX side decoding
  with its closed-form ``decode_blocks_parallel`` (equal to its
  ``decode_blocks`` on every valid position, which is all ``query_step``
  reads, and far quicker to compile): conjunctive bitmaps
  exact; ranked docids equal up to swaps among scores within rtol 1e-6,
  scores within rtol 1e-6 for the dense "ranked" mode (XLA's and PyTorch's
  ``log1p`` and division may differ by one ulp).  The sort-based modes
  ("ranked_sparse", "bm25") take each docid's score as a difference of two
  float32 prefix sums over the whole row in the reference, which rounds at
  the size of the row's total weight; the port sums each run exactly.  Their
  tolerance is rtol 1e-6 plus 4 ulp of the row's total weight.

The CUDA kernel is held against the plain version by the ``gpu`` test,
which runs only where there is a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.device_index import decode_blocks as jax_decode_blocks
from repro.core.device_index import query_step as jax_query_step
from repro.engine import Engine as JaxEngine
from repro.kernels.dvbyte_decode.ops import \
    dvbyte_decode_blocks as jax_dvbyte_decode_blocks
from repro.kernels.fused_query.ref import decode_blocks_parallel
from repro_torch.core.device_index import (decode_blocks, gather_chains,
                                           query_step)
from repro_torch.kernels.dvbyte_decode import ops

from test_torch_fused_query import _port_image, assert_ranking

QS_MODES = ("conjunctive", "ranked", "ranked_sparse", "bm25")


@pytest.fixture(scope="module")
def jax_state():
    """180 docs frozen, 120 in the delta; terms with f_{t,d} >= F = 4 give
    escapes."""
    rng = np.random.default_rng(71)
    V = 90
    vocab = [f"w{i}" for i in range(V)]
    probs = 1.0 / np.arange(1, V + 1) ** 1.07
    probs /= probs.sum()
    docs = [[vocab[i] for i in rng.choice(V, size=int(rng.integers(3, 60)),
                                          p=probs)] for _ in range(300)]
    e = JaxEngine(B=64, growth="const")
    e.add_documents(docs[:180])
    e.collate_now()
    for d in docs[180:]:
        e.add_document(d)
    e.resident.refresh()
    return e


def _queries(e, seed, n=8, T=4):
    rng = np.random.default_rng(seed)
    qt = np.zeros((n, T), np.int32)
    qm = np.zeros((n, T), bool)
    for row in range(n):
        nt = int(rng.integers(1, T + 1))
        qt[row, :nt] = rng.choice(min(70, len(e.vocab)), size=nt,
                                  replace=False)
        qm[row, :nt] = True
    return qt, qm


def _gathered(e, image_idx, seed=3):
    """A real query batch's gathered chain blocks and payload bounds."""
    img = _port_image(e.resident.images[image_idx])
    qt, qm = _queries(e, seed)
    mb = e.resident.max_blocks[image_idx]
    return gather_chains(img, torch.from_numpy(qt), torch.from_numpy(qm), mb)


def test_decode_blocks_matches_jax_exactly(jax_state):
    """Both images' gathered blocks, decoded in one call."""
    blocks, start, end = (torch.cat(x) for x in zip(
        _gathered(jax_state, 0), _gathered(jax_state, 1)))
    g, f, v = decode_blocks(blocks, start, end, 4)
    jg, jf, jv = (np.asarray(x) for x in jax_decode_blocks(
        jnp.asarray(blocks.numpy()), jnp.asarray(start.numpy()),
        jnp.asarray(end.numpy()), 4))
    g, f, v = g.numpy(), f.numpy(), v.numpy()
    assert np.array_equal(v, jv)
    assert np.array_equal(g * v, jg * jv) and np.array_equal(f * v, jf * jv)
    assert not (g[~v].any() or f[~v].any())
    # the blocks hold escapes, heads with start > H, tails with end < B
    assert (f[v] >= 4).any()
    assert (start.numpy() > 4).any() and ((end > 0) & (end < 64)).any()
    assert (end.numpy() == 0).any()


def test_decode_blocks_matches_the_jax_pallas_kernel(jax_state):
    blocks, start, end = _gathered(jax_state, 1, seed=5)
    n = 256
    got = decode_blocks(blocks[:n], start[:n], end[:n], 4)
    want = jax_dvbyte_decode_blocks(
        jnp.asarray(blocks[:n].numpy()), jnp.asarray(start[:n].numpy()),
        jnp.asarray(end[:n].numpy()), F=4, tile=64, interpret=True)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _row_total(e, image_idx, qt, qm, mode):
    """Per-row total weight: the magnitude the reference's prefix sums
    round at (sum of every docid's score)."""
    img = _port_image(e.resident.images[image_idx])
    res = e.resident
    kw = _port_kw(e, "bm25" if mode == "bm25" else "ranked")
    d, s = query_step(img, torch.from_numpy(qt), torch.from_numpy(qm),
                      k=1 << 20, mode=mode,
                      max_blocks=res.max_blocks[image_idx], **kw)
    s = s.numpy()
    return np.where(np.isfinite(s), s, 0).sum(axis=1)


def _port_kw(e, mode):
    res = e.resident
    return dict(
        doclens=(torch.from_numpy(np.array(res._doclens))
                 if mode == "bm25" else None),
        n_stat=int(res._n_stat),
        avg_stat=None if res._avg_stat is None else float(res._avg_stat))


@pytest.mark.parametrize("image_idx", [0, 1], ids=["frozen", "delta"])
@pytest.mark.parametrize("mode", QS_MODES)
def test_query_step_matches_jax(jax_state, mode, image_idx):
    e = jax_state
    res = e.resident
    jimg = res.images[image_idx]
    mb = res.max_blocks[image_idx]
    qt, qm = _queries(e, seed=11)
    want = jax_query_step(jimg, jnp.asarray(qt), jnp.asarray(qm), k=10,
                          mode=mode, max_blocks=mb,
                          doclens=res._doclens if mode == "bm25" else None,
                          n_stat=res._n_stat, avg_stat=res._avg_stat,
                          decode_fn=decode_blocks_parallel)
    got = query_step(_port_image(jimg), torch.from_numpy(qt),
                     torch.from_numpy(qm), k=10, mode=mode, max_blocks=mb,
                     **_port_kw(e, mode))
    if mode == "conjunctive":
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[0].any()
        return
    gd, gs = (x.numpy() for x in got)
    wd, ws = (np.asarray(x) for x in want)
    assert gd.shape == wd.shape
    if mode == "ranked":
        for row in range(gd.shape[0]):
            assert_ranking(gd[row], gs[row], wd[row], ws[row], 1e-6)
        return
    atol = 4 * np.finfo(np.float32).eps * _row_total(e, image_idx, qt, qm,
                                                     mode)
    for row in range(gd.shape[0]):
        live = np.isfinite(ws[row])
        assert np.array_equal(np.isfinite(gs[row]), live)
        np.testing.assert_allclose(gs[row][live], ws[row][live],
                                   rtol=1e-6, atol=atol[row])
        tol = 1e-6 * np.abs(ws[row][live]) + atol[row]
        s, d, sw, dw = gs[row][live], gd[row][live], ws[row][live], \
            wd[row][live]
        # docids equal wherever the reference's scores are apart by more
        # than the tolerance
        i = 0
        while i < len(sw):
            j = i + 1
            while j < len(sw) and abs(sw[j] - sw[i]) <= 2 * tol[i]:
                j += 1
            if j < len(sw):
                assert set(d[i:j].tolist()) == set(dw[i:j].tolist())
            i = j
        assert np.all(np.diff(s) <= 0)


def test_query_step_takes_a_decode_fn(jax_state):
    """An explicit ``decode_fn`` replaces the default op."""
    e = jax_state
    img = _port_image(e.resident.images[0])
    qt, qm = _queries(e, seed=13)
    calls = []

    def counting(blocks, start, end, F):
        calls.append(blocks.shape)
        return decode_blocks(blocks, start, end, F)

    a = query_step(img, torch.from_numpy(qt), torch.from_numpy(qm),
                   mode="ranked", max_blocks=e.resident.max_blocks[0],
                   decode_fn=counting)
    b = query_step(img, torch.from_numpy(qt), torch.from_numpy(qm),
                   mode="ranked", max_blocks=e.resident.max_blocks[0],
                   decode_fn=ops.as_decode_fn())
    assert len(calls) == 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cpu_tensors_take_the_plain_version(jax_state, monkeypatch):
    """On the CPU the op (and query_step's default decode) never touches the
    kernel wrapper."""
    from repro_torch.kernels.dvbyte_decode import kernel

    def boom(*a, **kw):
        raise AssertionError("kernel wrapper called for CPU tensors")

    monkeypatch.setattr(ops, "dvbyte_decode_kernel", boom)
    before = kernel.launches
    blocks, start, end = _gathered(jax_state, 0)
    got = ops.dvbyte_decode_blocks(blocks, start, end, 4)
    want = decode_blocks(blocks, start, end, 4)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    e = jax_state
    qt, qm = _queries(e, seed=17)
    query_step(_port_image(e.resident.images[1]), torch.from_numpy(qt),
               torch.from_numpy(qm), mode="conjunctive",
               max_blocks=e.resident.max_blocks[1])
    assert kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors(jax_state):
    """A tensor off the card never falls back to the plain version."""
    from repro_torch.kernels.dvbyte_decode.kernel import dvbyte_decode_kernel
    blocks, start, end = _gathered(jax_state, 0)
    with pytest.raises(ValueError, match="CUDA"):
        dvbyte_decode_kernel(blocks, start, end, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("image_idx", [0, 1], ids=["frozen", "delta"])
def test_cuda_kernel_matches_plain_version(jax_state, image_idx):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.dvbyte_decode.kernel import dvbyte_decode_kernel
    blocks, start, end = (x.cuda() for x in _gathered(jax_state, image_idx))
    first = dvbyte_decode_kernel(blocks, start, end, 4)
    second = dvbyte_decode_kernel(blocks, start, end, 4)
    plain = decode_blocks(blocks, start, end, 4)
    for a, b, c in zip(first, second, plain):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), c.cpu())
