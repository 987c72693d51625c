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

* ``kernel_mirror``: the CUDA kernel's arithmetic (a half-warp per
  block, four positions a lane: ballot masks, half-warp scans, ranks, the
  run-length-parity rule, the one shuffle of each patch), mirrored in
  numpy, equals the port's ``decode_blocks`` and the Pallas kernel in
  interpret mode on every position, and the JAX ``decode_blocks`` on its
  valid positions, on constructed rows (those of
  ``test_torch_gpu_term_kernels.py``) and on JAX-built chain blocks.

The CUDA kernel is held against the plain version by the ``gpu`` tests,
which run only where there is a card.
"""

import jax
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
from test_torch_gpu_term_kernels import ANY_BYTES, constructed_rows

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


# --------------------------------------------------------------------------
# the CUDA kernel's arithmetic, mirrored in numpy
# --------------------------------------------------------------------------

_U64 = np.uint64
_INT_MIN = np.iinfo(np.int32).min
#: lane l of a warp: block 2w + l // 16, positions 4 (l % 16) + k
_J = np.arange(32) & 15
_POS = _J[:, None] * 4 + np.arange(4)[None, :]


def _spread4(x):
    """Bit i of the low 16 bits of x to bit 4i, as the kernel's spread4."""
    v = x & _U64(0xFFFF)
    for s, m in ((24, 0x000000FF000000FF), (12, 0x000F000F000F000F),
                 (6, 0x0303030303030303), (3, 0x1111111111111111)):
        v = (v | (v << _U64(s))) & _U64(m)
    return v


def _row_mask(pred):
    """(W, 32, 4) bool -> (W, 32) uint64: each lane's 64-bit mask of its
    block, from four warp ballots (the kernel's row_mask)."""
    out = np.zeros(pred.shape[:2], np.uint64)
    shift = (np.arange(32) & 16).astype(np.uint64)
    for k in range(4):
        ballot = (pred[:, :, k].astype(np.uint64)
                  << np.arange(32, dtype=np.uint64)).sum(axis=1)
        out |= _spread4(ballot[:, None] >> shift[None, :]) << _U64(k)
    return out


def _below(p):
    return (np.left_shift(_U64(1), np.asarray(p).astype(np.uint64))
            - _U64(1)).astype(np.uint64)


def _bit(p):
    return np.left_shift(_U64(1), np.asarray(p).astype(np.uint64))


def _highest(m):
    """Index of the highest set bit (63 - clz); -1 for 0."""
    m = m.astype(np.uint64)
    h = np.zeros(m.shape, np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        t = m >> _U64(s)
        hit = t != 0
        h += s * hit
        m = np.where(hit, t, m)
    return np.where(m != 0, h, -1)


def _shfl_up(x, d):
    """__shfl_up_sync(x, d, 16): lanes below d keep their own value."""
    y = x.copy()
    src = np.arange(32) - d
    take = _J >= d
    y[:, take] = x[:, src[take]]
    return y


def kernel_mirror(blocks, start, end, F):
    """``csrc/dvbyte_decode.cu`` step by step in numpy: a half-warp per
    block, four positions a lane, ballot masks, half-warp scans, ranks,
    the run-parity rule and the one shuffle of each patch.  Returns (g, f,
    valid) as the kernel stores them."""
    blocks = np.asarray(blocks, np.uint8)
    NB, B = blocks.shape
    W = (NB + 1) // 2
    st = np.zeros(2 * W, np.int64)
    en = np.zeros(2 * W, np.int64)
    st[:NB] = np.maximum(0, np.asarray(start, np.int64))
    en[:NB] = np.minimum(B, np.asarray(end, np.int64))
    busy = en > st
    by = np.zeros((2 * W, 64), np.uint32)
    by[:NB, :B] = blocks
    by[~busy] = 0                        # an empty block is never read
    b = by.reshape(W, 32, 4)
    lst = np.repeat(st.reshape(W, 2), 16, axis=1)[:, :, None]
    len_ = np.repeat(en.reshape(W, 2), 16, axis=1)[:, :, None]
    P = np.broadcast_to(_POS, b.shape)
    inside = (P >= lst) & (P < len_)
    term = inside & ((b & 0x80) == 0)
    T = _row_mask(term)
    bt = T[:, :, None] & _below(P)
    code_start = np.maximum(np.where(bt != 0, _highest(bt) + 1, 0), lst)
    place = np.clip(P - code_start, 0, 4).astype(np.uint64)
    pay = np.where(inside, ((b & 0x7F).astype(np.uint64) << (_U64(7) * place))
                   & _U64(0xFFFFFFFF), 0).astype(np.uint32)
    csum = np.cumsum(pay, axis=2, dtype=np.uint32)
    run = csum[:, :, 3].copy()
    incl = run.copy()
    for d in (1, 2, 4, 8):
        incl = np.where(_J >= d, incl + _shfl_up(incl, d), incl)
    csum = csum + (incl - run)[:, :, None]
    ci = csum.view(np.int32).astype(np.int64)
    imax = np.where(term, ci, _INT_MIN).max(axis=2)
    for d in (1, 2, 4, 8):
        imax = np.where(_J >= d, np.maximum(imax, _shfl_up(imax, d)), imax)
    carry = np.where(_J == 0, _INT_MIN, _shfl_up(imax, 1))
    value = np.zeros(b.shape, np.int64)
    for k in range(4):
        prev = np.maximum(carry, 0).astype(np.uint32)
        value[:, :, k] = np.where(
            term[:, :, k],
            (csum[:, :, k] - prev).view(np.int32).astype(np.int64), 0)
        carry = np.where(term[:, :, k], np.maximum(carry, ci[:, :, k]), carry)
    isv = term & (value > 0)
    mod = np.where(isv, value % F, 0)
    V = _row_mask(isv)[:, :, None]
    E = _row_mask(isv & (mod != 0))[:, :, None]
    rank = np.bitwise_count(V & (_below(P) | _bit(P))).astype(np.int64)
    eb = E & _below(P)
    h = np.maximum(_highest(eb), 0)
    last_ne = np.where(eb != 0, np.bitwise_count(V & (_below(h) | _bit(h))),
                       0).astype(np.int64)
    consumed = isv & (((rank - 1 - last_ne) & 1) == 1)
    prim = isv & ~consumed
    g = np.where(prim, np.where(mod > 0, 1 + value // F, value // F), 0)
    f = np.where(prim & (mod > 0), mod, 0)
    fpatch = np.where(consumed, (F + value - 1).astype(np.uint32).view(
        np.int32), 0).astype(np.int64)
    pos = fpatch > 0
    Pm = _row_mask(pos)
    first = np.zeros(Pm.shape, np.int64)
    for k in (3, 2, 1, 0):
        first = np.where(pos[:, :, k], fpatch[:, :, k], first)
    after = np.where(_J == 15, _U64(0),
                     Pm & ~_below(np.minimum(_J * 4 + 4, 63)))
    low = _highest(after & (~after + _U64(1)))
    src = np.where(after != 0, low // 4, _J)
    held = np.take_along_axis(first, (np.arange(32) & 16) + src, axis=1)
    held = np.where(after != 0, held, 0)
    for k in (3, 2, 1, 0):
        held = np.where(pos[:, :, k], fpatch[:, :, k], held)
        f[:, :, k] = np.where(prim[:, :, k] & (f[:, :, k] == 0), held,
                              f[:, :, k])

    def rows(x):
        return x.reshape(2 * W, 64)[:NB, :B]
    return (rows(g).astype(np.int32), rows(f).astype(np.int32), rows(prim))


_jax_decode_jit = jax.jit(jax_decode_blocks, static_argnums=3)
MIRROR_ROWS = 64     # every case is padded to this many blocks (one shape
                     # for each JAX function to compile)


def _jax_ref_and_pallas(blocks, start, end):
    """The JAX decode_blocks and the Pallas kernel in interpret mode, on the
    blocks padded with empty ones to a multiple of ``MIRROR_ROWS``."""
    n = len(blocks)
    pad = -n % MIRROR_ROWS
    args = (jnp.asarray(np.pad(blocks, ((0, pad), (0, 0)))),
            jnp.asarray(np.pad(start, (0, pad))),
            jnp.asarray(np.pad(end, (0, pad))))
    ref = tuple(np.asarray(x)[:n] for x in _jax_decode_jit(*args, 4))
    pallas = tuple(np.asarray(x)[:n] for x in jax_dvbyte_decode_blocks(
        *args, F=4, tile=64, interpret=True))
    return ref, pallas


def _assert_mirror_matches(blocks, start, end, with_ref=True):
    """The mirror equals the port's plain version and the Pallas kernel on
    every position, and the JAX decode_blocks on its valid positions (it
    leaves values at consumed positions)."""
    mg, mf, mv = kernel_mirror(blocks, start, end, 4)
    pg, pf, pv = (x.numpy() for x in decode_blocks(
        torch.from_numpy(blocks), torch.from_numpy(start),
        torch.from_numpy(end), 4))
    assert np.array_equal(mv, pv)
    assert np.array_equal(mg, pg) and np.array_equal(mf, pf)
    (jg, jf, jv), pallas = _jax_ref_and_pallas(blocks, start, end)
    for m, p in zip((mg, mf, mv), pallas):
        assert np.array_equal(m, p)
    if with_ref:
        assert np.array_equal(mv, jv)
        assert np.array_equal(mg * mv, jg * jv)
        assert np.array_equal(mf * mv, jf * jv)
    return mv


@pytest.mark.parametrize("case", list(constructed_rows()))
def test_kernel_mirror_on_constructed_rows(case):
    blocks, start, end = constructed_rows()[case]
    valid = _assert_mirror_matches(blocks, start, end,
                                   with_ref=case not in ANY_BYTES)
    if case in ("end <= start", "no terminator", "all zero"):
        assert not valid.any()
    else:
        assert valid.any()


@pytest.mark.parametrize("width", [7, 33])
def test_kernel_mirror_on_narrow_blocks(width):
    rows = [x for k, x in constructed_rows(width=width).items()
            if k not in ANY_BYTES]
    blocks, start, end = (np.concatenate(x) for x in zip(*rows))
    _assert_mirror_matches(blocks, start, end)


@pytest.mark.parametrize("image_idx", [0, 1], ids=["frozen", "delta"])
def test_kernel_mirror_on_chain_blocks(jax_state, image_idx):
    """JAX-built chain blocks, an odd count (the last warp's second half
    holds no block)."""
    blocks, start, end = (x.numpy() for x in _gathered(jax_state, image_idx,
                                                        seed=7))
    n = min(len(blocks), 255)
    valid = _assert_mirror_matches(blocks[:n], start[:n], end[:n])
    assert valid.any()


def test_kernel_mirror_single_block():
    blocks, start, end = constructed_rows()["escape runs of odd length"]
    _assert_mirror_matches(blocks[:1], start[:1], end[:1])
