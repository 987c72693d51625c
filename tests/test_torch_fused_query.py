"""The port's fused query op against the JAX package's, on the same images.

A JAX engine with a mid-stream freeze, a delta and deletes builds the
resident (frozen, delta) images; ``repro_torch.convert.image_from_arrays``
carries their fields across, so both packages' ``fused_query`` see the same
images and the same query batch.  The JAX side runs its plain reference
(``flavor="ref"``), the port its plain PyTorch version on the CPU.

Conjunctive bitmaps must be equal; ranked answers must hold the same docids
up to swaps among near-equal scores, with scores within rtol 1e-6 (XLA's and
PyTorch's ``log1p`` and division may differ by one ulp).  The packing and
the block decode must match exactly, the idf weights to rtol 1e-6.  The CUDA kernel itself is held against
the plain version by the ``gpu`` test, which runs only where there is a
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import Engine as JaxEngine
from repro.kernels.fused_query import ops as jax_ops
from repro.kernels.fused_query import ref as jax_ref
from repro_torch.convert import image_from_arrays
from repro_torch.core.device_index import decode_blocks
from repro_torch.kernels.fused_query import ops as port_ops
from repro_torch.kernels.fused_query import ref as port_ref

MODES = ("conjunctive", "ranked_tfidf", "bm25")
FIELDS = ("blocks", "term_slot", "term_nblk", "term_skip", "term_nx",
          "term_ft", "term_lastd0", "term_dnum0")


def _pow2(n, floor=1):
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


@pytest.fixture(scope="module")
def jax_state():
    """160 docs frozen, 90 in the delta, 12 deletes across both images."""
    rng = np.random.default_rng(31)
    vocab = [f"w{i}" for i in range(80)]
    probs = 1.0 / np.arange(1, 81) ** 1.07
    probs /= probs.sum()
    docs = [[vocab[i] for i in rng.choice(80, size=int(rng.integers(3, 30)),
                                          p=probs)] for _ in range(250)]
    e = JaxEngine(B=64, growth="const")
    for d in docs[:160]:
        e.add_document(d)
    e.collate_now()
    for d in docs[160:]:
        e.add_document(d)
    for victim in rng.choice(np.arange(1, 251), size=12, replace=False):
        e.delete_document(int(victim))
    e.resident.refresh()
    return e


def _queries(e, seed, n=8, T=4):
    rng = np.random.default_rng(seed)
    qt = np.zeros((n, T), np.int32)
    qm = np.zeros((n, T), bool)
    for row in range(n):
        nt = int(rng.integers(1, T + 1))
        ids = rng.choice(min(60, len(e.vocab)), size=nt, replace=False)
        qt[row, :nt] = ids
        qm[row, :nt] = True
    return qt, qm


def _port_image(img, device="cpu"):
    arrays = {f: np.asarray(getattr(img, f)) for f in FIELDS
              if hasattr(img, f)}
    return image_from_arrays(arrays, num_docs=img.num_docs, F=img.F,
                             device=device)


def _caps(images, qt, qm):
    caps = []
    for img in images:
        nblk = np.asarray(img.term_nblk)
        tot = (nblk[qt] * qm).sum(axis=1).max()
        caps.append(_pow2(int(tot), floor=8))
    return tuple(caps)


def _kw(e, mode, with_alive):
    res = e.resident
    alive = res._alive if with_alive else None
    jax_kw = dict(doclens=res._doclens if mode == "bm25" else None,
                  n_stat=res._n_stat, avg_stat=res._avg_stat, alive=alive)
    port_kw = dict(
        doclens=(torch.from_numpy(np.array(res._doclens))
                 if mode == "bm25" else None),
        n_stat=int(res._n_stat),
        avg_stat=None if res._avg_stat is None else float(res._avg_stat),
        alive=(None if alive is None else torch.from_numpy(
            np.asarray(alive).view(np.int32).copy())))
    return jax_kw, port_kw


def assert_ranking(d_got, s_got, d_ref, s_ref, rtol):
    """Same docids up to swaps among scores equal to ``rtol``; scores
    within ``rtol`` (the last run may straddle the top-k cut)."""
    assert len(d_got) == len(d_ref)
    np.testing.assert_allclose(s_got, s_ref, rtol=rtol, atol=0)
    i, n = 0, len(d_ref)
    while i < n:
        j = i + 1
        while j < n and abs(s_ref[j] - s_ref[i]) <= rtol * abs(s_ref[i]):
            j += 1
        if j < n:
            assert set(d_got[i:j].tolist()) == set(d_ref[i:j].tolist())
        i = j


def _assert_same(mode, got, ref, rtol=1e-6):
    if mode == "conjunctive":
        assert np.array_equal(np.asarray(got), np.asarray(ref))
        return
    gd, gs = (np.asarray(x) for x in got)
    rd, rs = (np.asarray(x) for x in ref)
    assert gd.shape == rd.shape
    for row in range(gd.shape[0]):
        assert_ranking(gd[row], gs[row], rd[row], rs[row], rtol)


@pytest.mark.parametrize("with_alive", [False, True],
                         ids=["no-mask", "alive-mask"])
@pytest.mark.parametrize("parts", ["frozen+delta", "delta-only"])
@pytest.mark.parametrize("mode", MODES)
def test_port_matches_jax_fused_query(jax_state, mode, parts, with_alive):
    e = jax_state
    images = e.resident.images
    if parts == "delta-only":
        images = images[1:]
    qt, qm = _queries(e, seed=3)
    caps = _caps(images, qt, qm)
    jax_kw, port_kw = _kw(e, mode, with_alive)
    want = jax_ops.fused_query(images, jnp.asarray(qt), jnp.asarray(qm),
                               mode=mode, k=10, max_blocks=caps,
                               flavor="ref", **jax_kw)
    got = port_ops.fused_query(tuple(_port_image(i) for i in images),
                               torch.from_numpy(qt), torch.from_numpy(qm),
                               mode=mode, k=10, max_blocks=caps, **port_kw)
    if mode == "conjunctive":
        got = got.numpy()
    else:
        got = tuple(x.numpy() for x in got)
    _assert_same(mode, got, want)


@pytest.mark.parametrize("mode", MODES)
def test_packing_and_decode_match_jax_exactly(jax_state, mode):
    e = jax_state
    qt, qm = _queries(e, seed=5)
    for img in e.resident.images:
        cap = _caps((img,), qt, qm)[0]
        Ns = jnp.float32(e.resident._n_stat)
        want = jax_ops._prep_image(img, jnp.asarray(qt), jnp.asarray(qm), Ns,
                                   cap, mode)
        got = port_ops._prep_image(
            _port_image(img), torch.from_numpy(qt), torch.from_numpy(qm),
            torch.tensor(float(e.resident._n_stat)), cap, mode)
        for w, g in zip(want[:6], got[:6]):
            assert np.array_equal(np.asarray(w), g.numpy())
        # idf weights go through log1p: one ulp between XLA and PyTorch
        np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]),
                                   rtol=1e-6, atol=0)
        gat, start, end = (np.asarray(x) for x in want[:3])
        B = gat.shape[-1]
        jg = jax_ref.decode_blocks_parallel(
            jnp.asarray(gat.reshape(-1, B)), jnp.asarray(start.reshape(-1)),
            jnp.asarray(end.reshape(-1)), img.F)
        pg = decode_blocks(
            torch.from_numpy(gat.reshape(-1, B)),
            torch.from_numpy(start.reshape(-1)),
            torch.from_numpy(end.reshape(-1)), img.F)
        for w, g in zip(jg, pg):
            assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("mode", MODES)
def test_batch_equals_singletons(jax_state, mode):
    e = jax_state
    images = tuple(_port_image(i) for i in e.resident.images)
    qt, qm = _queries(e, seed=7)
    caps = _caps(e.resident.images, qt, qm)
    _, kw = _kw(e, mode, True)
    batch = port_ops.fused_query(images, torch.from_numpy(qt),
                                 torch.from_numpy(qm), mode=mode, k=10,
                                 max_blocks=caps, **kw)
    for row in range(qt.shape[0]):
        one = port_ops.fused_query(images, torch.from_numpy(qt[row:row + 1]),
                                   torch.from_numpy(qm[row:row + 1]),
                                   mode=mode, k=10, max_blocks=caps, **kw)
        if mode == "conjunctive":
            assert torch.equal(batch[row], one[0])
        else:
            assert torch.equal(batch[0][row], one[0][0])
            assert torch.equal(batch[1][row].view(torch.int32),
                               one[1][0].view(torch.int32))


def test_cpu_tensors_take_the_plain_version(jax_state, monkeypatch):
    """On the CPU the op never touches the kernel wrapper."""
    from repro_torch.kernels.fused_query import kernel

    def boom(*a, **kw):
        raise AssertionError("kernel wrapper called for CPU tensors")

    monkeypatch.setattr(port_ops, "fused_query_kernel", boom)
    e = jax_state
    qt, qm = _queries(e, seed=9)
    before = kernel.launches
    port_ops.fused_query(tuple(_port_image(i) for i in e.resident.images),
                         torch.from_numpy(qt), torch.from_numpy(qm),
                         mode="ranked_tfidf", k=10,
                         max_blocks=_caps(e.resident.images, qt, qm))
    assert kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors(jax_state):
    """A tensor off the card never falls back to the plain version."""
    from repro_torch.kernels.fused_query.kernel import fused_query_kernel
    e = jax_state
    qt, qm = _queries(e, seed=9)
    images = tuple(_port_image(i) for i in e.resident.images)
    args = port_ops.prepare(images, torch.from_numpy(qt),
                            torch.from_numpy(qm), mode="conjunctive",
                            max_blocks=_caps(e.resident.images, qt, qm))
    with pytest.raises(ValueError, match="CUDA"):
        fused_query_kernel(mode="conjunctive", k=10, **args)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_cuda_kernel_matches_plain_version(jax_state, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.fused_query.kernel import fused_query_kernel
    e = jax_state
    images = tuple(_port_image(i, "cuda") for i in e.resident.images)
    qt, qm = _queries(e, seed=11)
    _, kw = _kw(e, mode, True)
    kw = {k: (v.cuda() if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    args = port_ops.prepare(images, torch.from_numpy(qt),
                            torch.from_numpy(qm), mode=mode,
                            max_blocks=_caps(e.resident.images, qt, qm), **kw)
    first = fused_query_kernel(mode=mode, k=10, **args)
    second = fused_query_kernel(mode=mode, k=10, **args)
    plain = port_ref.fused_tile(mode=mode, k=10, **args)
    if mode == "conjunctive":
        assert torch.equal(first, second)
        assert torch.equal(first.cpu(), plain.cpu())
    else:
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(first, second))
        # both select in (score desc, docid asc) order: docids equal
        assert torch.equal(first[0].cpu(), plain[0].cpu())
        np.testing.assert_allclose(first[1].cpu().numpy(),
                                   plain[1].cpu().numpy(), rtol=1e-6, atol=0)
