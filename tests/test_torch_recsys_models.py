"""The port's recsys models (``repro_torch.models.recsys``: DLRM, SASRec,
DIN and the two-tower functions) against the JAX package's, on the CPU.

Each model runs in two configurations, the second of other, unequal
widths (DLRM with five fields and a narrower top MLP, SASRec with one
block and an ``n_heads`` that both packages ignore, DIN with one-layer
MLPs, a two-tower model whose towers narrow in three layers).  The
reference's parameters (``*_init`` with ``PRNGKey(0)``) are carried into
the port by ``convert.recsys_from_jax``; the batches are made from a numpy
seed and hold the cases the lookups must get right: DLRM ids past a
field's rows (they read the next field's rows) and past the padded table
(they read its last row and send it no gradient), negative ids (counted
from the end), ids past SASRec's, DIN's and the two-tower's tables, a
``seq_mask`` row of zeros, a ``hist_mask`` row of zeros and a non-zero
``logq``.  The reference's functions call its sharding constraint, which
jax 0.9 accepts only on a mesh with Auto axes, so the oracle's mesh is
built with them.

Tolerances, float32 (XLA and PyTorch's CPU kernels sum in other orders):
outputs and losses within rtol ``RTOL`` = 1e-5, atol ``ATOL`` = 1e-6;
each gradient leaf's max |difference| within ``GRAD_TOL`` = 1e-5 of that
leaf's max |g| (measured below 1e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recsys as rec
from repro_torch import convert, tree
from repro_torch.models import recsys as trec
from repro_torch.optim.adamw import global_norm
from repro_torch.sparse.ops import take_rows

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5

#: kind -> (JAX config class, port config class, the two configurations)
CONFIGS = {
    "dlrm": (rec.DLRMConfig, trec.DLRMConfig, [
        dict(table_rows=(50, 30, 7), embed_dim=8, n_dense=13,
             bot_mlp=(16, 8), top_mlp=(32, 16, 1)),
        dict(table_rows=(20, 11, 5, 3, 9), embed_dim=6, n_dense=4,
             bot_mlp=(10, 6), top_mlp=(24, 1))]),
    "sasrec": (rec.SASRecConfig, trec.SASRecConfig, [
        dict(n_items=97, embed_dim=8, n_blocks=2, seq_len=6),
        dict(n_items=40, embed_dim=12, n_blocks=1, n_heads=3, seq_len=5)]),
    "din": (rec.DINConfig, trec.DINConfig, [
        dict(n_items=60, embed_dim=6, seq_len=9, attn_mlp=(16, 8),
             mlp=(20, 10)),
        dict(n_items=33, embed_dim=4, seq_len=5, attn_mlp=(7,), mlp=(9,))]),
    "twotower": (rec.TwoTowerConfig, trec.TwoTowerConfig, [
        dict(n_users_vocab=4096, n_items=1501, embed_dim=32,
             tower_mlp=(64, 32), n_user_feats=4),
        dict(n_users_vocab=300, n_items=77, embed_dim=24,
             tower_mlp=(40, 16, 8), n_user_feats=3)]),
}
CASES = [(kind, i) for kind in CONFIGS for i in (0, 1)]
#: batch sizes of the two configurations
BATCH = (16, 7)

INIT = {"dlrm": rec.dlrm_init, "sasrec": rec.sasrec_init,
        "din": rec.din_init, "twotower": rec.twotower_init}
JLOSS = {"dlrm": rec.dlrm_loss, "sasrec": rec.sasrec_loss,
         "din": rec.din_loss, "twotower": rec.twotower_loss}
TLOSS = {"dlrm": trec.dlrm_loss, "sasrec": trec.sasrec_loss,
         "din": trec.din_loss, "twotower": trec.twotower_loss}


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: one intra-op thread is faster, and the test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(kind: str, i: int):
    """(JAX config, port config) of configuration ``i`` of ``kind``."""
    jcls, tcls, kws = CONFIGS[kind]
    return jcls(**kws[i]), tcls(**kws[i])


@functools.lru_cache(maxsize=None)
def jax_params(kind: str, i: int, seed: int = 0) -> dict:
    """The reference's initial parameters of configuration ``i``, read-only
    numpy leaves (drawn once a module: each draw compiles)."""
    return jax.tree.map(np.asarray, INIT[kind](cfgs(kind, i)[0],
                                               jax.random.PRNGKey(seed)))


def make_batch(kind: str, c, seed: int, B: int, serve: bool = False) -> dict:
    """A numpy batch of ``B`` examples with the edge cases above."""
    rng = np.random.default_rng(seed)
    if kind == "dlrm":
        rows = c.table_rows
        sparse = np.stack([rng.integers(-2, r + 15, B) for r in rows], 1)
        sparse[0, 0] = c.total_rows + 40          # past the padded table
        sparse[1, -1] = c.total_rows              # just past it
        sparse[2, 1] = rows[1]                    # the next field's row
        b = {"dense": rng.lognormal(0.0, 1.0, (B, c.n_dense)),
             "sparse": sparse}
        if not serve:
            b["label"] = rng.random(B) < 0.3
    elif kind == "sasrec":
        S = c.seq_len
        b = {"seq": rng.integers(0, c.n_items + 9, (B, S))}
        b["seq"][0, -1] = c.n_items
        if serve:
            b["cands"] = rng.integers(0, c.n_items + 5, (B, 7))
        else:
            b["pos"] = rng.integers(0, c.n_items + 9, (B, S))
            b["neg"] = rng.integers(0, c.n_items, (B, S))
            b["seq_mask"] = rng.random((B, S)) < 0.8
            b["seq_mask"][1] = False              # a row of zeros
    elif kind == "din":
        b = {"history": rng.integers(0, c.n_items + 7, (B, c.seq_len)),
             "hist_mask": rng.random((B, c.seq_len)) < 0.8,
             "target": rng.integers(0, c.n_items + 7, B)}
        b["hist_mask"][2] = False                 # a row of zeros
        b["target"][0] = c.n_items
        if not serve:
            b["label"] = rng.random(B) < 0.3
    else:
        F = c.n_user_feats
        b = {"user_feats": rng.integers(0, c.n_users_vocab, (B, F)),
             "user_mask": rng.random((B, F)) < 0.8,
             "item": rng.integers(0, c.n_items + 30, B)}
        b["item"][0] = c.n_items
        if not serve:
            b["logq"] = rng.normal(-4.0, 1.5, B)
    return {k: v.astype(np.float32 if v.dtype in (np.float64, bool)
                        else np.int32) for k, v in b.items()}


def jb(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def leaf_err(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want| (0 where both are all zero)."""
    want = np.asarray(want, np.float64)
    diff = float(np.abs(got.detach().double().numpy() - want).max())
    top = float(np.abs(want).max())
    return diff / top if top else (0.0 if diff == 0 else float("inf"))


def grad_capture(store: dict):
    """An optimizer_update for make_train_step that keeps the gradients
    and changes nothing."""
    def update(p, g, s):
        store["grads"] = g
        return p, s, global_norm(g)
    return update


def _forward_pairs(kind):
    """(reference function, port function) pairs of ``kind``'s forward and
    serve outputs: each takes (params, numpy batch, cfg)."""
    if kind == "dlrm":
        return [(rec.dlrm_forward, trec.dlrm_forward)]
    if kind == "din":
        return [(rec.din_forward, trec.din_forward)]
    if kind == "sasrec":
        return [(lambda p, b, c, m: rec.sasrec_hidden(p, b["seq"], c, m),
                 lambda p, b, c: trec.sasrec_hidden(p, b["seq"], c)),
                (rec.sasrec_serve, trec.sasrec_serve)]
    return [(rec.twotower_serve, trec.twotower_serve),
            (rec.user_embedding, trec.user_embedding),
            (lambda p, b, c, m: rec.item_embedding(p, b["item"], c, m),
             lambda p, b, c: trec.item_embedding(p, b["item"], c))]


@pytest.mark.parametrize("kind,i", CASES)
def test_forward_and_serve_match(mesh, kind, i):
    jcfg, tcfg = cfgs(kind, i)
    params = jax_params(kind, i)
    tp = convert.recsys_from_jax(params, device="cpu")
    b = make_batch(kind, tcfg, seed=i, B=BATCH[i], serve=True)
    for jfn, tfn in _forward_pairs(kind):
        with mesh:
            want = jax.jit(lambda p, bb: jfn(p, bb, jcfg, mesh))(params,
                                                                jb(b))
        got = tfn(tp, tb(b), tcfg)
        assert tuple(got.shape) == tuple(want.shape)
        assert torch.isfinite(got).all()
        close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind,i", CASES)
def test_loss_matches(mesh, kind, i, seed):
    jcfg, tcfg = cfgs(kind, i)
    params = jax_params(kind, i, seed)
    b = make_batch(kind, tcfg, seed=10 + seed, B=BATCH[i])
    with mesh:
        want = jax.jit(lambda p, bb: JLOSS[kind](p, bb, jcfg, mesh))(
            params, jb(b))
    got = TLOSS[kind](convert.recsys_from_jax(params, device="cpu"), tb(b),
                      tcfg)
    assert got.dtype == torch.float32 and got.shape == ()
    close(got, want)


@pytest.mark.parametrize("kind,i", CASES)
def test_gradients_match(mesh, kind, i):
    """Each leaf of ``jax.grad`` of the loss against the port's autograd
    through ``make_train_step``; the loss too."""
    jcfg, tcfg = cfgs(kind, i)
    params = jax_params(kind, i)
    b = make_batch(kind, tcfg, seed=20 + i, B=BATCH[i])
    with mesh:
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, bb: JLOSS[kind](p, bb, jcfg, mesh)))(params, jb(b))
    store: dict = {}
    step = trec.make_train_step(lambda p, bb: TLOSS[kind](p, bb, tcfg),
                                grad_capture(store))
    tp = convert.recsys_from_jax(params, device="cpu")
    out = step(tp, None, tb(b))
    assert out[0] is tp
    close(out[2], want_loss)
    got = store["grads"]
    assert tree.treedef_str(tree.flatten(got)[1]) == \
        str(jax.tree.structure(want))
    errs = [leaf_err(g, w) for g, w in zip(tree.leaves(got),
                                           jax.tree.leaves(want))]
    assert max(errs) <= GRAD_TOL, errs


def test_dlrm_lookups_past_a_field_and_past_the_table(mesh):
    """Both packages: an id past a field's rows reads the next field's
    rows; an id past the padded table reads its last row in the forward
    and sends that row no gradient (XLA's gather clamps, its scatter-add
    drops)."""
    jcfg, tcfg = cfgs("dlrm", 0)
    params = jax_params("dlrm", 0)
    last = tcfg.total_rows - 1
    b = make_batch("dlrm", tcfg, seed=3, B=3)
    b["sparse"][:] = 0
    b["sparse"][0, 0] = tcfg.table_rows[0] + 4     # field 1's row 4
    b["sparse"][1, 0] = last + 100                 # past the table
    at_last = {k: v.copy() for k, v in b.items()}
    at_last["sparse"][1, 0] = last
    tp = convert.recsys_from_jax(params, device="cpu")
    close(trec.dlrm_forward(tp, tb(b), tcfg),
          trec.dlrm_forward(tp, tb(at_last), tcfg).detach().numpy())
    with mesh:
        jgrad = np.asarray(jax.jit(jax.grad(
            lambda p, bb: rec.dlrm_loss(p, bb, jcfg, mesh)))(
                params, jb(b))["table"])
    store: dict = {}
    trec.make_train_step(lambda p, bb: trec.dlrm_loss(p, bb, tcfg),
                         grad_capture(store))(tp, None, tb(b))
    tgrad = store["grads"]["table"].numpy()
    offsets = tcfg.offsets
    read = {0, int(offsets[1]) + 4, int(offsets[1]), int(offsets[2])}
    for g in (jgrad, tgrad):
        assert set(np.flatnonzero(np.abs(g).sum(1))) == read
    np.testing.assert_allclose(tgrad, jgrad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_init_follows_the_reference_distributions(kind):
    """The port's ``*_init`` draws the reference's tree (same leaves, same
    shapes) with its distributions, on the device from the generator."""
    jcfg, tcfg = cfgs(kind, 0)
    want = jax_params(kind, 0)
    got = {"dlrm": trec.dlrm_init, "sasrec": trec.sasrec_init,
           "din": trec.din_init, "twotower": trec.twotower_init}[kind](
        tcfg, "cpu", torch.Generator().manual_seed(3))
    assert tree.treedef_str(tree.flatten(got)[1]) == \
        str(jax.tree.structure(want))
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        if not w.std():                 # biases at 0, norms at 1
            assert np.array_equal(g.numpy(), w)
        elif g.numel() > 500:
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.15


@pytest.mark.parametrize("rows,ids", [
    (6, [0, 5, 6, 1000, -1, -6, -13, 5, 5]),
    (9, [[2, 2, 9], [-9, -10, 4]]),
])
def test_take_rows_gradient_matches_a_jax_gather(rows, ids):
    """``take_rows`` forward and backward against ``table[ids]`` in JAX:
    an id counts from the end where negative and is clamped, and one still
    out of range after that sends no gradient (XLA's scatter-add drops
    it); repeated ids add up.  A weight per looked-up element makes every
    row's gradient distinct."""
    rng = np.random.default_rng(rows)
    table = rng.standard_normal((rows, 3)).astype(np.float32)
    ids = np.asarray(ids, np.int32)
    w = rng.standard_normal((*ids.shape, 3)).astype(np.float32)
    want_out = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    want = np.asarray(jax.grad(
        lambda t: (t[jnp.asarray(ids)] * w).sum())(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = take_rows(t, torch.from_numpy(ids))
    (out * torch.from_numpy(w)).sum().backward()
    assert np.array_equal(out.detach().numpy(), want_out)
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("i", [0, 1])
def test_twotower_modules_compute_the_tower_functions(i):
    """``TwoTower``'s towers are ``nn.Sequential``s of ``nn.Linear`` and
    ``nn.ReLU``: called as modules they give what ``_mlp_apply`` gives over
    the ``params()`` view that serving goes through."""
    _, tcfg = cfgs("twotower", i)
    model = trec.TwoTower(tcfg, device="cpu",
                          params=convert.recsys_from_jax(
                              jax_params("twotower", i), device="cpu"))
    x = torch.from_numpy(np.random.default_rng(i).standard_normal(
        (5, tcfg.embed_dim)).astype(np.float32))
    view = model.params()
    with torch.no_grad():
        for tower in ("user_tower", "item_tower"):
            close(getattr(model, tower)(x), trec._mlp_apply(view[tower], x))
