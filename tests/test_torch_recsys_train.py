"""The port's recsys training path against the JAX package's, on the CPU:
``make_train_step`` with AdamW, ``launch.train.train_recsys``,
``convert.recsys_from_jax``/``adamw_from_jax``, ``data/recsys.py`` and
``configs.common.RecsysArch``.

The models, configurations and batches are
``tests/test_torch_recsys_models.py``'s.  A training step is held against
the reference's ``jax.jit(make_train_step(loss, adamw_update))`` along
its trajectory: the reference takes the first step, its parameters and
AdamW state are carried across, and both take the second step from them
(the loss and the gradient norm within rtol ``RTOL``; every updated
parameter and moment within ``OPT_TOL`` = 1e-5 of that leaf's max
|value|, measured below 2e-6).  ``train_recsys``'s first step from the
reference's initial parameters is held to the same tolerance: at step 1
AdamW's m̂/√v̂ is ±1 per element, so an element whose gradient is near 0
could flip its sign between two correct implementations, which these
models' gradients (exact zeros or well away from 0) do not show.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_arch as jax_get_arch
from repro.configs.common import REC_SHAPES as JAX_REC_SHAPES
from repro.data.recsys import RecsysBatches as JaxBatches
from repro.models import recsys as rec
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import convert, tree
from repro_torch.configs import get_arch
from repro_torch.configs.common import REC_SHAPES, RecsysArch
from repro_torch.data.recsys import ModelBatches, RecsysBatches
from repro_torch.launch.train import train_recsys
from repro_torch.models import recsys as trec
from repro_torch.optim import adamw_init, adamw_update
from test_torch_recsys_models import (BATCH, CASES, CONFIGS, JLOSS,  # noqa
                                      RTOL, TLOSS, _one_torch_thread, cfgs,
                                      jax_params, jb, leaf_err, make_batch,
                                      mesh, tb)

OPT_TOL = 1e-5
LR = 1e-3
RECSYS_IDS = ["dlrm-mlperf", "sasrec", "din", "two-tower-retrieval"]


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _jax_step(kind, jcfg, mesh):
    loss = lambda p, b: JLOSS[kind](p, b, jcfg, mesh)  # noqa: E731
    return jax.jit(rec.make_train_step(
        loss, lambda p, g, s: jadamw_update(p, g, s, LR)))


def _assert_trees_close(got, want) -> None:
    assert tree.treedef_str(tree.flatten(got)[1]) == \
        str(jax.tree.structure(want))
    errs = [leaf_err(g, w) for g, w in zip(tree.leaves(got),
                                           jax.tree.leaves(want))]
    assert max(errs) <= OPT_TOL, errs


@pytest.mark.parametrize("kind,i", CASES)
def test_train_step_matches_the_reference(mesh, kind, i):
    """The second AdamW step from the reference's first, carried across:
    loss, gradient norm, parameters and moments; the update is in place."""
    jcfg, tcfg = cfgs(kind, i)
    jstep = _jax_step(kind, jcfg, mesh)
    b0, b1 = (make_batch(kind, tcfg, seed=30 + s, B=BATCH[i])
              for s in (0, 1))
    params = jax_params(kind, i)
    with mesh:
        p1, o1, _, _ = jstep(params, jadamw_init(params), jb(b0))
        p1, o1 = jax.tree.map(np.asarray, (p1, o1))
        p2, o2, jloss, jnorm = jstep(p1, o1, jb(b1))
    tp = convert.recsys_from_jax(p1, device="cpu")
    to = convert.adamw_from_jax(o1, device="cpu")
    tstep = trec.make_train_step(lambda p, b: TLOSS[kind](p, b, tcfg),
                                 lambda p, g, s: adamw_update(p, g, s, LR))
    out = tstep(tp, to, tb(b1))
    assert out[0] is tp and out[1] is to
    assert _rel(out[2], jloss) <= RTOL and _rel(out[3], jnorm) <= RTOL
    assert int(to.step) == int(o2.step) == 2
    _assert_trees_close((tp, to.mu, to.nu), (p2, o2.mu, o2.nu))


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_non_finite_loss_leaves_everything_untouched(kind):
    """A NaN in the batch makes the loss NaN: the step returns the
    parameters, moments and step counter as they were, and the gradient's
    global norm."""
    _, tcfg = cfgs(kind, 0)
    params = convert.recsys_from_jax(jax_params(kind, 0), device="cpu")
    opt = adamw_init(params)
    b = make_batch(kind, tcfg, seed=5, B=BATCH[0])
    nan_key = {"dlrm": "dense", "sasrec": "seq_mask", "din": "hist_mask",
               "twotower": "logq"}[kind]
    b[nan_key].flat[0] = np.nan
    before = [t.clone() for t in tree.leaves((params, opt))]
    step = trec.make_train_step(lambda p, bb: TLOSS[kind](p, bb, tcfg),
                                lambda p, g, s: adamw_update(p, g, s, LR))
    p, o, loss, gnorm = step(params, opt, tb(b))
    assert p is params and o is opt
    assert not torch.isfinite(loss) and gnorm.shape == ()
    assert all(torch.equal(a, c) for a, c in
               zip(tree.leaves((params, opt)), before))
    assert int(opt.step) == 0


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_train_recsys_matches_the_reference_step(monkeypatch, mesh, kind):
    """One ``train_recsys`` step (the Trainer, AdamW at 1e-3 from fresh
    moments) from the reference's initial parameters, against the
    reference's jitted step from the same parameters and batch."""
    jcfg, tcfg = cfgs(kind, 1)
    params = jax_params(kind, 1)
    monkeypatch.setattr(RecsysArch, "init", lambda self, device, gen:
                        convert.recsys_from_jax(params, device))
    b = make_batch(kind, tcfg, seed=40, B=BATCH[1])

    class Data:
        def batch_at(self, step):
            return b

    lines: list = []
    out = train_recsys(tcfg, kind, 1, batch=BATCH[1], device="cpu",
                       data=Data(), log_fn=lines.append)
    trainer = out["trainer"]
    with mesh:
        p1, o1, jloss, jnorm = _jax_step(kind, jcfg, mesh)(
            params, jadamw_init(params), jb(b))
    m = trainer.metrics[0]
    assert _rel(m["loss"], jloss) <= RTOL and _rel(m["gnorm"], jnorm) <= RTOL
    _assert_trees_close((trainer.params, trainer.opt_state.mu,
                         trainer.opt_state.nu), (p1, o1.mu, o1.nu))
    assert out["line"].startswith(f"[train] {tcfg.name}: loss ")
    assert lines and lines[0].startswith("[trainer] step 0 loss")


def test_train_recsys_takes_an_arch_and_defaults_to_the_card(monkeypatch):
    arch = RecsysArch("tiny-din", cfgs("din", 1)[1], "din")
    out = train_recsys(arch, None, 3, batch=8, device="cpu", log_every=0)
    losses = [x["loss"] for x in out["trainer"].metrics]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert int(out["trainer"].opt_state.step) == 3
    with pytest.raises(ValueError, match="kind"):
        train_recsys(arch, "dlrm", 1, batch=8, device="cpu")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_recsys(arch, None, 1, batch=8)


# --------------------------------------------------------------------------
# converting the reference's trees
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_adamw_from_jax_carries_a_recsys_state(mesh, kind):
    """The reference's AdamW state of a recsys tree (lists of dicts) after
    one step, carried across leaf by leaf, bit for bit, in its tree."""
    jcfg, tcfg = cfgs(kind, 0)
    params = jax_params(kind, 0)
    with mesh:
        _, o1, _, _ = _jax_step(kind, jcfg, mesh)(
            params, jadamw_init(params), jb(make_batch(kind, tcfg, 7, 16)))
    o1 = jax.tree.map(np.asarray, o1)
    got = convert.adamw_from_jax(o1, device="cpu")
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    for mine, theirs in ((got.mu, o1.mu), (got.nu, o1.nu)):
        assert tree.treedef_str(tree.flatten(mine)[1]) == \
            str(jax.tree.structure(theirs))
        for t, j in zip(tree.leaves(mine), jax.tree.leaves(theirs)):
            assert t.dtype == torch.float32
            assert np.array_equal(t.numpy(), j)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_recsys_from_jax_keeps_the_tree(kind):
    params = jax_params(kind, 1)
    got = convert.recsys_from_jax(params, device="cpu")
    assert tree.treedef_str(tree.flatten(got)[1]) == \
        str(jax.tree.structure(params))
    assert all(np.array_equal(t.numpy(), j) for t, j in
               zip(tree.leaves(got), jax.tree.leaves(params)))
    if kind != "sasrec":
        assert isinstance(got[{"dlrm": "top", "din": "mlp",
                               "twotower": "user_tower"}[kind]], list)


# --------------------------------------------------------------------------
# data and configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 2)])
@pytest.mark.parametrize("hist_len,rows", [(0, None), (5, (300, 20, 7))])
def test_recsys_batches_match_the_reference(seed, step, hist_len, rows):
    got = RecsysBatches(12, table_rows=rows, seed=seed,
                        hist_len=hist_len).batch_at(step)
    want = JaxBatches(12, table_rows=rows, seed=seed,
                      hist_len=hist_len).batch_at(step)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_model_batches_fit_the_batch_specs(arch_id):
    """``ModelBatches`` gives each model the keys, shapes and dtypes of its
    train batch, ids inside its tables, and the same arrays again at the
    same step."""
    arch = get_arch(arch_id)
    data = ModelBatches(arch.kind, arch.cfg, 32, seed=1)
    b = data.batch_at(3)
    specs = arch._batch_specs(32)
    assert b.keys() == specs.keys()
    for k, v in b.items():
        assert v.shape == tuple(specs[k].shape), k
        assert str(specs[k].dtype) == f"torch.{v.dtype}", k
    assert all(np.array_equal(v, data.batch_at(3)[k]) for k, v in b.items())
    if arch.kind == "twotower":
        assert (b["logq"] < 0).any() and (b["logq"] <= 0).all()
        assert b["item"].max() < arch.cfg.n_items
    if arch.kind in ("sasrec", "din"):
        ids = b["seq"] if arch.kind == "sasrec" else b["history"]
        assert ids.max() < arch.cfg.n_items


@pytest.mark.parametrize("shape_id", list(JAX_REC_SHAPES))
@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_recsys_flops_match_the_reference(arch_id, shape_id):
    assert REC_SHAPES == JAX_REC_SHAPES
    assert get_arch(arch_id).flops(shape_id) == \
        jax_get_arch(arch_id).flops(shape_id)


@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_batch_specs_match_the_reference(arch_id, serve):
    got = get_arch(arch_id)._batch_specs(512, serve=serve)
    want = jax_get_arch(arch_id)._batch_specs(512, serve=serve)
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype) == f"torch.{jnp.dtype(want[k].dtype).name}", k


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_arch_loss_and_serve_are_the_models(mesh, arch_id):
    """``RecsysArch.loss_and_serve`` and ``init`` at a small width of the
    arch's kind: the loss and serve outputs are the reference arch's own
    functions' on the same parameters."""
    kind = get_arch(arch_id).kind
    jcfg, tcfg = cfgs(kind, 0)
    tarch = RecsysArch(arch_id, tcfg, kind)
    jarch = type(jax_get_arch(arch_id))(arch_id, jcfg, kind)
    params = jax_params(kind, 0)
    tp = convert.recsys_from_jax(params, device="cpu")
    drawn = tarch.init("cpu", torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree.leaves(drawn)] == \
        [t.shape for t in jax.tree.leaves(params)]
    tloss, tserve = tarch.loss_and_serve()
    for serve, fn in ((False, tloss), (True, tserve)):
        b = make_batch(kind, tcfg, seed=50, B=BATCH[0], serve=serve)
        with mesh:
            want = jax.jit(jarch._loss_and_serve(mesh)[serve])(params, jb(b))
        np.testing.assert_allclose(fn(tp, tb(b)).detach().numpy(),
                                   np.asarray(want), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("shape_id", list(JAX_REC_SHAPES))
@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_recsys_flops_at_another_batch(monkeypatch, arch_id, shape_id):
    """``flops(shape_id, batch=B)`` is the reference's ``flops`` of a shape
    whose batch is ``B`` (the two-tower's (B, B) logits included)."""
    monkeypatch.setitem(JAX_REC_SHAPES, shape_id,
                        {**JAX_REC_SHAPES[shape_id], "batch": 3_000})
    assert get_arch(arch_id).flops(shape_id, batch=3_000) == \
        jax_get_arch(arch_id).flops(shape_id)


def _uniform_chi2(ids: np.ndarray, n: int) -> float:
    """Pearson's chi-square of ``ids`` against a uniform draw over
    ``n``: about ``n - 1`` (sd √(2(n - 1))) when uniform."""
    counts = np.bincount(ids.ravel(), minlength=n)
    expect = ids.size / n
    return float(((counts - expect) ** 2 / expect).sum())


@pytest.mark.parametrize("kind", ["dlrm", "din", "sasrec", "twotower"])
def test_model_batches_draw_from_their_sources(kind):
    """Each model's ids come from where ``ModelBatches`` says: the
    reference's ``RecsysBatches`` arrays bit for bit where it draws them
    (DLRM's whole batch, DIN's, SASRec's history, the two-tower's user
    features), and SASRec's negatives and the two-tower's items uniform
    over the items (chi-square within 6 sd of uniform; a Zipf(1.2) draw
    is thousands of sd away)."""
    n, B, seed, step = 500, 4_000, 2, 5
    cfg = {"dlrm": trec.DLRMConfig(table_rows=(n, 30, 7)),
           "din": trec.DINConfig(n_items=n, seq_len=12),
           "sasrec": trec.SASRecConfig(n_items=n, seq_len=12),
           "twotower": trec.TwoTowerConfig(n_users_vocab=300, n_items=n,
                                           n_user_feats=3)}[kind]
    b = ModelBatches(kind, cfg, B, seed=seed).batch_at(step)
    if kind == "dlrm":
        ref = JaxBatches(B, cfg.table_rows, cfg.n_dense, seed).batch_at(step)
        drawn = {k: ref[k] for k in b}
    elif kind == "din":
        ref = JaxBatches(B, [n], seed=seed,
                         hist_len=cfg.seq_len).batch_at(step)
        drawn = {k: ref[k] for k in b}
    elif kind == "sasrec":
        h = JaxBatches(B, [n], seed=seed,
                       hist_len=cfg.seq_len + 1).batch_at(step)
        drawn = {"seq": h["history"][:, :-1], "pos": h["history"][:, 1:],
                 "seq_mask": h["hist_mask"][:, 1:]}
        uniform = b["neg"]
    else:
        ref = JaxBatches(B, [300] * 3, seed=seed, hist_len=3).batch_at(step)
        drawn = {"user_feats": ref["sparse"], "user_mask": ref["hist_mask"]}
        uniform = b["item"]
        counts = np.bincount(uniform, minlength=n)
        assert np.allclose(np.exp(b["logq"]), counts[uniform] / B)
    for k, v in drawn.items():
        assert np.array_equal(b[k], v), k
    if kind in ("sasrec", "twotower"):
        assert uniform.min() >= 0 and uniform.max() < n
        assert abs(_uniform_chi2(uniform, n) - (n - 1)) < \
            6 * np.sqrt(2 * (n - 1))
