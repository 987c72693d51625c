"""The port's LM training path (``repro_torch.models.lm`` ``lm_loss`` and
``make_train_step``) against the JAX package's, on the CPU.

The configurations are the reference's ``reduced_lm`` of llama3.2-3b
(dense), granite-moe-3b-a800m (8 experts, top-2) and llama4-scout (8
experts, top-1), with vocab 500 where a case asks for padded vocab columns
(500 padded to 512).  The reference's parameters come from
``init_params(cfg, PRNGKey(0))`` and are carried into the port by
``convert.lm_from_jax``; tokens are made from a numpy seed.  The
reference's functions call its sharding constraint, which jax 0.9 accepts
only on a mesh with Auto axes, so the oracle's mesh is built with them.

Two updates of the same parameters from two gradient computations are
never compared elementwise: at step 1 AdamW's m̂/√v̂ is ±1 for each
element, so an element whose gradient is near 0 may flip its sign between
two correct implementations and its parameter then differs by 2·lr.  So
a train step is compared in three parts, along the reference's trajectory
(the port starts each step from the reference's parameters): the loss, each
leaf's gradient, and the optimizer alone fed identical gradients.  Those
step-by-step cases are in ``tests/test_torch_lm_train_step.py``, so that
the two files' XLA compiles run on two test workers.

Tolerances:

* the loss, float32: ``F32_TOL`` = 1e-5 relative (measured below 1e-6);
* a gradient leaf, float32: its max |difference| within ``GRAD_TOL`` =
  1e-5 of the leaf's max |g| (measured below 1e-6), where a leaf's max
  |g| is taken as at least ``NOISE_FLOOR`` = 1e-2 of the tree's largest:
  llama4-scout's top-1 gate is normalised to exactly 1, so its router's
  true gradient is 0 and both packages' values (~1e-10) are rounding;
* the optimizer fed the reference's gradients: 1e-6 of each leaf's max
  |value| (``tests/test_torch_optim.py`` says why);
* bfloat16: ``BF16_TOL`` = 2e-2 of the largest |value|, the LM tests'
  bfloat16 bound (about five bf16 ulps).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.train import reduced_lm as jax_reduced_lm
from repro.models import lm as jlm
from repro_torch import convert, tree
from repro_torch.configs import get_arch
from repro_torch.launch.train import reduced_lm
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import global_norm

F32_TOL = 1e-5
GRAD_TOL = 1e-5
NOISE_FLOOR = 1e-2
OPT_TOL = 1e-6
BF16_TOL = 2e-2
ARCHS = ["llama3.2-3b", "granite-moe-3b-a800m", "llama4-scout-17b-a16e"]
B, S = 4, 128            # loss_chunk 64: two chunks; q 32 / kv 64 chunks
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread is faster, and the test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _cfgs(arch, **kw):
    return (replace(jax_reduced_lm(jax_get_arch(arch).cfg), **kw),
            replace(reduced_lm(get_arch(arch).cfg),
                    **{k: (torch.bfloat16 if v is jnp.bfloat16 else v)
                       for k, v in kw.items()}))


def _port_params(jparams, tcfg) -> dict:
    """The reference's parameters as the port's dict of fresh tensors."""
    model = convert.lm_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return tree.tree_map(lambda t: t.detach().clone(), model.params())


def _batch(vocab, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())})


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _assert_grads_close(tgrads, jgrads, tol=GRAD_TOL):
    tl = [t.float().numpy() for t in tree.leaves(tgrads)]
    jl = [np.asarray(jnp.asarray(a, jnp.float32))
          for a in jax.tree.leaves(jgrads)]
    assert len(tl) == len(jl)
    top = max(np.abs(a).max() for a in jl)
    for i, (g, w) in enumerate(zip(tl, jl)):
        scale = max(np.abs(w).max(), NOISE_FLOOR * top)
        err = np.abs(g - w).max() / scale
        assert err <= tol, (i, err)


def _capture(store):
    """An optimizer_update that records the gradients and changes
    nothing."""
    def update(p, g, s):
        store["grads"] = tree.tree_map(lambda x: x.detach().clone(), g)
        return p, s, global_norm(g)
    return update


# --------------------------------------------------------------------------
# the loss and its gradient
# --------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,remat", [(512, False), (500, True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradient_match_the_reference(mesh, arch, vocab, remat):
    """The loss and every leaf of ``torch.autograd.grad(lm_loss)`` on the
    stacked parameters against ``jax.value_and_grad(lm_loss)``.  vocab 500
    pads to 512: the padded columns are filled with -1e30.  The loss is
    the same without autograd, where its chunks run without checkpoints."""
    jcfg, tcfg = _cfgs(arch, vocab=vocab, remat=remat)
    assert (tcfg.vocab_padded > tcfg.vocab) == (vocab == 500)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = tree.tree_map(lambda t: t.requires_grad_(),
                           _port_params(jparams, tcfg))
    jb, tb = _batch(vocab, seed=1)
    with mesh:
        jloss, jgrads = jax.value_and_grad(
            lambda p: jlm.lm_loss(p, jb, jcfg, mesh))(jparams)
    loss = tlm.lm_loss(params, tb, tcfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert _rel(loss.detach(), jloss) <= F32_TOL
    with torch.no_grad():
        assert float(tlm.lm_loss(params, tb, tcfg)) == float(loss)
    grads = torch.autograd.grad(loss, tree.leaves(params))
    _assert_grads_close(tree.unflatten(tree.flatten(params)[1], grads),
                        jgrads)


def test_remat_counts_dropped_tokens_once():
    """Under remat each layer runs twice (the backward pass recomputes
    it); ``drops`` hears from the first run only."""
    _, tcfg = _cfgs("granite-moe-3b-a800m")
    params = tlm.init_params(tcfg, "cpu")
    _, tb = _batch(512, seed=2)
    with torch.no_grad():
        plain: list = []
        tlm.forward(params, tb["tokens"], tcfg, drops=plain)
    leaves = tree.tree_map(lambda t: t.requires_grad_(), params)
    for remat in (True, False):
        drops: list = []
        out = tlm.forward(leaves, tb["tokens"], replace(tcfg, remat=remat),
                          drops=drops)
        out.float().square().sum().backward()
        assert len(drops) == tcfg.n_layers
        assert [int(d) for d in drops] == [int(d) for d in plain]
    assert sum(int(d) for d in plain) > 0


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


def test_bf16_step_matches_the_reference(mesh):
    """llama3.2-3b reduced, in bfloat16, microbatch 2: the loss and every
    leaf's accumulated gradient within the bf16 bound."""
    jcfg, tcfg = _cfgs("llama3.2-3b", dtype=jnp.bfloat16, microbatch=2)
    assert tcfg.dtype == torch.bfloat16
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jb, tb = _batch(512, seed=3)
    with mesh:
        jgrads, _, jloss, _ = jax.jit(jlm.make_train_step(
            jcfg, mesh, lambda p, g, s: (g, s, 0.0)))(jparams, None, jb)
    store: dict = {}
    out = tlm.make_train_step(tcfg, _capture(store))(
        _port_params(jparams, tcfg), None, tb)
    assert _rel(out[2], jloss) <= BF16_TOL
    assert all(g.dtype == torch.bfloat16
               for g in tree.leaves(store["grads"]))
    _assert_grads_close(store["grads"], jgrads, tol=BF16_TOL)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().view(
        {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def test_train_step_is_in_place_and_skips_a_non_finite_loss():
    """A finite loss updates the parameters, moments and counter in place;
    a non-finite one leaves every bit as it was and never calls the
    optimizer (the reference's trainer keeps the old state then)."""
    _, tcfg = _cfgs("llama3.2-3b")
    params = tlm.init_params(tcfg, "cpu")
    opt = adamw_init(params)
    calls = []

    def update(p, g, s):
        calls.append(1)
        return adamw_update(p, g, s, LR)

    step = tlm.make_train_step(tcfg, update)
    _, tb = _batch(512, seed=4)
    before = [_bits(t) for t in tree.leaves((params, opt))]
    p, o, loss, gnorm = step(params, opt, tb)
    assert p is params and o is opt and calls == [1]
    assert bool(torch.isfinite(loss)) and int(opt.step) == 1
    after = [_bits(t) for t in tree.leaves((params, opt))]
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    params["embed"][tb["tokens"][0, 0]] = float("nan")
    poisoned = [_bits(t) for t in tree.leaves((params, opt))]
    p, o, loss, gnorm = step(params, opt, tb)
    assert not bool(torch.isfinite(loss)) and calls == [1]
    assert p is params and o is opt and int(opt.step) == 1
    assert all(torch.equal(a, _bits(b)) for a, b in
               zip(poisoned, tree.leaves((params, opt))))
