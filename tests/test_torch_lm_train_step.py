"""The port's LM train step (``repro_torch.models.lm.make_train_step``)
against the JAX package's, on the CPU, step by step.

The setting and the tolerances are ``tests/test_torch_lm_train.py``'s
(this file holds its train-step cases, apart so that the two files'
XLA compiles run on two test workers).  Two updates of the same
parameters from two gradient computations are never compared
elementwise: at step 1 AdamW's m̂/√v̂ is ±1 for each element, so an element
whose gradient is near 0 may flip its sign between two correct
implementations and its parameter then differs by 2·lr.  So each step is
compared in three parts, along the reference's trajectory (the port starts
each step from the reference's parameters): the loss and the gradient
norm (``F32_TOL``), each leaf's accumulated gradient (``GRAD_TOL`` with
``NOISE_FLOOR``), and the port's AdamW fed the reference's gradient
against the reference's update (``OPT_TOL``).
"""

import jax
import numpy as np
import pytest

from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import convert, tree
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw_update
from test_torch_lm_train import (ARCHS, F32_TOL, LR, OPT_TOL,  # noqa: F401
                                 _assert_grads_close, _batch, _capture,
                                 _cfgs, _one_torch_thread, _port_params,
                                 _rel, mesh)


@pytest.mark.parametrize("microbatch,remat", [(1, True), (2, False)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(mesh, arch, microbatch, remat):
    """Three steps along the reference's trajectory: each step's loss, its
    accumulated gradient, its gradient norm, and the port's AdamW fed the
    reference's gradient against the reference's update."""
    jcfg, tcfg = _cfgs(arch, vocab=500, microbatch=microbatch, remat=remat)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jadamw_init(jparams)
    jstep = jax.jit(jlm.make_train_step(jcfg, mesh,
                                        lambda p, g, s: (g, s, 0.0)))
    jupdate = jax.jit(lambda p, g, s: jadamw_update(p, g, s, LR))
    store: dict = {}
    tstep = tlm.make_train_step(tcfg, _capture(store))
    for step in range(3):
        # numpy leaves in, so each jitted function compiles once
        jparams, jopt = jax.tree.map(np.asarray, (jparams, jopt))
        jb, tb = _batch(500, seed=10 + step)
        with mesh:
            jgrads, _, jloss, _ = jstep(jparams, None, jb)
        params = _port_params(jparams, tcfg)
        out = tstep(params, None, tb)
        assert out[0] is params
        assert _rel(out[2], jloss) <= F32_TOL
        _assert_grads_close(store["grads"], jgrads)
        # the optimizer alone, fed the reference's gradient
        topt = convert.adamw_from_jax(jax.tree.map(np.asarray, jopt),
                                      device="cpu")
        tgrads = _port_params(jgrads, tcfg)
        jparams, jopt, jnorm = jupdate(jparams, jgrads, jopt)
        assert _rel(out[3], jnorm) <= F32_TOL
        adamw_update(params, tgrads, topt, LR)
        for t, j in zip(tree.leaves((params, topt)),
                        jax.tree.leaves((jparams, jopt))):
            j = np.asarray(j, np.float64)
            err = np.abs(t.double().numpy() - j).max() / max(
                np.abs(j).max(), 1e-30)
            assert err <= OPT_TOL
