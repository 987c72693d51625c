"""The port's SchNet (``repro_torch.models.gnn``) against the JAX
package's, on the CPU.

Three small configurations: the regression head over 5 graphs with two
interactions, the node-classification head (7 classes) with three, and
one interaction (its ``inter`` leaves still stacked), each unchunked and
in 4 edge chunks.  The reference's parameters (``init_params`` with
``PRNGKey(0)``) are carried into the port by ``convert.gnn_from_jax``; the
batches are made from a numpy seed and hold the cases the gathers must
get right: a source id past the nodes (JAX clamps it to the last node), a
negative one (counted from the end), a destination past the nodes (the
segment sum drops it), masked edges and masked nodes.  The reference's
functions call its sharding constraint, which jax 0.9 accepts only on a
mesh with Auto axes, so the oracle's mesh is built with them.

Tolerances, float32 (XLA and PyTorch's CPU kernels sum in other orders):
outputs and losses within rtol ``RTOL`` = 1e-5, atol ``ATOL`` = 1e-6;
each gradient leaf's max |difference| within ``GRAD_TOL`` = 1e-5 of that
leaf's max |g|; a second AdamW step from the reference's first: every
parameter and moment within ``OPT_TOL`` = 1e-5 of that leaf's max
|value|.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as jgnn
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import convert, tree
from repro_torch.models import gnn as tgnn
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import global_norm

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5
OPT_TOL = 1e-5
LR = 1e-3

#: (config fields, nodes, edges, graphs of the regression head)
CONFIGS = [
    (dict(n_interactions=2, d_hidden=16, n_rbf=12, cutoff=5.0, d_feat=6,
          n_out=1), 60, 200, 5),
    (dict(n_interactions=3, d_hidden=12, n_rbf=10, cutoff=8.0, d_feat=9,
          n_out=7), 48, 160, 1),
    (dict(n_interactions=1, d_hidden=8, n_rbf=6, cutoff=10.0, d_feat=4,
          n_out=1), 30, 96, 3),
]
CASES = [(i, chunks) for i in range(len(CONFIGS)) for chunks in (1, 4)]


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


def cfgs(i: int, chunks: int = 1):
    """(JAX config, port config, N, E, n_graphs) of configuration ``i`` in
    ``chunks`` edge chunks."""
    kw, N, E, G = CONFIGS[i]
    ec = E // chunks if chunks > 1 else None
    return (jgnn.SchNetConfig(edge_chunk=ec, **kw),
            tgnn.SchNetConfig(edge_chunk=ec, **kw), N, E, G)


@functools.lru_cache(maxsize=None)
def jax_params(i: int, seed: int = 0) -> dict:
    """The reference's initial parameters of configuration ``i``, numpy
    leaves (drawn once a module: each draw compiles)."""
    return jax.tree.map(np.asarray, jgnn.init_params(
        cfgs(i)[0], jax.random.PRNGKey(seed)))


def make_batch(i: int, seed: int) -> dict:
    """A numpy batch of configuration ``i`` with the edge cases above."""
    _, c, N, E, G = cfgs(i)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    src[0], src[1], dst[2] = N + 3, -2, N      # clamped, wrapped, dropped
    b = {"node_feat": rng.standard_normal((N, c.d_feat)),
         "src": src, "dst": dst,
         "dist": rng.random(E) * c.cutoff,
         "edge_mask": rng.random(E) < 0.9,
         "node_mask": (rng.random(N) < 0.9).astype(np.float64)}
    if c.n_out > 1:
        b["labels"] = rng.integers(0, c.n_out, N)
    else:
        b["graph_ids"] = np.sort(rng.integers(0, G, N))
        b["target"] = rng.standard_normal(G)
    return {k: v if v.dtype == bool else v.astype(
        np.float32 if v.dtype == np.float64 else np.int32)
        for k, v in b.items()}


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


@pytest.mark.parametrize("i,chunks", CASES)
def test_forward_matches(mesh, i, chunks):
    jcfg, tcfg, N, _, _ = cfgs(i, chunks)
    params = jax_params(i)
    b = make_batch(i, seed=i)
    with mesh:
        want = jax.jit(lambda p, bb: jgnn.forward(p, bb, jcfg, mesh))(
            params, jb(b))
    got = tgnn.forward(convert.gnn_from_jax(params, device="cpu"), tb(b),
                       tcfg)
    assert tuple(got.shape) == tuple(want.shape) == (N, tcfg.n_out)
    assert torch.isfinite(got).all()
    close(got, want)


@pytest.mark.parametrize("i,chunks", CASES)
def test_loss_and_gradients_match(mesh, i, chunks):
    """The loss and each leaf of ``jax.grad`` against the port's autograd
    through ``make_train_step``."""
    jcfg, tcfg, _, _, G = cfgs(i, chunks)
    params = jax_params(i)
    b = make_batch(i, seed=10 + i)
    with mesh:
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, bb: jgnn.graph_loss(p, bb, jcfg, mesh, G)))(
                params, jb(b))
    store: dict = {}

    def keep(p, g, s):
        store["grads"] = g
        return p, s, global_norm(g)

    tp = convert.gnn_from_jax(params, device="cpu")
    out = tgnn.make_train_step(tcfg, keep, G)(tp, None, tb(b))
    assert out[0] is tp
    assert out[2].dtype == torch.float32 and out[2].shape == ()
    close(out[2], want_loss)
    got = store["grads"]
    assert tree.treedef_str(tree.flatten(got)[1]) == \
        str(jax.tree.structure(want))
    errs = [leaf_err(g, w) for g, w in zip(tree.leaves(got),
                                           jax.tree.leaves(want))]
    assert max(errs) <= GRAD_TOL, errs


@pytest.mark.parametrize("i,chunks", CASES)
def test_second_adamw_step_matches(mesh, i, chunks):
    """The second AdamW step from the reference's first, carried across by
    ``gnn_from_jax`` and ``adamw_from_jax``: loss, gradient norm, every
    parameter and moment; the update is in place."""
    jcfg, tcfg, _, _, G = cfgs(i, chunks)
    params = jax_params(i)
    b0, b1 = make_batch(i, seed=20), make_batch(i, seed=21)
    with mesh:
        jstep = jax.jit(jgnn.make_train_step(
            jcfg, mesh, lambda p, g, s: jadamw_update(p, g, s, LR), G))
        p1, o1, _, _ = jstep(params, jadamw_init(params), jb(b0))
        p1, o1 = jax.tree.map(np.asarray, (p1, o1))
        p2, o2, jloss, jnorm = jstep(p1, o1, jb(b1))
    tp = convert.gnn_from_jax(p1, device="cpu")
    to = convert.adamw_from_jax(o1, device="cpu")
    out = tgnn.make_train_step(
        tcfg, lambda p, g, s: adamw_update(p, g, s, LR), G)(tp, to, tb(b1))
    assert out[0] is tp and out[1] is to
    np.testing.assert_allclose(float(out[2]), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(out[3]), float(jnorm), rtol=RTOL)
    assert int(to.step) == int(o2.step) == 2
    errs = [leaf_err(g, w) for g, w in zip(
        tree.leaves((tp, to.mu, to.nu)), jax.tree.leaves((p2, o2.mu, o2.nu)))]
    assert max(errs) <= OPT_TOL, errs


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_chunks_equal_the_whole(i):
    """The port against itself: 4 and 2 edge chunks give the unchunked
    outputs and gradients (the chunk sums add in another order)."""
    _, tcfg, _, E, G = cfgs(i)
    b = tb(make_batch(i, seed=30))
    params = convert.gnn_from_jax(jax_params(i), device="cpu")
    runs = []
    for chunks in (1, 2, 4):
        cfg = replace(tcfg, edge_chunk=E // chunks if chunks > 1 else None)
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        p = tree.unflatten(tree.flatten(params)[1], leaves)
        loss = tgnn.graph_loss(p, b, cfg, G)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    for loss, grads in runs[1:]:
        np.testing.assert_allclose(float(loss), float(runs[0][0]), rtol=RTOL)
        for g, w in zip(grads, runs[0][1]):
            assert leaf_err(g, w.numpy()) <= GRAD_TOL


def test_chunks_must_divide_the_edges():
    _, tcfg, _, E, G = cfgs(0)
    b = tb(make_batch(0, seed=31))
    params = convert.gnn_from_jax(jax_params(0), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        tgnn.forward(params, b, replace(tcfg, edge_chunk=E // 3))


def test_the_expansion_is_never_saved_for_the_backward():
    """Every chunk of the cfconv runs under the checkpoint, chunked or not:
    the autograd graph outside it saves no (chunk, n_rbf) expansion and no
    (chunk, d_hidden) filter or message."""
    _, tcfg, N, E, G = cfgs(0)
    b = tb(make_batch(0, seed=32))
    params = tree.tree_map(lambda t: t.requires_grad_(),
                           convert.gnn_from_jax(jax_params(0), device="cpu"))
    for ec in (None, E // 4):
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = tgnn.graph_loss(params, b, replace(tcfg, edge_chunk=ec), G)
        rows = ec or E
        assert saved
        assert not [s for s in saved if len(s) == 2 and s[0] == rows], saved
        loss.backward()


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_init_params_follow_the_reference(i):
    """The reference's tree (``inter`` stacked, one interaction too), shapes
    and dtypes; weights N(0, 1/in) by their moments, biases zero."""
    jcfg, tcfg, _, _, _ = cfgs(i)
    want = jax_params(i)
    got = tgnn.init_params(tcfg, "cpu", torch.Generator().manual_seed(3))
    assert tree.treedef_str(tree.flatten(got)[1]) == \
        str(jax.tree.structure(want))
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    z = []
    for name, leaf in zip(tree.path_names(got), tree.leaves(got)):
        if name.endswith("/b"):
            assert (leaf == 0).all(), name
        else:       # N(0, 1/in): in is the second last dimension
            z.append((leaf * leaf.shape[-2] ** 0.5).reshape(-1))
    z = torch.cat(z).double()
    assert abs(float(z.mean())) < 0.25 and abs(float(z.var()) - 1) < 0.3
    a = tgnn.init_params(tcfg, "cpu", torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in
               zip(tree.leaves(a), tree.leaves(got)))


def test_rbf_and_ssp_match():
    """``rbf_expand`` and ``ssp``, with arguments past 20, where
    ``F.softplus`` returns x itself."""
    jcfg, tcfg, _, _, _ = cfgs(0)
    d = np.random.default_rng(0).random(100).astype(np.float32) * 6
    close(tgnn.rbf_expand(torch.from_numpy(d), tcfg),
          jgnn.rbf_expand(jnp.asarray(d), jcfg))
    x = np.linspace(-30, 40, 301).astype(np.float32)
    got = tgnn.ssp(torch.from_numpy(x)).numpy()
    want = np.asarray(jgnn.ssp(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 2e-9 + 1e-7 * np.abs(want).max()


@pytest.mark.parametrize("classify", [False, True])
def test_input_specs_match(classify):
    jcfg, tcfg, _, _, _ = cfgs(1)
    want = jgnn.input_specs(jcfg, 1024, 4096, n_graphs=7, classify=classify)
    got = tgnn.input_specs(tcfg, 1024, 4096, n_graphs=7, classify=classify)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k


def test_a_label_out_of_range_gives_nan_as_the_reference(mesh):
    jcfg, tcfg, _, _, _ = cfgs(1)
    params = jax_params(1)
    b = make_batch(1, seed=33)
    b["labels"][3] = tcfg.n_out + 2
    with mesh:
        want = jax.jit(lambda p, bb: jgnn.graph_loss(p, bb, jcfg, mesh))(
            params, jb(b))
    got = tgnn.graph_loss(convert.gnn_from_jax(params, device="cpu"), tb(b),
                          tcfg)
    assert np.isnan(float(want)) and torch.isnan(got)
    b["labels"][3] = -1                      # counts from the end
    b["node_mask"][3] = 1.0
    with mesh:
        want = jax.jit(lambda p, bb: jgnn.graph_loss(p, bb, jcfg, mesh))(
            params, jb(b))
    close(tgnn.graph_loss(convert.gnn_from_jax(params, device="cpu"), tb(b),
                          tcfg), want)
