"""The port's two-tower model against the JAX package's two-tower functions.

The reference's parameters (``twotower_init`` with ``PRNGKey(0)``) are
carried into a port ``TwoTower`` by ``convert.twotower_from_jax``; user
profiles and item ids made from a seed with numpy then go through both.
Tolerance rtol 1e-5, atol 1e-6: the towers are float32 matrix products
that XLA and PyTorch's CPU kernels sum in other orders.  Item ids past
``n_items`` read the last row in both (a JAX gather clamps; the port's
lookup does the same).  ``twotower_retrieve`` calls the reference's
sharding constraint, which jax 0.9 accepts only on a mesh with Auto axes,
so the oracle's mesh is built with them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recsys as rec
from repro_torch import convert
from repro_torch.models.recsys import TwoTower, TwoTowerConfig

RTOL, ATOL = 1e-5, 1e-6
#: (n_users_vocab, n_items, embed_dim, tower_mlp, n_user_feats): the hybrid
#: example's, and one whose towers narrow to another width in three layers
CONFIGS = {"example": (4096, 1501, 32, (64, 32), 4),
           "non-square": (300, 77, 24, (40, 16, 8), 3)}


def _cfgs(name):
    nu, ni, d, mlp, nf = CONFIGS[name]
    kw = dict(n_users_vocab=nu, n_items=ni, embed_dim=d, tower_mlp=mlp,
              n_user_feats=nf)
    return rec.TwoTowerConfig(**kw), TwoTowerConfig(**kw)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(name, jax cfg, jax params, port cfg, port model)."""
    jcfg, tcfg = _cfgs(request.param)
    params = rec.twotower_init(jcfg, jax.random.PRNGKey(0))
    model = convert.twotower_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    return request.param, jcfg, params, tcfg, model


def _batch(cfg, seed, B=5):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, cfg.n_users_vocab, (B, cfg.n_user_feats))
    mask = (rng.random((B, cfg.n_user_feats)) < 0.8).astype(np.float32)
    items = rng.integers(0, cfg.n_items + 30, B)     # some past the table
    items[0] = cfg.n_items                            # one just past it
    cands = np.concatenate([rng.integers(0, cfg.n_items, 60),
                            [cfg.n_items - 1, cfg.n_items, cfg.n_items + 9]])
    return {"user_feats": feats.astype(np.int32), "user_mask": mask,
            "item": items.astype(np.int32),
            "cand_ids": cands.astype(np.int32)}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_parameters_carry_across(pair):
    _name, jcfg, params, tcfg, model = pair
    assert np.array_equal(model.item_table.weight.detach().numpy(),
                          np.asarray(params["item_table"]))
    lins = [m for m in model.user_tower if isinstance(m, torch.nn.Linear)]
    assert len(lins) == len(jcfg.tower_mlp)
    for lin, layer in zip(lins, params["user_tower"]):
        assert np.array_equal(lin.weight.detach().numpy(),
                              np.asarray(layer["w"]).T)


@pytest.mark.parametrize("seed", [0, 1])
def test_user_embedding_matches(pair, mesh, seed):
    _name, jcfg, params, tcfg, model = pair
    b = _batch(jcfg, seed)
    want = rec.user_embedding(params, _jax(b), jcfg, mesh)
    got = model.user_embedding(_torch(b))
    assert got.shape == (5, jcfg.tower_mlp[-1])
    _close(got, want)
    _close(got.norm(dim=-1), np.ones(5))


@pytest.mark.parametrize("seed", [0, 1])
def test_item_embedding_matches_with_ids_past_the_table(pair, mesh, seed):
    _name, jcfg, params, tcfg, model = pair
    b = _batch(jcfg, seed)
    ids = b["cand_ids"]
    assert (ids >= jcfg.n_items).any()
    want = rec.item_embedding(params, jnp.asarray(ids), jcfg, mesh)
    got = model.item_embedding(torch.from_numpy(ids))
    _close(got, want)
    # an id past the table reads the last row, as the JAX gather clamps it
    last = model.item_embedding(torch.tensor([jcfg.n_items - 1]))
    _close(got[-2:], last.expand(2, -1).detach().numpy())


def test_twotower_serve_matches(pair, mesh):
    _name, jcfg, params, tcfg, model = pair
    b = _batch(jcfg, 2)
    want = rec.twotower_serve(params, _jax(b), jcfg, mesh)
    _close(model.serve(_torch(b)), want)


def test_twotower_retrieve_matches(pair, mesh):
    _name, jcfg, params, tcfg, model = pair
    b = _batch(jcfg, 3, B=1)
    with mesh:
        want = rec.twotower_retrieve(params, _jax(b), jcfg, mesh)
    got = model.retrieve(_torch(b))
    assert got.shape == (1, len(b["cand_ids"]))
    _close(got, want)


def test_init_follows_the_reference_distributions():
    """Tables N(0, 0.01²), weights N(0, 1)·√(2/in), biases zero; the same
    generator seed gives the same parameters."""
    cfg = TwoTowerConfig(n_users_vocab=4000, n_items=3000, embed_dim=64,
                         tower_mlp=(256, 32), n_user_feats=4)
    model = TwoTower(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    for table in (model.user_table.weight.detach(),
                  model.item_table.weight.detach()):
        assert abs(float(table.std()) - 0.01) < 2e-4
        assert abs(float(table.mean())) < 2e-4
    for tower in (model.user_tower, model.item_tower):
        lins = [m for m in tower if isinstance(m, torch.nn.Linear)]
        assert [type(m).__name__ for m in tower] == ["Linear", "ReLU",
                                                     "Linear"]
        for lin in lins:
            want = np.sqrt(2.0 / lin.in_features)
            assert abs(float(lin.weight.detach().std()) / want - 1) < 0.05
            assert not lin.bias.any()
    again = TwoTower(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


def test_without_a_device_and_without_cuda_construction_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    jcfg, tcfg = _cfgs("non-square")
    with pytest.raises(RuntimeError, match="CUDA"):
        TwoTower(tcfg)
    params = jax.tree.map(np.asarray,
                          rec.twotower_init(jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.twotower_from_jax(params, tcfg)
