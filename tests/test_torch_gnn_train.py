"""The port's GNN training path against the JAX package's, on the CPU:
``launch/train.py``'s gnn branch (``reduced_schnet``, ``GraphBatches``,
``train_gnn``) and ``configs.common.GNNArch``.

* The reference's own ``main`` runs its gnn branch (``--arch schnet``)
  with its Trainer, its mesh replaced by one with Auto axes (jax 0.9
  rejects the sharding constraint on the reference's own mesh); the port's
  ``main`` from the reference's initial parameters (carried across by
  ``convert.gnn_from_jax`` in place of the port's draw) gives its losses
  and gradient norms within rtol 1e-5, and ``GraphBatches`` its batches
  bit for bit.
* A run resumed from a checkpoint prints the losses of a straight run.
* ``GNNArch.cfg_for`` and ``flops`` equal the reference's for all four
  shapes; ``train_gnn`` takes a ``GNNArch`` with a shape and, without a
  device, asks for the card.
"""

import os
import re
import sys
from dataclasses import fields

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.configs import get_arch as jax_get_arch
from repro.configs.common import GNN_SHAPES as JAX_GNN_SHAPES
from repro.configs.common import _pad512 as jax_pad512
from repro.train import Trainer as JaxTrainer
from repro_torch import convert, tree
from repro_torch.configs import get_arch
from repro_torch.configs.common import GNN_SHAPES, GNNArch, _pad512
from repro_torch.launch import train
from repro_torch.models import gnn as tgnn

LINE = re.compile(r"^\[train\] (\S+): loss (\S+) -> (\S+) over (\d+) steps; "
                  r"stragglers=(\d+)$", re.M)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_gnn_branch(monkeypatch, steps: int, batch: int) -> dict:
    """The reference's ``main --arch schnet`` on a mesh with Auto axes:
    its initial parameters (numpy), its trainer's metrics, its
    ``batch_at`` and its printed line."""
    got: dict = {}

    class Recording(JaxTrainer):
        def __init__(self, step, params, opt, batch_at, **kw):
            got["init"] = jax.tree.map(np.asarray, params)
            got["batch_at"] = batch_at
            super().__init__(step, params, opt, batch_at,
                             log_fn=lambda *_: None, **kw)
            got["trainer"] = self

    monkeypatch.setattr(jtrain, "make_host_mesh", lambda: jax.make_mesh(
        (1, 1), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2))
    monkeypatch.setattr(jtrain, "Trainer", Recording)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "schnet", "--steps",
                                      str(steps), "--batch", str(batch)])
    jtrain.main()
    return got


def _carry(monkeypatch, init) -> None:
    monkeypatch.setattr(tgnn, "init_params", lambda cfg, device, gen:
                        convert.gnn_from_jax(init, device))


@pytest.mark.parametrize("batch", [4, 3])
def test_train_main_gnn_matches_the_reference(monkeypatch, capsys, batch):
    ref = _reference_gnn_branch(monkeypatch, 12, batch)
    want = ref["trainer"].metrics
    ref_line = LINE.search(capsys.readouterr().out)
    _carry(monkeypatch, ref["init"])
    out = train.main(["--arch", "schnet", "--device", "cpu", "--steps", "12",
                      "--batch", str(batch)])
    got = out["trainer"].metrics
    np.testing.assert_allclose([x["loss"] for x in got],
                               [x["loss"] for x in want], rtol=1e-5)
    np.testing.assert_allclose([x["gnorm"] for x in got],
                               [x["gnorm"] for x in want], rtol=1e-5)
    line = LINE.search(capsys.readouterr().out)
    assert line.group(1) == ref_line.group(1) == "schnet"
    assert line.group(4) == ref_line.group(4) == "12"
    for g in (2, 3):
        assert abs(float(line.group(g)) - float(ref_line.group(g))) <= 2e-4


@pytest.mark.parametrize("step", [0, 1, 7])
def test_graph_batches_are_the_reference_branch_batches(monkeypatch, step):
    ref = _reference_gnn_branch(monkeypatch, 1, 5)
    want = ref["batch_at"](step)
    got = train.GraphBatches(5).batch_at(step)
    assert list(got) == list(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.dtype == w.dtype and v.shape == w.shape, k
        np.testing.assert_array_equal(v, w)


def test_reduced_schnet_is_the_reference_branch_config(monkeypatch):
    got = {}
    real = jtrain.gnn_mod.init_params

    def spy(cfg, key):
        got["cfg"] = cfg
        return real(cfg, key)

    monkeypatch.setattr(jtrain.gnn_mod, "init_params", spy)
    _reference_gnn_branch(monkeypatch, 1, 2)
    want, mine = got["cfg"], train.reduced_schnet()
    assert [f.name for f in fields(mine)] == [f.name for f in fields(want)]
    for f in fields(mine):
        a, b = getattr(mine, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert a == torch.float32 and np.dtype(b) == np.float32
        else:
            assert a == b, f.name


def test_train_main_gnn_resumes_to_the_same_loss(tmp_path, capsys):
    def run(*args):
        train.main(["--arch", "schnet", "--device", "cpu", *args])
        return capsys.readouterr().out

    straight = LINE.search(run("--steps", "10")).groups()
    ck = str(tmp_path / "ck")
    a = run("--steps", "6", "--ckpt-dir", ck)
    b = run("--steps", "4", "--ckpt-dir", ck)
    assert "resumed" not in a
    assert "[trainer] resumed from step 5" in b
    assert LINE.search(a).group(2) == straight[1]
    assert LINE.search(b).group(3) == straight[2]
    assert sorted(os.listdir(ck)) == ["step-0000000005", "step-0000000009"]


@pytest.mark.parametrize("shape_id", list(JAX_GNN_SHAPES))
def test_gnn_arch_cfg_for_and_flops_match(shape_id):
    got, want = get_arch("schnet"), jax_get_arch("schnet")
    assert isinstance(got, GNNArch)
    assert GNN_SHAPES == JAX_GNN_SHAPES
    assert got.flops(shape_id) == want.flops(shape_id)
    tc, jc = got.cfg_for(shape_id), want.cfg_for(shape_id)
    for f in fields(tc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    s = GNN_SHAPES[shape_id]
    assert _pad512(s["n_edges"]) == jax_pad512(s["n_edges"])
    assert _pad512(s["n_nodes"]) == jax_pad512(s["n_nodes"])
    if shape_id == "ogb_products":
        assert tc.edge_chunk == 3_866_208 == _pad512(s["n_edges"]) // 16
        assert got.flops(shape_id) == pytest.approx(2.64e13, rel=0.01)


def test_train_gnn_takes_an_arch_and_a_shape():
    """A narrowed schnet at molecule's head and features: the shape's
    config is trained, and the batch fits ``input_specs``."""
    from dataclasses import replace
    arch = replace(get_arch("schnet"), base_cfg=replace(
        get_arch("schnet").base_cfg, d_hidden=8, n_rbf=5, n_interactions=1))
    cfg = arch.cfg_for("molecule")
    specs = tgnn.input_specs(cfg, 24, 64, n_graphs=3)
    rng = np.random.default_rng(0)

    class Data:
        def batch_at(self, step):
            b = {"node_feat": rng.standard_normal((24, cfg.d_feat)),
                 "src": rng.integers(0, 24, 64),
                 "dst": rng.integers(0, 24, 64),
                 "dist": rng.random(64) * 10, "edge_mask": np.ones(64, bool),
                 "node_mask": np.ones(24), "graph_ids": np.arange(24) % 3,
                 "target": rng.standard_normal(3)}
            return {k: v.astype(str(specs[k].dtype).removeprefix("torch."))
                    for k, v in b.items()}

    out = train.train_gnn(arch, 3, shape="molecule", data=Data(), n_graphs=3,
                          device="cpu", log_every=0)
    params = out["trainer"].params
    assert params["embed_in"]["w"].shape == (16, 8)
    assert params["inter"]["filt1"]["w"].shape == (1, 5, 8)
    assert out["line"].startswith("[train] schnet: loss ")
    assert np.isfinite([m["loss"] for m in out["trainer"].metrics]).all()
    assert int(out["trainer"].opt_state.step) == 3


def test_train_gnn_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train_gnn(train.reduced_schnet(), 1,
                        data=train.GraphBatches(2), n_graphs=2)


def test_gnn_from_jax_keeps_the_tree():
    from repro.models import gnn as jgnn
    cfg = jgnn.SchNetConfig(n_interactions=1, d_hidden=8, n_rbf=4,
                            d_feat=3)
    params = jax.tree.map(np.asarray, jgnn.init_params(
        cfg, jax.random.PRNGKey(1)))
    got = convert.gnn_from_jax(params, device="cpu")
    assert tree.treedef_str(tree.flatten(got)[1]) == \
        str(jax.tree.structure(params))
    assert got["inter"]["out1"]["w"].shape == (1, 8, 8)
    for g, w in zip(tree.leaves(got), jax.tree.leaves(params)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
