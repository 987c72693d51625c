"""The port's ``distributed/`` (sharding rules on ``torch.distributed
.tensor``, int8 compression with error feedback, ``seq``) against the JAX
package's, on the CPU.

* Rules and placements: every leaf of two LM configs' parameter trees
  (llama3.2-3b, dense, and granite-moe, MoE) and of their AdamW states, on
  a single-pod and a multi-pod mesh: the port's leaf paths equal the
  reference's, its spec is the one the reference's ``tree_shardings``
  gives, and its DTensor placements are that spec's.
* ``compress_int8`` bit for bit (q and scale; ties at .5 rounded to even,
  an all-zero tensor), and ``ef_compress_tree`` over several steps bit for
  bit (q, scales and residuals).
* On a gloo world of 2 spawned CPU ranks started through
  ``repro_torch.launch.launch``: ``tree_shardings`` placements distribute
  a parameter tree as the rules say, ``constrain`` redistributes a DTensor
  and leaves a plain tensor alone, ``remesh`` moves the tree onto a (1, 2)
  mesh keeping every value; and ``psum_compressed`` over 3 steps, bit for
  bit (means and residuals) against the reference's inside ``shard_map``
  on 2 forced CPU devices (run in a subprocess, as
  ``tests/test_torch_mesh.py`` runs its reference).  The reference's
  ``shard_map`` runs eagerly, not under ``jax.jit``: XLA's CPU compiler
  contracts the residual's ``c - q * scale`` into a fused multiply-add,
  one rounding where eager JAX and the port round twice, and the
  residuals then differ in their last bits.  Every world has the
  launcher's 60 s process-group timeout and a deadline, and the
  subprocess a timeout.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_arch as jax_get_arch
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jshard
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import seq, sharding
from repro_torch.launch import launch
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw_init

SRC = Path(__file__).resolve().parents[1] / "src"
DEADLINE_S = 300
PSUM_STEPS = 3

AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}


def _fake_mesh(kind: str):
    """The rules read a mesh's dimension names only."""
    return SimpleNamespace(mesh_dim_names=AXES[kind])


def _jax_mesh(kind: str):
    return jax.make_mesh((1,) * len(AXES[kind]), AXES[kind])


def _meta(shapes):
    if isinstance(shapes, dict):
        return {k: _meta(v) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta")


def _jax_names(t) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


@pytest.mark.parametrize("kind", list(AXES))
@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "granite-moe-3b-a800m"])
def test_rules_and_placements_match_tree_shardings(arch_id, kind):
    jcfg, tcfg = jax_get_arch(arch_id).cfg, get_arch(arch_id).cfg
    jmesh, tmesh = _jax_mesh(kind), _fake_mesh(kind)
    jparams = jlm.params_shape(jcfg)
    tparams = _meta(tlm.param_shapes(tcfg))
    jtree = (jparams, jax.eval_shape(jadamw_init, jparams))
    ttree = (tparams, adamw_init(tparams))
    jrules, trules = jshard.lm_param_rules(jmesh), sharding.lm_param_rules(
        tmesh)
    assert [p for p, _ in trules] == [p for p, _ in jrules]
    assert [s for _, s in trules] == [tuple(s) for _, s in jrules]
    names = tree.path_names(ttree)
    assert names == _jax_names(jtree)
    want = jax.tree.leaves(jshard.tree_shardings(jtree, jmesh, jrules))
    got = sharding.tree_shardings(ttree, tmesh, trules)
    leaves = tree.leaves(ttree)
    assert len(got) == len(want) == len(leaves) == len(names)
    for name, leaf, pl, ns in zip(names, leaves, got, want):
        spec = sharding.spec_for(name, trules)[:leaf.dim()]
        assert spec == tuple(ns.spec), name
        assert pl == sharding.placements(tuple(ns.spec), leaf.dim(), tmesh)
        assert len(pl) == len(AXES[kind])
        for d, entry in enumerate(spec):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    assert pl[AXES[kind].index(ax)] == Shard(d), name


def test_placements_of_specs():
    multi, single = _fake_mesh("multi"), _fake_mesh("single")
    R = Replicate()
    assert sharding.placements((None, "data", "model"), 3, multi) == \
        (R, Shard(1), Shard(2))
    # a tensor dimension over ("pod", "data"): both mesh dims, pod-major
    assert sharding.placements((("pod", "data"), None), 2, multi) == \
        (Shard(0), Shard(0), R)
    # absent axes are filtered, and a spec longer than the rank is cut
    assert sharding.placements((("pod", "data"), "model"), 1, single) == \
        (Shard(0), R)
    assert sharding.placements((), 2, multi) == (R, R, R)
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("data", "pod"),), 1, multi)
    with pytest.raises(ValueError, match="named twice"):
        sharding.placements(("data", "data"), 2, multi)
    assert sharding.batch_axes(multi) == ("pod", "data")
    assert sharding.batch_axes(single) == ("data",)
    assert sharding._axes(single, ("pod", "data"), "pod", None) == \
        (("data",), None, None)


def test_path_names_are_the_references():
    t = {"b": [np.zeros(1), (np.zeros(2), None)], "a": {"z": np.zeros(3)}}
    assert tree.path_names(adamw_init(
        tree.tree_map(torch.from_numpy, t))) == _jax_names(
            jadamw_init(jax.tree.map(jnp.asarray, t)))
    assert tree.path_names(t) == ["a/z", "b/0", "b/1/0"]


def test_serialize_after_returns_the_tree():
    t = {"x": torch.ones(3)}
    assert seq.serialize_after(t, torch.zeros(())) is t


def _compress_inputs() -> list:
    rng = np.random.default_rng(0)
    halves = (np.arange(-127, 128) + 0.5).astype(np.float32)
    halves[-1] = 127.0                      # amax 127: the scale is 1
    return [rng.standard_normal((33, 5)).astype(np.float32),
            (rng.standard_normal(1000) * 1e-3).astype(np.float32),
            halves, np.zeros((4, 4), np.float32),
            np.float32(rng.standard_normal(()) * 3)]


@pytest.mark.parametrize("i", range(5))
def test_compress_int8_bit_for_bit(i):
    x = _compress_inputs()[i]
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    tq, ts = tcomp.compress_int8(torch.from_numpy(np.array(x)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    back = tcomp.decompress_int8(tq, ts).numpy()
    assert back.tobytes() == np.asarray(jcomp.decompress_int8(jq, js)
                                        ).tobytes()
    if i == 2:      # round half to even: 0.5 -> 0, 1.5 -> 2, -0.5 -> 0
        assert tq[127].item() == 0 and tq[128].item() == 2


def _grad_trees(rng, n: int) -> list:
    return [{"w": rng.standard_normal((6, 4)).astype(np.float32),
             "bs": [rng.standard_normal(5).astype(np.float32) * 1e-2,
                    rng.standard_normal((2, 3)).astype(np.float32)]}
            for _ in range(n)]


def test_error_feedback_over_steps_bit_for_bit():
    grads = _grad_trees(np.random.default_rng(1), 6)
    jef = jcomp.ef_init(jax.tree.map(jnp.asarray, grads[0]))
    tef = tcomp.ef_init(tree.tree_map(torch.from_numpy, grads[0]))
    for g in grads:
        jq, jef = jcomp.ef_compress_tree(jax.tree.map(jnp.asarray, g), jef)
        tq, tef = tcomp.ef_compress_tree(tree.tree_map(torch.from_numpy, g),
                                         tef)
        for a, b in zip(tree.leaves(tq), jax.tree.leaves(jq)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        for a, b in zip(tree.leaves(tef.residual),
                        jax.tree.leaves(jef.residual)):
            assert a.dtype == torch.float32
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    # the residual stays below half a quantum of each leaf
    for r, (q, s) in zip(tree.leaves(tef.residual), [
            (tq["bs"][0]), (tq["bs"][1]), (tq["w"])]):
        assert float(r.abs().max()) <= float(s) / 2 * (1 + 1e-6)


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------

JAX_PSUM = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed import compression as jcomp

    data = dict(np.load(sys.argv[1]))
    steps = int(sys.argv[3])
    mesh = jax.make_mesh((2,), ("pod",))
    keys = ["bs0", "bs1", "w"]         # JAX's leaf order

    def tree_of(d, s):
        return {"w": d[f"s{s}_w"], "bs": [d[f"s{s}_bs0"], d[f"s{s}_bs1"]]}

    def body(g, r):
        g = jax.tree.map(lambda a: a[0], g)
        r = jax.tree.map(lambda a: a[0], r)
        out, ef = jcomp.psum_compressed(g, "pod", jcomp.ErrorFeedback(r))
        return (jax.tree.map(lambda a: a[None], out),
                jax.tree.map(lambda a: a[None], ef.residual))

    # eager, not jitted: see the module's docstring
    f = jax.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                      out_specs=(P("pod"), P("pod")), check_vma=False)
    res = jax.tree.map(jnp.zeros_like, tree_of(data, 0))
    out = {}
    for s in range(steps):
        o, res = f(tree_of(data, s), res)
        for name, a in zip(keys, jax.tree.leaves(o)):
            out[f"out{s}_{name}"] = np.asarray(a)
        for name, a in zip(keys, jax.tree.leaves(res)):
            out[f"res{s}_{name}"] = np.asarray(a)
    np.savez(sys.argv[2], **out)
    print("OK")
""")

#: the small LM-like tree of the rank checks: (name, shape)
TREE = {"embed": (10, 6), "layers": {"wq": (2, 6, 4), "wo": (2, 4, 6),
                                     "ln1": (2, 6)},
        "ln_f": (6,), "out_proj": (6, 10)}


def _tree_values():
    g = torch.Generator().manual_seed(5)

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return torch.randn(s, generator=g)
    return make(TREE)


def _world_checks(rank: int, world: int, data_path: str) -> dict:
    """One rank: the sharding checks on a (2, 1) and a (1, 2) mesh, then
    ``psum_compressed`` over the steps of its gradients in the data file."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.launch import make_host_mesh
    out: dict = {}
    mesh_a, mesh_b = make_host_mesh(1), make_host_mesh(2)
    params = _tree_values()
    rules = sharding.lm_param_rules(mesh_a)
    pls = sharding.tree_shardings(params, mesh_a, rules)
    flat, treedef = tree.flatten(params)
    dts = [distribute_tensor(x, mesh_a, pl) for x, pl in zip(flat, pls)]
    out["a_placements"] = [tuple(d.placements) for d in dts]
    out["a_local"] = [d.to_local().clone() for d in dts]
    embed = tree.unflatten(treedef, dts)["embed"]
    moved = sharding.constrain(embed, mesh_a, "data", None)
    out["constrained"] = (tuple(moved.placements), moved.to_local().clone(),
                          moved.full_tensor())
    plain = torch.ones(3)
    out["plain_is_kept"] = sharding.constrain(plain, mesh_a, "data") is plain
    new = sharding.remesh(tree.unflatten(treedef, dts), mesh_b,
                          sharding.lm_param_rules(mesh_b))
    leaves = tree.leaves(new)
    out["b_is_dtensor"] = all(isinstance(x, DTensor) for x in leaves)
    out["b_placements"] = [tuple(x.placements) for x in leaves]
    out["b_local"] = [x.to_local().clone() for x in leaves]
    out["b_full"] = [x.full_tensor() for x in leaves]
    # psum_compressed over the default group
    with np.load(data_path) as z:
        d = {k: z[k] for k in z.files}
    ef, outs, res = None, [], []
    for s in range(int(d["steps"])):
        g = {"w": torch.from_numpy(d[f"s{s}_w"][rank]),
             "bs": [torch.from_numpy(d[f"s{s}_bs0"][rank]),
                    torch.from_numpy(d[f"s{s}_bs1"][rank])]}
        ef = ef or tcomp.ef_init(g)
        o, ef = tcomp.psum_compressed(g, None, ef)
        outs.append([x.clone() for x in tree.leaves(o)])
        res.append([x.clone() for x in tree.leaves(ef.residual)])
    out["psum"], out["psum_res"] = outs, res
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(3)
    data = {"steps": np.asarray(PSUM_STEPS)}
    for s in range(PSUM_STEPS):
        per_rank = _grad_trees(rng, 2)
        data[f"s{s}_w"] = np.stack([g["w"] for g in per_rank])
        data[f"s{s}_bs0"] = np.stack([g["bs"][0] for g in per_rank])
        data[f"s{s}_bs1"] = np.stack([g["bs"][1] for g in per_rank])
    np.savez(d / "data.npz", **data)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_PSUM, str(d / "data.npz"),
         str(d / "ref.npz"), str(PSUM_STEPS)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    try:
        port = launch(_world_checks, 2, backend="gloo", store_dir=d,
                      args=(str(d / "data.npz"),), deadline_s=DEADLINE_S)
        _, err = proc.communicate(timeout=DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    return dict(port=port, ref=ref)


def _shard(full: torch.Tensor, pl, rank_coords) -> torch.Tensor:
    """The local block of ``full`` under placements ``pl`` at the rank's
    mesh coordinates (torch.chunk's split, as DTensor's)."""
    out = full
    for p, c, n in rank_coords(pl):
        if isinstance(p, Shard):
            out = torch.chunk(out, n, dim=p.dim)[c]
    return out


def test_tree_shardings_distribute_as_the_rules_say(world):
    params = tree.leaves(_tree_values())
    names = tree.path_names(_tree_values())
    mesh = _fake_mesh("single")
    want = sharding.tree_shardings(_tree_values(), mesh,
                                   sharding.lm_param_rules(mesh))
    for rank, got in enumerate(world["port"]):
        assert got["a_placements"] == want
        # mesh (data 2, model 1): the rank is data coordinate ``rank``
        for name, full, pl, local in zip(names, params, want,
                                         got["a_local"]):
            exp = _shard(full, pl, lambda p: zip(p, (rank, 0), (2, 1)))
            assert torch.equal(local, exp), name
    # embed's (model, data) spec: columns split over data
    assert want[0] == (Shard(1), Shard(0))


def test_constrain_redistributes_a_dtensor_and_keeps_a_plain_tensor(world):
    full = tree.leaves(_tree_values())[0]
    for rank, got in enumerate(world["port"]):
        pl, local, whole = got["constrained"]
        assert pl == (Shard(0), Replicate())
        assert torch.equal(local, torch.chunk(full, 2, dim=0)[rank])
        assert torch.equal(whole, full)
        assert got["plain_is_kept"]


def test_remesh_keeps_every_value(world):
    params = tree.leaves(_tree_values())
    names = tree.path_names(_tree_values())
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    want = sharding.tree_shardings(_tree_values(), mesh,
                                   sharding.lm_param_rules(mesh))
    for rank, got in enumerate(world["port"]):
        assert got["b_is_dtensor"] and got["b_placements"] == want
        for name, full, pl, local, whole in zip(
                names, params, want, got["b_local"], got["b_full"]):
            assert torch.equal(whole, full), name
            # mesh (data 1, model 2): the rank is model coordinate ``rank``
            exp = _shard(full, pl, lambda p: zip(p, (0, rank), (1, 2)))
            assert torch.equal(local, exp), name
    # wq (L, D, H*dh) on (data 1, model 2): heads split over model
    assert want[names.index("layers/wq")] == (Shard(1), Shard(2))


def test_psum_compressed_bit_for_bit_on_two_ranks(world):
    ref = world["ref"]
    keys = ["bs0", "bs1", "w"]          # JAX's leaf order
    for rank, got in enumerate(world["port"]):
        for s in range(PSUM_STEPS):
            for name, o, r in zip(keys, got["psum"][s], got["psum_res"][s]):
                assert o.dtype == torch.float32
                assert o.numpy().tobytes() == \
                    ref[f"out{s}_{name}"][rank].tobytes(), (rank, s, name)
                assert r.numpy().tobytes() == \
                    ref[f"res{s}_{name}"][rank].tobytes(), (rank, s, name)
    # both ranks hold the same mean
    a, b = world["port"]
    assert all(torch.equal(x, y) for x, y in zip(a["psum"][0], b["psum"][0]))
