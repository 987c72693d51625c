"""The port's cell builds (``repro_torch.configs.common``: ``LMArch.build``,
``GNNArch.build``, ``RecsysArch.build``; ``IndexArch.build``) against the
JAX package's, on the CPU.

* **Structure.**  Every (arch × shape × mesh) cell, 86 of them, and the 40
  LM probe cells (5 LM configs × 4 shapes × L ∈ {1, 2}, single pod) are
  built by the reference on its production meshes over 512 forced host
  devices, and by the port on a fake world of 256 (single pod) or 512
  (multi-pod) ranks (``launch.mesh.fake_world``); each side runs in a
  subprocess of its own.  ``kind``, ``model_flops``, ``cost_scale``,
  ``notes``, ``donate_argnums`` and every argument leaf's path, shape and
  dtype must be equal, and so must each in-sharding, the port's DTensor
  placements turned back into a ``PartitionSpec``
  (``distributed.sharding.spec_of``).  paper_index's cells carry no
  in-shardings in the port (its step takes each rank's own shard), so
  theirs are not compared.
* **Numerics at reduced sizes.**  One train cell and one serve or decode
  cell of each family whose build has both (the GNN has train cells
  alone): llama3.2-3b reduced (``reduced_lm``, float32, two microbatches)
  at train_4k and decode_32k cut to 4 × 64; SchNet at molecule cut to
  300 nodes and 900 edges (padded to 512 and 1,024); DLRM with 26 fields
  of 4,000 rows (a fused table of 104,448 rows, so it is row-sharded) at
  train_batch cut to 64 and serve_p99 cut to 32.  The reference runs its
  ``cell.fn`` jitted with the cell's in-shardings on a (2, 2) mesh with
  Auto axes (C2) over 4 of 8 forced host devices; the port runs its
  ``cell.fn`` on a gloo world of 4 CPU ranks (data 2 × model 2), its
  arguments the reference's (parameters from the reference's init,
  inputs from a numpy seed) distributed by the cell's placements.
  Tolerances, float32: outputs, losses, global norms, caches and the
  AdamW moments within rtol ``RTOL`` = 1e-5, atol ``ATOL`` = 1e-6; the
  updated parameters the same wherever the element's first moment is at
  least ``MU_FLOOR`` = 1e-3 of its leaf's largest (where it is smaller
  the gradient lies within rounding of zero, its sign may differ between
  two summation orders, and AdamW's first step moves the parameter by up
  to ``lr`` either way).
* **``mesh=None``.**  The functions given ``mesh=None`` compute what they
  compute called without it, bit for bit, on plain tensors.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import launch

SRC = Path(__file__).resolve().parents[1] / "src"
DEADLINE_S = 240.0
RTOL, ATOL = 1e-5, 1e-6
MU_FLOOR = 1e-3

CELLS = [(a, s, m, None) for m in ("single", "multi") for a in ARCH_IDS
         for s in get_arch(a).shapes]
CELLS += [(a, s, "single", pl) for a in ARCH_IDS
          if get_arch(a).family == "lm" for s in get_arch(a).shapes
          for pl in (1, 2)]


def _cell_id(c) -> str:
    a, s, m, pl = c
    return f"{a}-{s}-{m}" + ("" if pl is None else f"-probe{pl}")


# the description of a cell, the same code on both sides (``jax`` and
# ``torch`` fill in the leaves)
DESCRIBE = textwrap.dedent("""
    def norm_spec(spec):
        out = []
        for e in spec:
            if isinstance(e, (tuple, list)):
                e = list(e)
                e = e[0] if len(e) == 1 else e
            out.append(e)
        while out and out[-1] is None:
            out.pop()
        return out

    def describe(cell, leaves_of, spec_list):
        return {"kind": cell.kind, "model_flops": float(cell.model_flops),
                "cost_scale": float(getattr(cell, "cost_scale", 1.0)),
                "notes": cell.notes,
                "donate": list(getattr(cell, "donate_argnums", ())),
                "args": [leaves_of(a) for a in cell.args],
                "specs": spec_list(cell)}
""")

REF_STRUCTURE = DESCRIBE + textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from repro.configs import get_arch
    from repro.launch.mesh import make_production_mesh

    def leaves_of(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return [["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path), list(x.shape), str(x.dtype)]
                for path, x in flat]

    def spec_list(cell):
        if cell.arch_id == "paper-index":
            return None
        return [[norm_spec(tuple(s.spec)) for s in jax.tree.leaves(arg)]
                for arg in cell.in_shardings]

    cells = json.loads(sys.argv[2])
    meshes = {m: make_production_mesh(multi_pod=(m == "multi"))
              for m in ("single", "multi")}
    out = {}
    for a, s, m, pl in cells:
        arch = get_arch(a)
        cell = (arch.build(meshes[m], s) if pl is None
                else arch.build(meshes[m], s, probe_layers=pl))
        out[f"{a}|{s}|{m}|{pl}"] = describe(cell, leaves_of, spec_list)
    json.dump(out, open(sys.argv[1], "w"))
""")

PORT_STRUCTURE = DESCRIBE + textwrap.dedent("""
    import sys, json
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import spec_of
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    def leaves_of(t):
        return [[n, list(x.shape), str(x.dtype).replace("torch.", "")]
                for n, x in zip(tree.path_names(t), tree.leaves(t))]

    cells = json.loads(sys.argv[2])
    out = {}
    for m, world in (("single", 256), ("multi", 512)):
        with fake_world(world):
            mesh = make_production_mesh(multi_pod=(m == "multi"),
                                        device_type="cpu")

            def spec_list(cell):
                if not hasattr(cell, "in_shardings"):
                    return None
                return [[norm_spec(spec_of(pl, x.dim(), mesh))
                         for pl, x in zip(pls, tree.leaves(arg))]
                        for pls, arg in zip(cell.in_shardings, cell.args)]

            for a, s, mk, pl in cells:
                if mk != m:
                    continue
                arch = get_arch(a)
                cell = (arch.build(mesh, s) if pl is None
                        else arch.build(mesh, s, probe_layers=pl))
                out[f"{a}|{s}|{m}|{pl}"] = describe(cell, leaves_of,
                                                    spec_list)
    json.dump(out, open(sys.argv[1], "w"))
""")

# --------------------------------------------------------------------------
# the reduced cells, as both packages build them
# --------------------------------------------------------------------------

REDUCED = textwrap.dedent("""
    LM_SHAPES = {"train_4k": dict(kind="train", seq=64, batch=4),
                 "decode_32k": dict(kind="decode", seq=64, batch=4)}
    GNN_SHAPES = {"molecule": dict(n_nodes=300, n_edges=900, d_feat=16,
                                   classify=0, n_graphs=8, kind="train")}
    REC_SHAPES = {"train_batch": dict(batch=64, kind="train"),
                  "serve_p99": dict(batch=32, kind="serve")}
    DLRM = dict(table_rows=(4000,) * 26, embed_dim=16, n_dense=13,
                bot_mlp=(32, 16), top_mlp=(64, 32, 1))
    CELLS = [("lm", "train_4k"), ("lm", "decode_32k"), ("gnn", "molecule"),
             ("rec", "train_batch"), ("rec", "serve_p99")]

    def reduced_archs(common, lm_cfg, reduced_lm, gnn_cfg, dlrm_cls, rep):
        common.LM_SHAPES.update(LM_SHAPES)
        common.GNN_SHAPES.update(GNN_SHAPES)
        common.REC_SHAPES.update(REC_SHAPES)
        return {"lm": common.LMArch("llama3.2-3b",
                                    rep(reduced_lm(lm_cfg), microbatch=2)),
                "gnn": common.GNNArch("schnet", gnn_cfg),
                "rec": common.RecsysArch("dlrm-mlperf", dlrm_cls(**DLRM),
                                         "dlrm")}
""")

REF_NUMERICS = REDUCED + textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from dataclasses import replace
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import common, get_arch
    from repro.launch.train import reduced_lm
    from repro.models import gnn as gnn_mod, lm as lm_mod
    from repro.models.recsys import DLRMConfig
    from repro.optim import adamw_init

    def names(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path) for path, _ in flat]

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    archs = reduced_archs(common, get_arch("llama3.2-3b").cfg, reduced_lm,
                          get_arch("schnet").base_cfg, DLRMConfig, replace)
    rng = np.random.default_rng(0)
    out = {}
    for fam, shape in CELLS:
        arch = archs[fam]
        cell = arch.build(mesh, shape)
        key = jax.random.PRNGKey(0)
        if fam == "lm":
            params = lm_mod.init_params(arch.cfg, key)
        elif fam == "gnn":
            params = gnn_mod.init_params(arch.cfg_for(shape), key)
        else:
            params = arch._init(key)
        args = [params]
        for spec in cell.args[1:]:
            if hasattr(spec, "mu"):                   # the AdamW state
                args.append(adamw_init(params))
                continue
            def make(x, path):
                n = path.split("/")[-1]
                if n in ("tokens", "labels"):
                    return rng.integers(0, arch.cfg.vocab, x.shape)
                if n in ("src", "dst"):
                    return rng.integers(0, GNN_SHAPES["molecule"]["n_nodes"],
                                        x.shape)
                if n == "graph_ids":
                    return rng.integers(0, 8, x.shape)
                if n == "sparse":
                    return rng.integers(0, 4000, x.shape)
                if n in ("edge_mask",):
                    return rng.random(x.shape) < 0.9
                if n in ("node_mask", "label"):
                    return (rng.random(x.shape) < 0.8).astype(np.float32)
                if x.dtype == jnp.int32:              # the decode token
                    return rng.integers(0, arch.cfg.vocab, x.shape)
                return rng.standard_normal(x.shape).astype(np.float32)
            flat, tdef = jax.tree_util.tree_flatten_with_path(spec)
            vals = [jnp.asarray(make(x, "/".join(
                str(getattr(k, "key", getattr(k, "idx", k))) for k in p)),
                x.dtype) for p, x in flat]
            args.append(jax.tree_util.tree_unflatten(tdef, vals))
        tag = f"{fam}.{shape}"
        for i, a in enumerate(args):
            for n, x in zip(names(a), jax.tree.leaves(a)):
                out[f"{tag}|arg{i}|{n}"] = np.asarray(x)
        res = jax.jit(cell.fn, in_shardings=cell.in_shardings)(*args)
        for n, x in zip(names(res), jax.tree.leaves(res)):
            out[f"{tag}|out|{n}"] = np.asarray(x)
    np.savez(sys.argv[1], **out)
""")


def _port_numerics(rank: int, world: int, ref_path: str) -> dict:
    """One rank of the port's reduced cells on a (2, 2) gloo mesh; rank 0
    returns every output leaf, gathered whole, by name."""
    from dataclasses import replace

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch import tree
    from repro_torch.configs import common
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models.recsys import DLRMConfig

    torch.set_num_threads(1)
    scope: dict = {}
    exec(REDUCED, scope)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    archs = scope["reduced_archs"](
        common, get_arch("llama3.2-3b").cfg, reduced_lm,
        get_arch("schnet").base_cfg, DLRMConfig, replace)
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    out = {}
    for fam, shape in scope["CELLS"]:
        cell = archs[fam].build(mesh, shape)
        tag = f"{fam}.{shape}"
        args = []
        for i, (arg, pls) in enumerate(zip(cell.args, cell.in_shardings)):
            flat, treedef = tree.flatten(arg)
            vals = []
            for name, x, pl in zip(tree.path_names(arg), flat, pls):
                full = torch.from_numpy(ref[f"{tag}|arg{i}|{name}"]).to(
                    x.dtype).reshape(x.shape)
                vals.append(distribute_tensor(full, mesh, pl))
            args.append(tree.unflatten(treedef, vals))
        res = cell.fn(*args)
        for name, x in zip(tree.path_names(res), tree.leaves(res)):
            full = x.full_tensor() if isinstance(x, DTensor) else x
            out[f"{tag}|out|{name}"] = full.detach().numpy().copy()
    return out if rank == 0 else {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both structure runs and both numerics runs: the reference's
    subprocesses and the port's fake world run side by side, then the
    port's gloo world on the reference's arguments."""
    d = tmp_path_factory.mktemp("arch_build")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cells = json.dumps(CELLS)
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-c", REF_STRUCTURE, str(d / "ref.json"),
             cells], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-c", PORT_STRUCTURE, str(d / "port.json"),
             cells], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "num": subprocess.Popen(
            [sys.executable, "-c", REF_NUMERICS, str(d / "num.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
    }
    out = {}
    try:
        for name, p in procs.items():
            _, err = p.communicate(timeout=DEADLINE_S)
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
        out["ref"] = json.loads((d / "ref.json").read_text())
        out["port"] = json.loads((d / "port.json").read_text())
        with np.load(d / "num.npz") as z:
            out["num_ref"] = {k: z[k] for k in z.files}
        out["num_port"] = launch(_port_numerics, 4, backend="gloo",
                                 store_dir=d, args=(str(d / "num.npz"),),
                                 deadline_s=DEADLINE_S)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("cell", CELLS, ids=[_cell_id(c) for c in CELLS])
def test_cell_structure_matches_reference(runs, cell):
    key = "|".join(str(x) for x in cell)
    want, got = runs["ref"][key], runs["port"][key]
    for field in ("kind", "model_flops", "cost_scale", "notes", "donate"):
        assert got[field] == want[field], field
    assert got["args"] == want["args"]
    assert got["specs"] == want["specs"]      # None for paper_index


def test_every_cell_is_counted():
    assert len([c for c in CELLS if c[3] is None]) == 86
    assert len([c for c in CELLS if c[3] is not None]) == 40


NUMERIC = ["lm.train_4k", "lm.decode_32k", "gnn.molecule",
           "rec.train_batch", "rec.serve_p99"]


@pytest.mark.parametrize("tag", NUMERIC)
def test_reduced_cell_matches_reference(runs, tag):
    ref = {k.split("|", 2)[2]: v for k, v in runs["num_ref"].items()
           if k.startswith(f"{tag}|out|")}
    got = {k.split("|", 2)[2]: v for k, v in runs["num_port"].items()
           if k.startswith(f"{tag}|out|")}
    assert sorted(got) == sorted(ref)
    train = not tag.endswith(("decode_32k", "serve_p99"))
    for name, want in ref.items():
        have = got[name]
        assert have.shape == want.shape, name
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(have, want, err_msg=name)
            continue
        if train and name.startswith("0/"):       # an updated parameter
            mu = np.abs(ref[f"1/.mu/{name[2:]}"])
            keep = mu >= MU_FLOOR * max(float(mu.max()), 1e-30)
            np.testing.assert_allclose(have[keep], want[keep], rtol=RTOL,
                                       atol=ATOL, err_msg=name)
            continue
        np.testing.assert_allclose(have, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("fam", ["lm", "gnn", "rec"])
def test_mesh_none_is_the_plain_call(fam):
    """``mesh=None`` computes, bit for bit, what the call without it
    computes (plain tensors, the single-device port)."""
    from dataclasses import replace

    from repro_torch.launch.train import reduced_lm
    from repro_torch.models import gnn as tgnn, lm as tlm, recsys as trec
    from repro_torch.models.gnn import input_specs

    g = torch.Generator().manual_seed(0)
    if fam == "lm":
        cfg = replace(reduced_lm(get_arch("llama3.2-3b").cfg), microbatch=2)
        p = tlm.init_params(cfg, "cpu", g)
        tok = torch.randint(0, cfg.vocab, (4, 64), generator=g)
        b = {"tokens": tok, "labels": tok.roll(1, 1)}
        assert torch.equal(tlm.lm_loss(p, b, cfg),
                           tlm.lm_loss(p, b, cfg, mesh=None))
        c1 = {k: torch.zeros(2, 4, 64, 64) for k in ("k", "v")}
        c2 = {k: torch.zeros(2, 4, 64, 64) for k in ("k", "v")}
        l1, _ = tlm.make_serve_step(cfg)(p, c1, tok[:, 0], 5)
        l2, _ = tlm.make_serve_step(cfg, None)(p, c2, tok[:, 0], 5)
        assert torch.equal(l1, l2) and torch.equal(c1["k"], c2["k"])
    elif fam == "gnn":
        cfg = replace(get_arch("schnet").base_cfg, edge_chunk=256)
        p = tgnn.init_params(cfg, "cpu", g)
        specs = input_specs(cfg, 64, 512, n_graphs=4)
        b = {k: (torch.randint(0, 4 if k == "graph_ids" else 64, v.shape,
                               generator=g).to(v.dtype)
                 if v.dtype in (torch.int32, torch.bool)
                 else torch.rand(v.shape, generator=g))
             for k, v in specs.items()}
        assert torch.equal(tgnn.graph_loss(p, b, cfg, 4),
                           tgnn.graph_loss(p, b, cfg, 4, mesh=None))
    else:
        cfg = trec.DLRMConfig(table_rows=(50, 30, 7), embed_dim=8,
                              bot_mlp=(16, 8), top_mlp=(32, 16, 1))
        p = trec.dlrm_init(cfg, "cpu", g)
        b = {"dense": torch.rand(16, 13, generator=g),
             "sparse": torch.randint(0, 30, (16, 3), generator=g),
             "label": torch.rand(16, generator=g)}
        assert torch.equal(trec.dlrm_loss(p, b, cfg),
                           trec.dlrm_loss(p, b, cfg, mesh=None))
