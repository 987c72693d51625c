"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, against
the JAX package's ``src/repro/launch/dryrun.py``.

* The record of ``run_cell`` has every key of the reference's record
  (read from the reference's source), its ``memory`` every key of the
  reference's, and the port's own ``counted_by``, ``trace_s`` and
  ``whole_step``; the counts are finite and per rank.
* The reduced cells' per-rank ``argument_bytes`` equal the reference's
  ``memory_analysis()`` of the same cells lowered on a (2, 2) mesh with
  Auto axes over 4 of 8 forced host devices, and so do their aliased
  bytes; ``output_bytes`` equal XLA's less its tuple table (8 bytes a
  leaf where the outputs are a tuple, which the port's tensors have no
  counterpart of).  The port traces them on a fake world of 4 ranks.
* The LM probe cells: L = 2 less L = 1 per-rank flops equal a closed-form
  count of one layer's matmuls (written out in
  :func:`_layer_flops`), on a reduced llama3.2-3b over a (2, 2) fake mesh.
* ``collective_bytes`` of known redistributes gives the expected bytes by
  op and link bytes.
* ``_COLL_FACTOR`` and ``_DTYPE_BYTES`` equal the reference's.
* The CLI: ``--device cpu --probe`` exits 0 and writes two records; a
  rerun keeps them without ``--force``; a failing cell exits 1 with an
  ``error`` record.

Each fake world runs in a subprocess of its own (a process group is
process-wide), and so does the reference (it forces host devices).
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
REF_DRYRUN = SRC / "repro" / "launch" / "dryrun.py"
DEADLINE_S = 240.0

REDUCED = textwrap.dedent("""
    from dataclasses import replace
    def archs(common, get_arch, reduced_lm, dlrm_cls):
        common.LM_SHAPES.update(
            {"train_4k": dict(kind="train", seq=64, batch=4)})
        common.REC_SHAPES.update(
            {"train_batch": dict(batch=64, kind="train"),
             "serve_p99": dict(batch=32, kind="serve")})
        return {"lm": common.LMArch("llama3.2-3b", replace(
                    reduced_lm(get_arch("llama3.2-3b").cfg), microbatch=2)),
                "rec": common.RecsysArch("dlrm-mlperf", dlrm_cls(
                    table_rows=(4000,) * 26, embed_dim=16, n_dense=13,
                    bot_mlp=(32, 16), top_mlp=(64, 32, 1)), "dlrm")}
    CELLS = [("lm", "train_4k"), ("rec", "train_batch"),
             ("rec", "serve_p99")]
""")

REF_MEMORY = REDUCED + textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax
    from repro.configs import common, get_arch
    from repro.launch.train import reduced_lm
    from repro.models.recsys import DLRMConfig
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    a = archs(common, get_arch, reduced_lm, DLRMConfig)
    out = {}
    for fam, shape in CELLS:
        cell = a[fam].build(mesh, shape)
        ma = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                     donate_argnums=cell.donate_argnums).lower(
                         *cell.args).compile().memory_analysis()
        out[f"{fam}.{shape}"] = dict(
            argument_bytes=int(ma.argument_size_in_bytes),
            output_bytes=int(ma.output_size_in_bytes),
            alias_bytes=int(ma.alias_size_in_bytes))
    json.dump(out, open(sys.argv[1], "w"))
""")

PORT_CHECKS = REDUCED + textwrap.dedent("""
    import sys, json
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import common, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models.recsys import DLRMConfig

    out = {}
    a = archs(common, get_arch, reduced_lm, DLRMConfig)
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for fam, shape in CELLS:
            cell = a[fam].build(mesh, shape)
            out[f"{fam}.{shape}"] = dryrun.trace_cell(cell, mesh,
                                                      "cpu")["memory"]

        # the probe cells: a reduced llama3.2-3b at S = 512, B = 8
        common.LM_SHAPES.update(
            {"train_4k": dict(kind="train", seq=512, batch=8)})
        arch = common.LMArch("llama3.2-3b",
                             reduced_lm(get_arch("llama3.2-3b").cfg))
        out["probe"] = [dryrun.trace_cell(
            arch.build(mesh, "train_4k", probe_layers=p), mesh,
            "cpu")["hlo_flops"] for p in (1, 2)]
        cfg = arch.cfg
        out["cfg"] = dict(D=cfg.d_model, H=cfg.n_heads, KV=cfg.n_kv_heads,
                          dh=cfg.d_head, F=cfg.d_ff)

        # known redistributes of a (8, 16) float32 tensor
        fm = FakeTensorMode()
        tr = dryrun.Tracer()
        with fm:
            loc, ploc = torch.empty(4, 16), torch.empty(8, 16)
        x = DTensor.from_local(loc, mesh, (Shard(0), Replicate()),
                               run_check=False, shape=torch.Size((8, 16)),
                               stride=(16, 1))
        p = DTensor.from_local(ploc, mesh, (Replicate(), Partial()),
                               run_check=False, shape=torch.Size((8, 16)),
                               stride=(16, 1))
        with fm, tr:
            x.redistribute(mesh, (Replicate(), Replicate()))
            p.redistribute(mesh, (Replicate(), Replicate()))
            p.redistribute(mesh, (Replicate(), Shard(0)))
        out["colls"] = dryrun.collective_bytes(tr.colls)
    json.dump(out, open(sys.argv[1], "w"))
""")


def _ref_assignments() -> dict:
    """``_DTYPE_BYTES``, ``_COLL_FACTOR`` and the keys of the record that
    the reference's ``run_cell`` writes, read from its source (importing
    it would force 512 host devices on this process)."""
    tree_ = ast.parse(REF_DRYRUN.read_text())
    out: dict = {"record": set(), "memory": set()}
    for node in ast.walk(tree_):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            name = node.targets[0].id
            if name in ("_DTYPE_BYTES", "_COLL_FACTOR"):
                out[name] = ast.literal_eval(node.value)
            if name == "rec" and isinstance(node.value, ast.Dict):
                out["record"] |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"):
            out["record"] |= {k.arg for k in node.keywords}
            for k in node.keywords:
                if k.arg == "memory":
                    out["memory"] |= {m.arg for m in k.value.keywords}
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "rec"
                and isinstance(node.slice, ast.Constant)):
            out["record"].add(node.slice.value)
    return out


def _run(args, timeout=DEADLINE_S, **kw):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], env=env, timeout=timeout,
                          capture_output=True, text=True, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-c", REF_MEMORY, str(d / "ref.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "port": subprocess.Popen(
            [sys.executable, "-c", PORT_CHECKS, str(d / "port.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
             "cpu", "--arch", "sasrec", "--shape", "serve_p99", "--mesh",
             "both", "--out", str(d / "cells")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
    }
    try:
        for name, p in procs.items():
            _, err = p.communicate(timeout=DEADLINE_S)
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return dict(ref=json.loads((d / "ref.json").read_text()),
                port=json.loads((d / "port.json").read_text()),
                cells=d / "cells")


def test_constants_match_reference():
    from repro_torch.launch import dryrun
    ref = _ref_assignments()
    assert dryrun._DTYPE_BYTES == ref["_DTYPE_BYTES"]
    assert dryrun._COLL_FACTOR == ref["_COLL_FACTOR"]


@pytest.mark.parametrize("mesh_kind,chips", [("single", 256),
                                             ("multi", 512)])
def test_record_has_the_reference_keys(runs, mesh_kind, chips):
    ref = _ref_assignments()
    assert {"status", "kind", "chips", "hlo_flops", "collectives", "memory",
            "lower_s", "compile_s", "notes"} <= ref["record"]
    rec = json.loads((runs["cells"] / f"sasrec__serve_p99__{mesh_kind}.json"
                      ).read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert ref["record"] - {"error", "traceback"} <= set(rec)
    assert ref["memory"] == set(rec["memory"])
    assert {"counted_by", "trace_s", "whole_step"} <= set(rec)
    assert rec["whole_step"] is True and rec["chips"] == chips
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert set(rec["counted_by"]) == {"hlo_flops", "hlo_bytes",
                                      "collectives", "memory"}


@pytest.mark.parametrize("tag", ["lm.train_4k", "rec.train_batch",
                                 "rec.serve_p99"])
def test_memory_matches_reference(runs, tag):
    want, got = runs["ref"][tag], runs["port"][tag]
    assert got["argument_bytes"] == want["argument_bytes"]
    assert got["alias_bytes"] == want["alias_bytes"]
    # XLA's output size holds a table of 8-byte pointers, one per leaf,
    # where the outputs are a tuple (the train steps' 4-tuples)
    leaves = {"lm.train_4k": 39, "rec.train_batch": 36, "rec.serve_p99": 0}
    assert got["output_bytes"] + 8 * leaves[tag] == want["output_bytes"]


def _layer_flops(cfg: dict, B: int, S: int, mesh=(2, 2)) -> float:
    """One layer's matmul flops on one rank of a (data, model) mesh: the
    batch split over data, the projections and the FFN over model, the
    attention over this rank's heads in chunks of half the sequence (the
    probe's), three causal tiles; the backward pass twice the forward."""
    data, model = mesh
    D, H, KV, dh, F = cfg["D"], cfg["H"], cfg["KV"], cfg["dh"], cfg["F"]
    T = B // data * S
    proj = 2 * T * (D * H * dh + 2 * D * KV * dh + H * dh * D
                    + 3 * D * F) / model
    qc = max(256, S // 2)
    attn = (B // data) * (H // model) * 3 * 4 * qc * qc * dh
    return 3 * (proj + attn)


def test_probe_layer_flops_match_closed_form(runs):
    l1, l2 = runs["port"]["probe"]
    assert l2 - l1 == _layer_flops(runs["port"]["cfg"], B=8, S=512)


def test_collective_bytes_of_known_redistributes(runs):
    # all-gather of (4, 16) shards into (8, 16) float32: 512 B; an
    # all-reduce of the whole (8, 16) partial: 512 B, ring factor 2; the
    # partial reduce-scattered into (4, 16): 256 B
    got = runs["port"]["colls"]
    assert got["by_op"] == {"all-gather": 512.0, "all-reduce": 512.0,
                            "reduce-scatter": 256.0}
    assert got["link_bytes"] == 512.0 + 2 * 512.0 + 256.0


def test_cli_probe_writes_two_records_and_a_rerun_keeps_them(tmp_path):
    args = ["-m", "repro_torch.launch.dryrun", "--device", "cpu", "--arch",
            "llama3.2-3b", "--shape", "train_4k", "--probe", "--out",
            str(tmp_path)]
    first = _run(args)
    assert first.returncode == 0, first.stderr[-3000:]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["llama3.2-3b__train_4k__probe1.json",
                     "llama3.2-3b__train_4k__probe2.json"]
    recs = [json.loads((tmp_path / f).read_text()) for f in files]
    assert [r["probe_layers"] for r in recs] == [1, 2]
    assert all(r["status"] == "ok" for r in recs)
    assert recs[1]["hlo_flops"] > recs[0]["hlo_flops"]
    stamps = [(tmp_path / f).stat().st_mtime_ns for f in files]
    again = _run(args)
    assert again.returncode == 0
    assert [(tmp_path / f).stat().st_mtime_ns for f in files] == stamps


def test_cli_failing_cell_exits_1_with_an_error_record(tmp_path):
    got = _run(["-m", "repro_torch.launch.dryrun", "--device", "cpu",
                "--arch", "llama3.2-3b", "--shape", "no_such_shape",
                "--mesh", "single", "--out", str(tmp_path)])
    assert got.returncode == 1
    rec = json.loads((tmp_path / "llama3.2-3b__no_such_shape__single.json"
                      ).read_text())
    assert rec["status"] == "error" and "KeyError" in rec["error"]
    assert "traceback" in rec
