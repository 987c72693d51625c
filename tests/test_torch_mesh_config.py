"""The port's ``configs/paper_index.py`` and mesh constructors against
the JAX package's.

The reference runs in a subprocess with eight forced host devices, the
port on a gloo world of four spawned CPU processes
(``tests/test_torch_mesh.py`` holds the data, the reference's script and
the comparisons).  Cases: ``INDEX_SHAPES`` and ``IndexArch.flops``;
``build`` at reduced sizes on (data 4, model 1), its answer against the
reference's; the stand-in input specs of (pod 2, data 2, model 1) and
(data 4, model 1); the production meshes' shapes and axes.
"""

import json
from unittest import mock

import pytest
import torch

from repro_torch.configs import paper_index
from repro_torch.core.sharded_index import (shard_doc_offsets,
                                            sharded_input_specs,
                                            stack_images, stacked_shard)
from repro_torch.launch import make_host_mesh
from repro_torch.launch import mesh as mesh_mod

from test_torch_mesh import (PAD_VOCAB, REDUCED, _slices,
                             assert_matches_reference, port_images, queries,
                             ref_answer, run_both)


def _specs(mesh) -> list:
    return [[list(x.shape), str(x.dtype).replace("torch.", "")]
            for x in sharded_input_specs(mesh, shard_blocks=512, B=64,
                                         vocab=128, qbatch=8, qterms=4)]


def _meshes() -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    return {"2x2x1": init_device_mesh(mesh_mod.mesh_device_type(),
                                      (2, 2, 1), mesh_dim_names=(
                                          "pod", "data", "model")),
            "4x1": make_host_mesh(model=1)}


def _world_config(rank: int, world: int, data_path: str, part: str) -> dict:
    """Four ranks: the input specs of (pod 2, data 2, model 1) and (data
    4, model 1), and the reduced builds on (data 4, model 1)."""
    from pathlib import Path
    torch.set_num_threads(1)
    case = json.loads(Path(data_path).read_text())["eq"]
    meshes = _meshes()
    out = {f"specs__{m}": _specs(mesh) for m, mesh in meshes.items()}
    ims = port_images(case, PAD_VOCAB, pad_blocks=512)
    stacked, offs = stack_images(ims), shard_doc_offsets(ims)
    qt, qm = queries(case)
    with mock.patch.dict(paper_index.INDEX_SHAPES, REDUCED):
        for sid in REDUCED:
            cell = paper_index.ARCH.build(meshes["4x1"], sid)
            img, off = stacked_shard(stacked, offs, cell.fn.shard)
            out[f"build__{sid}"] = _slices(
                cell.fn.assemble(cell.fn(img, off, qt, qm)))
            out[f"build__{sid}__meta"] = dict(
                args=[[list(x.shape), str(x.dtype).replace("torch.", "")]
                      for x in cell.args],
                stacked=[list(stacked.blocks.shape),
                         list(stacked.term_slot.shape)],
                flops=cell.model_flops, notes=cell.notes, kind=cell.kind,
                arch=cell.arch_id, shape=cell.shape_id)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = run_both(tmp_path_factory.mktemp("mesh_config"), "config",
                 _world_config, 4)
    return dict(r, b=r["port"][0])


@pytest.mark.parametrize("shape_id", sorted(paper_index.INDEX_SHAPES))
def test_index_shapes_and_flops_match_reference(runs, shape_id):
    ref = runs["ref"]
    shapes = json.loads(str(ref["index_shapes"]))
    assert set(shapes) == set(paper_index.INDEX_SHAPES)
    assert paper_index.INDEX_SHAPES[shape_id] == shapes[shape_id]
    assert (paper_index.ARCH.flops(shape_id)
            == json.loads(str(ref["flops"]))[shape_id])
    arch = paper_index.ARCH
    assert [arch.arch_id, arch.family, list(arch.shapes)] == json.loads(
        str(ref["arch"]))


@pytest.mark.parametrize("shape_id", sorted(REDUCED))
def test_build_at_reduced_sizes_matches_reference(runs, shape_id):
    """``build`` with the shapes cut (vocabulary 128, 512 blocks a shard,
    8 queries of 4 terms, 2 blocks a chain): the same stand-in shapes,
    flops and notes, and the same answer on the stacked images."""
    ref = runs["ref"]
    got = runs["b"][f"build__{shape_id}__meta"]
    want = json.loads(str(ref[f"build__{shape_id}__meta"]))
    assert got["args"] == want["args"]
    assert got["stacked"] == [want["args"][0][0], want["args"][1][0]]
    for key in ("flops", "notes", "kind", "arch", "shape"):
        assert got[key] == want[key]
    mode = REDUCED[shape_id].get("mode", "ranked_sparse")
    case = dict(runs["data"]["eq"], num_docs=REDUCED[shape_id]["docs"])
    assert_matches_reference(mode, runs["b"][f"build__{shape_id}"],
                             ref_answer(ref, f"build__{shape_id}"), case,
                             REDUCED[shape_id]["max_blocks"])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_and_axes(runs, multi_pod):
    made = []
    with mock.patch.object(mesh_mod, "init_device_mesh",
                           lambda dev, shape, mesh_dim_names: made.append(
                               [dev, list(shape), list(mesh_dim_names)])), \
            mock.patch.object(mesh_mod, "mesh_device_type",
                              return_value="cuda"):
        mesh_mod.make_production_mesh(multi_pod=multi_pod)
    want = json.loads(str(runs["ref"]["production"]))[int(multi_pod)]
    assert made == [["cuda"] + want]


@pytest.mark.parametrize("mesh_name", ["4x1", "2x2x1"])
def test_input_specs_match_reference(runs, mesh_name):
    assert runs["b"][f"specs__{mesh_name}"] == json.loads(
        str(runs["ref"][f"specs__{mesh_name}"]))
