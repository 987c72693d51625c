"""The port's device-mesh query step on a multi-pod mesh against one data
axis and against the JAX package's.

The reference runs in a subprocess with eight forced host devices, the
port on a gloo world of four spawned CPU processes with two meshes over
it, (pod 2, data 2, model 1) and (data 4, model 1)
(``tests/test_torch_mesh.py`` holds the data, the reference's script and
the comparisons), on the four equal shards, in every mode.
"""

import json

import pytest
import torch

from repro_torch.core.device_index import query_step
from repro_torch.core.sharded_index import (make_sharded_query_step,
                                            shard_doc_offsets, stack_images,
                                            stacked_shard)

from test_torch_mesh import (MODES, _slices, assert_matches_reference,
                             assert_same, max_blocks, port_images, queries,
                             ref_answer, run_both)
from test_torch_mesh_config import _meshes


def _world_pod(rank: int, world: int, data_path: str, part: str) -> dict:
    """Four ranks: the equal shards on (pod 2, data 2, model 1) and on
    (data 4, model 1), every mode."""
    from pathlib import Path
    torch.set_num_threads(1)
    case = json.loads(Path(data_path).read_text())["eq"]
    ims = port_images(case)
    stacked, offs = stack_images(ims), shard_doc_offsets(ims)
    qt, qm = queries(case)
    out = {}
    for mname, mesh in _meshes().items():
        for mode in MODES:
            step = make_sharded_query_step(
                mesh, k=10, max_blocks=max_blocks(ims),
                num_docs=case["num_docs"], mode=mode)
            img, off = stacked_shard(stacked, offs, step.shard)
            out[f"eq__{mname}__{mode}"] = _slices(
                step.assemble(step(img, off, qt, qm)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = run_both(tmp_path_factory.mktemp("mesh_pod"), "pod", _world_pod, 4)
    return dict(r, b=r["port"][0])


def _merged(ims, offsets, order, mode, case):
    """Per-shard ``query_step`` tops merged in the shard ``order`` given,
    the lower position first among equal scores."""
    qt, qm = queries(case)
    ds, ss = [], []
    for s in order:
        d, sc = query_step(ims[s], qt, qm, k=10, mode=mode,
                           max_blocks=max_blocks(ims))
        ds.append(torch.where(d > 0, d + int(offsets[s]), 0))
        ss.append(sc)
    top_s, pos = torch.sort(torch.cat(ss, 1), dim=1, descending=True,
                            stable=True)
    return torch.gather(torch.cat(ds, 1), 1, pos[:, :10]), top_s[:, :10]


@pytest.mark.parametrize("mode", MODES)
def test_multipod_mesh_equals_one_data_axis(runs, mode):
    """(pod 2, data 2, model 1) gives the answer of (data 4, model 1): the
    per-shard tops merged shard-major, global docid ascending among equal
    scores.  The reference's multi-pod step gathers over "pod" then
    "data", so it concatenates the shards data-major (0, 2, 1, 3) and
    breaks cross-shard ties in that order: its answer equals the same
    tops merged in that order."""
    pod, flat = runs["b"][f"eq__2x2x1__{mode}"], runs["b"][f"eq__4x1__{mode}"]
    assert_same(mode, pod, flat)
    want = ref_answer(runs["ref"], f"eq__2x2x1__{mode}")
    case = runs["data"]["eq"]
    if mode == "conjunctive":
        assert_same(mode, pod, want)
        return
    ims = port_images(case)
    offs = shard_doc_offsets(ims).tolist()
    assert_same(mode, _merged(ims, offs, [0, 1, 2, 3], mode, case), pod)
    assert_matches_reference(mode, _merged(ims, offs, [0, 2, 1, 3], mode,
                                           case), want, case)
