"""The port's device-mesh query step against the JAX package's on shards
of unequal sizes, [150, 90, 140, 60], with global statistics: each image's
``term_ft`` rebased to the summed f_t, the step's N the collection total
(the reference's recipe, ``tests/test_sharded_index.py``).

The reference runs in a subprocess with eight forced host devices, the
port on a gloo world of eight spawned CPU processes, a (data 4, model 2)
mesh (``tests/test_torch_mesh.py`` holds the data, the script and the
comparisons): every mode against the reference, each rank's model slice,
``stack_images`` and ``shard_doc_offsets`` with their padding, and
``sharded_query_plain`` against the distributed step.
"""

import pytest

from test_torch_mesh import (MODES, _world_steps, check_matches_reference,
                             check_model_slices, check_plain, check_stack,
                             run_both)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = run_both(tmp_path_factory.mktemp("mesh_unequal"), "uneq",
                 _world_steps, 8)
    return dict(r, a=r["port"][0], ranks=[x["slices"] for x in r["port"]])


@pytest.mark.parametrize("mode", MODES)
def test_mesh_step_matches_reference(runs, mode):
    check_matches_reference(runs, "uneq", mode)


@pytest.mark.parametrize("mode", MODES)
def test_each_rank_returns_its_model_slice(runs, mode):
    check_model_slices(runs, "uneq", mode)


def test_stack_images_and_offsets_match_reference(runs):
    check_stack(runs, "uneq")


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_equals_distributed_step(runs, mode):
    check_plain(runs, "uneq", mode)
