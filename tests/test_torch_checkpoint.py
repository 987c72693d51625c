"""The port's checkpoint manager (``repro_torch.checkpoint``) and its
pytree order (``repro_torch.tree``) against the JAX package's, on the CPU.

* The reference's ``TestCheckpointManager`` cases
  (``tests/test_trainer_checkpoint.py:43-120``), mirrored, each with numpy
  leaves (as the reference's) and with tensor leaves.
* Checkpoints cross between the packages: a ``(params, AdamWState)`` tree
  with float32 and bfloat16 leaves written by each package is restored by
  the other, every leaf equal bit for bit; the two packages write the same
  bytes for the same tree.
* The reference's quirk C3 is pinned: its restore hands back a bfloat16
  leaf as a raw ``V2`` array (JAX refuses it), the port's as a bfloat16
  tensor.
* An async save copies the leaves on the caller's thread: tensors changed
  in place right after ``save`` returns are saved as they were.

Everything is compared exactly; no tolerance applies.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.optim import adamw_init as jadamw_init
from repro_torch import convert, tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import adamw_init


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread is faster, and the test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["numpy", "tensor"])
def leaf(request):
    """How a test's leaves are made: numpy arrays (the reference's tests)
    or CPU tensors."""
    if request.param == "numpy":
        return np.asarray
    return lambda a: torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TestCheckpointManager:
    def test_atomic_publish_and_restore(self, tmp_path, leaf):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        tree_ = {"a": leaf(np.arange(5)), "b": {"c": leaf(np.ones((2, 3)))}}
        mgr.save(7, tree_)
        assert mgr.latest_step() == 7
        back = mgr.restore(7, like=tree_)
        np.testing.assert_array_equal(_np(back["a"]), _np(tree_["a"]))
        np.testing.assert_array_equal(_np(back["b"]["c"]),
                                      _np(tree_["b"]["c"]))
        assert type(back["a"]) is type(tree_["a"])

    def test_retention(self, tmp_path, leaf):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"x": leaf(np.asarray([s]))})
        assert mgr.all_steps() == [3, 4]

    def test_async_save(self, tmp_path, leaf):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": leaf(np.arange(10))}, blocking=False)
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_tmp_dir_never_published(self, tmp_path, leaf):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, {"x": leaf(np.arange(3))})
        assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))

    def test_async_then_blocking_same_step(self, tmp_path, leaf):
        """A blocking save must join an in-flight async save instead of
        racing it in the staging area (FileExistsError)."""
        mgr = CheckpointManager(str(tmp_path), keep=2)
        tree_ = {"x": leaf(np.arange(20000))}
        for step in range(3, 9):
            mgr.save(step, tree_, blocking=False)
            mgr.save(step, {"x": leaf(np.arange(20000) + step)},
                     blocking=True)
        mgr.wait()
        assert mgr.latest_step() == 8
        np.testing.assert_array_equal(_np(mgr.restore(8, like=tree_)["x"]),
                                      np.arange(20000) + 8)
        assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))

    def test_interleaved_async_blocking_distinct_steps(self, tmp_path, leaf):
        mgr = CheckpointManager(str(tmp_path), keep=3)
        for step in range(1, 7):
            mgr.save(step, {"x": leaf(np.asarray([step]))},
                     blocking=(step % 2 == 0))
        mgr.wait()
        assert mgr.all_steps() == [4, 5, 6]

    def test_keep_zero_retains_newest(self, tmp_path, leaf):
        """keep=0 must never delete the newest complete checkpoint."""
        mgr = CheckpointManager(str(tmp_path), keep=0)
        for s in (1, 2, 3):
            mgr.save(s, {"x": leaf(np.asarray([s]))})
        assert mgr.all_steps() == [3]
        assert mgr.latest_step() == 3

    def test_negative_keep_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            CheckpointManager(str(tmp_path), keep=-1)

    def test_crashed_staging_dirs_swept_at_next_publish(self, tmp_path,
                                                        leaf):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": leaf(np.arange(3))})
        # a crash mid-save leaves an orphaned staging dir
        (tmp_path / ".tmp-7-3").mkdir()
        (tmp_path / ".tmp-7-3" / "leaf-0.npy").write_bytes(b"partial")
        # restore-only instances must not sweep (they could race an active
        # writer's in-flight staging dir)
        reader = CheckpointManager(str(tmp_path))
        assert reader.latest_step() == 1
        assert (tmp_path / ".tmp-7-3").exists()
        # the writer's next publish reclaims the orphan
        mgr.save(2, {"x": leaf(np.arange(3))})
        assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))
        assert mgr.all_steps() == [1, 2]


# --------------------------------------------------------------------------
# the tree order
# --------------------------------------------------------------------------


def _state_tree(dtype, opt_dtype, rng):
    """A (params, AdamWState) tree as numpy arrays: dict keys out of
    sorted order, nested dicts, moments of ``opt_dtype``."""
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "layers": {"wq": rng.standard_normal((2, 4, 4)),
                         "ln1": rng.standard_normal((2, 4))},
              "b": rng.standard_normal(5)}
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    js = jadamw_init(jp, state_dtype=opt_dtype)
    js = js._replace(step=jnp.int32(7),
                     mu=jax.tree.map(lambda a: a + 0.5, js.mu),
                     nu=jax.tree.map(lambda a: a + 0.25, js.nu))
    return jp, js


@pytest.mark.parametrize("obj", [
    {"b": 1, "a": {"y": 2, "x": 3}},
    [1, (2, None), {"k": 3}],
    (1,),
    {},
    (),
    np.arange(3),
])
def test_flatten_order_and_treedef_match_jax(obj):
    leaves, tdef = tree.flatten(obj)
    jleaves, jdef = jax.tree.flatten(obj)
    assert len(leaves) == len(jleaves)
    assert all(np.array_equal(a, b) for a, b in zip(leaves, jleaves))
    assert tree.treedef_str(tdef) == str(jdef)
    assert tree.tree_map(lambda x: x, obj).__class__ is obj.__class__


def test_flatten_of_params_and_adamw_state_matches_jax():
    jp, js = _state_tree(jnp.float32, jnp.float32,
                         np.random.default_rng(0))
    tp = tree.tree_map(lambda a: torch.from_numpy(np.array(a)),
                       jax.tree.map(np.asarray, jp))
    ts = adamw_init(tp)
    leaves, tdef = tree.flatten((tp, ts))
    jleaves, jdef = jax.tree.flatten((jp, js))
    assert tree.treedef_str(tdef) == str(jdef)
    assert [tuple(t.shape) for t in leaves] == \
        [tuple(a.shape) for a in jleaves]
    rebuilt = tree.unflatten(tdef, leaves)
    assert rebuilt[0]["layers"]["wq"] is tp["layers"]["wq"]
    assert type(rebuilt[1]) is type(ts)
    with pytest.raises(ValueError):
        tree.unflatten(tdef, leaves + [leaves[0]])


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------


def _bits(x):
    """A leaf's bits as an unsigned integer array (bf16 from either
    package: an ml_dtypes array, a V2 array or a tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[x.dtype.itemsize])


@pytest.mark.parametrize("dtype,opt_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_checkpoints_cross_between_the_packages(tmp_path, dtype, opt_dtype):
    """Each package restores the other's checkpoint of (params,
    AdamWState), every leaf equal bit for bit, and both write the same
    bytes and manifest for the same tree."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    jp, js = _state_tree(jdt[dtype], jdt[opt_dtype],
                         np.random.default_rng(1))
    host = jax.tree.map(np.asarray, (jp, js))
    tp = tree.tree_map(lambda a: convert._leaf(a).clone(), host[0])
    ts = convert.adamw_from_jax(host[1], device="cpu")
    assert ts.step.dtype == torch.int32 and int(ts.step) == 7
    JaxManager(str(tmp_path / "jax")).save(3, (jp, js))
    CheckpointManager(str(tmp_path / "torch")).save(3, (tp, ts))

    # the port restores the reference's checkpoint, bf16 as bf16
    fresh = (tree.tree_map(torch.zeros_like, tp), adamw_init(
        tp, state_dtype=getattr(torch, opt_dtype)))
    back = CheckpointManager(str(tmp_path / "jax")).restore(3, like=fresh)
    for got, want in zip(tree.leaves(back), jax.tree.leaves(host)):
        assert isinstance(got, torch.Tensor)
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        assert np.array_equal(_bits(got), _bits(want))

    # the reference restores the port's checkpoint (bf16 as its raw V2)
    jback = JaxManager(str(tmp_path / "torch")).restore(3)
    assert len(jback) == len(jax.tree.leaves(host))
    for got, want in zip(jback, jax.tree.leaves(host)):
        assert np.array_equal(_bits(got), _bits(want))

    # the same files
    a, b = tmp_path / "jax" / "step-0000000003", \
        tmp_path / "torch" / "step-0000000003"
    assert json.loads((a / "manifest.json").read_text()) == \
        json.loads((b / "manifest.json").read_text())
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        if n.endswith(".npy"):
            assert filecmp.cmp(a / n, b / n, shallow=False), n


def test_c3_reference_restores_bf16_as_raw_bytes_the_port_as_bf16(tmp_path):
    """The reference's quirk C3: its restore of a bfloat16 leaf is a raw
    ``V2`` array, which JAX refuses; the port's is a bfloat16 tensor."""
    leaf = jnp.asarray([1.5, -2.0, 3.25], jnp.bfloat16)
    JaxManager(str(tmp_path)).save(1, {"w": leaf})
    jback = JaxManager(str(tmp_path)).restore(1, like={"w": leaf})["w"]
    assert jback.dtype.kind == "V" and jback.dtype.itemsize == 2
    with pytest.raises(TypeError):
        jnp.asarray(jback)
    tback = CheckpointManager(str(tmp_path)).restore(
        1, like={"w": torch.zeros(3, dtype=torch.bfloat16)})["w"]
    assert tback.dtype == torch.bfloat16
    assert tback.tolist() == [1.5, -2.0, 3.25]
    spec = json.loads((tmp_path / "step-0000000001" /
                       "manifest.json").read_text())
    assert spec["leaves"] == [{"shape": [3], "dtype": "bfloat16"}]


def test_async_save_copies_before_the_next_in_place_step(tmp_path):
    """Leaves changed in place right after an async save returns are
    saved as they were when it was called."""
    p = {"w": torch.arange(200_000, dtype=torch.float32),
         "h": torch.ones(1000, dtype=torch.bfloat16)}
    want = tree.tree_map(lambda t: t.clone(), p)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, p, blocking=False)
    p["w"].mul_(-1)
    p["h"].add_(1)
    mgr.wait()
    back = mgr.restore(5, like=p)
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(back), tree.leaves(want)))


def test_restore_without_like_is_a_flat_list(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"b": torch.zeros(2, dtype=torch.bfloat16),
                 "a": np.arange(3, dtype=np.int64)})
    got = mgr.restore(2)
    assert [t.dtype for t in got] == [torch.int64, torch.bfloat16]
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(2, like={"a": torch.zeros(3)})
