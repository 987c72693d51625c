"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX package's (``repro.optim``), on the CPU.

The same seeded gradients (numpy) go into both packages' AdamW for several
steps: float32 and bfloat16 parameters, float32 and bfloat16 moments, the
gradient's global norm above and below the clip.  Tolerances, as a maximum
absolute difference over the largest |value| of the reference's leaf:

* float32 leaves: ``F32_TOL`` = 1e-6.  Both packages compute the same
  float32 arithmetic; the global norm sums each leaf in another order
  (XLA's and PyTorch's reductions), and XLA's and PyTorch's ``pow`` for
  the bias correction may differ in the last ulp.  Measured: 3.4e-7.
* bfloat16 leaves: ``BF16_TOL`` = 2^-7, one bfloat16 ulp of the largest
  value: an element whose float32 value lies within an ulp of a rounding
  boundary may round to the other neighbour in the other package
  (measured: 0, the same bits).

The port's update runs in place: the tests check that it returns the
tensors it was given.  The reference's ``TestOptim`` cases
(``tests/test_substrates.py:55-95``) are mirrored at the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch import tree
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedules as tsched

F32_TOL = 1e-6
BF16_TOL = 2.0 ** -7
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = {"w": (6, 5, 4), "b": {"z": (7,), "a": (3, 9)}, "e": (11, 8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread is faster, and the test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(rng, scale=1.0):
    """A tree of float32 numpy arrays of SHAPES, keys in insertion order
    unlike JAX's sorted order, so the leaf order is tested too."""
    return {"w": rng.standard_normal(SHAPES["w"]).astype(np.float32) * scale,
            "b": {"z": rng.standard_normal(7).astype(np.float32) * scale,
                  "a": rng.standard_normal((3, 9)).astype(np.float32)
                  * scale},
            "e": rng.standard_normal((11, 8)).astype(np.float32) * scale}


def _j(t, dt):
    return jax.tree.map(lambda a: jnp.asarray(a, JDT[dt]), t)


def _t(t, dt):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(TDT[dt]),
                        t)


def _err(got, want) -> float:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tol(t: torch.Tensor) -> float:
    return BF16_TOL if t.dtype == torch.bfloat16 else F32_TOL


def _assert_trees_close(got, want, label):
    gl = tree.leaves(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert _err(g, w) <= _tol(g), (label, i, _err(g, w))


# --------------------------------------------------------------------------
# AdamW against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("param_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale,clips", [(0.01, False), (10.0, True)])
def test_adamw_matches_the_reference(param_dt, state_dt, grad_scale, clips):
    """Five steps from the same parameters with the same gradients each
    step: parameters, both moments, the step counter and the norm."""
    rng = np.random.default_rng(0)
    p0 = _np_tree(rng)
    jp = _j(p0, param_dt)
    js = jadamw.adamw_init(jp, state_dtype=JDT[state_dt])
    tp = _t(p0, param_dt)
    ts = tadamw.adamw_init(tp, state_dtype=TDT[state_dt])
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for step in range(5):
        g = _np_tree(rng, grad_scale)
        jp, js, jn = jadamw.adamw_update(jp, _j(g, param_dt), js, 1e-2)
        out = tadamw.adamw_update(tp, _t(g, param_dt), ts, 1e-2)
        assert out[0] is tp and out[1] is ts        # in place
        tn = out[2]
        assert (float(jn) > 1.0) == clips
        assert abs(float(tn) - float(jn)) <= F32_TOL * float(jn)
        assert int(ts.step) == int(js.step) == step + 1
        _assert_trees_close(tp, jp, f"params, step {step}")
        _assert_trees_close(ts.mu, js.mu, f"mu, step {step}")
        _assert_trees_close(ts.nu, js.nu, f"nu, step {step}")
        assert all(t.dtype == TDT[state_dt] for t in tree.leaves(ts.mu))
        assert all(t.dtype == TDT[param_dt] for t in tree.leaves(tp))


def test_adamw_with_a_schedule_on_the_step_counter():
    """lr a 0-d tensor read off the port's own step counter (a schedule),
    against the reference with the same schedule of its counter."""
    rng = np.random.default_rng(1)
    p0 = _np_tree(rng)
    jp, tp = _j(p0, "float32"), _t(p0, "float32")
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for _ in range(6):
        g = _np_tree(rng)
        jlr = jsched.cosine_schedule(js.step, 0.05, 2, 6)
        tlr = tsched.cosine_schedule(ts.step, 0.05, 2, 6)
        assert isinstance(tlr, torch.Tensor) and tlr.device == ts.step.device
        jp, js, _ = jadamw.adamw_update(jp, _j(g, "float32"), js, jlr)
        tadamw.adamw_update(tp, _t(g, "float32"), ts, tlr)
    _assert_trees_close(tp, jp, "params")


@pytest.mark.parametrize("max_norm", [1e9, 1.0])
def test_slicing_changes_no_update_bit(monkeypatch, max_norm):
    """Slices of at most 7 elements against whole leaves: the update is
    elementwise, so the results are bit-identical where the norm does not
    clip; with clipping the sliced norm's sum order may move the scale by
    an ulp."""
    rng = np.random.default_rng(2)
    p0 = _np_tree(rng)
    runs = []
    for limit in (tadamw.SLICE["cpu"], 7):
        monkeypatch.setitem(tadamw.SLICE, "cpu", limit)
        tp = _t(p0, "float32")
        ts = tadamw.adamw_init(tp)
        r = np.random.default_rng(3)
        for _ in range(3):
            tadamw.adamw_update(tp, _t(_np_tree(r, 10.0), "float32"), ts,
                                1e-2, max_grad_norm=max_norm)
        runs.append((tp, ts))
    (a, sa), (b, sb) = runs
    assert len(list(tadamw._slices(torch.zeros(6, 5, 4)))) == 30
    for x, y in zip(tree.leaves((a, sa)), tree.leaves((b, sb))):
        if max_norm > 1e6:
            assert torch.equal(x, y)
        else:
            assert torch.allclose(x.float(), y.float(), rtol=1e-6,
                                  atol=1e-7)


def test_slices_tile_the_leaf():
    t = torch.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5)
    for limit in (1, 7, 20, 60, 61, 200):
        parts = list(tadamw._slices(t, limit))
        assert torch.equal(torch.cat([p.reshape(-1) for p in parts]),
                           t.reshape(-1))
        assert all(p.numel() <= max(limit, 5) for p in parts)


# --------------------------------------------------------------------------
# global norm, clipping, row-wise Adagrad
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_the_reference(dt):
    g = _np_tree(np.random.default_rng(4), 3.0)
    jn = jadamw.global_norm(_j(g, dt))
    tn = tadamw.global_norm(_t(g, dt))
    assert tn.dtype == torch.float32
    assert abs(float(tn) - float(jn)) <= F32_TOL * float(jn)
    jc, jcn = jadamw.clip_by_global_norm(_j(g, dt), 1.0)
    tc, tcn = tadamw.clip_by_global_norm(_t(g, dt), 1.0)
    assert abs(float(tcn) - float(jcn)) <= F32_TOL * float(jcn)
    for a, b in zip(tree.leaves(tc), jax.tree.leaves(jc)):
        assert str(a.dtype).split(".")[1] == str(b.dtype)   # promoted
        assert _err(a, b) <= F32_TOL


def test_global_norm_adds_leaves_in_jax_order():
    """Leaves of very different magnitudes, so the order of the float32
    additions shows: the port's sum equals the sum in JAX's order bit for
    bit, computed here in numpy, and the insertion order differs."""
    vals = {"z": np.float32(1e8), "a": np.float32(1.0),
            "m": np.float32(-1e8), "b": np.float32(3.0)}
    t = {k: torch.tensor([v], dtype=torch.float32) for k, v in vals.items()}
    want = np.float32(0)
    for k in sorted(vals):
        want = np.float32(want + np.float32(vals[k]) ** 2)
    assert float(tadamw.global_norm(t)) == float(np.sqrt(want))
    assert [float(x) for x in tree.leaves(t)] == \
        [float(vals[k]) for k in sorted(vals)]


def test_row_adagrad_matches_the_reference():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((9, 6)).astype(np.float32)
    jt = jnp.asarray(table)
    js = jadamw.row_adagrad_init(jt)
    tt = torch.from_numpy(table.copy())
    ts = tadamw.row_adagrad_init(tt)
    for _ in range(4):
        g = rng.standard_normal((9, 6)).astype(np.float32)
        g[rng.random(9) < 0.4] = 0.0                  # untouched rows
        jt, js = jadamw.row_adagrad_update(jt, jnp.asarray(g), js, lr=0.1)
        out = tadamw.row_adagrad_update(tt, torch.from_numpy(g), ts,
                                        lr=0.1)
        assert out[0] is tt and out[1] is ts
    assert _err(tt, jt) <= F32_TOL
    assert _err(ts.accum, js.accum) <= F32_TOL


# --------------------------------------------------------------------------
# schedules at their boundaries
# --------------------------------------------------------------------------

WARM, TOTAL = 10, 110


@pytest.mark.parametrize("step", [0, WARM - 1, WARM, 60, TOTAL, TOTAL + 25])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_schedules_match_the_reference(step, as_tensor):
    s = torch.tensor(step, dtype=torch.int32) if as_tensor else step
    js = jnp.int32(step) if as_tensor else step
    for jv, tv in ((jsched.linear_warmup(js, 0.3, WARM),
                    tsched.linear_warmup(s, 0.3, WARM)),
                   (jsched.cosine_schedule(js, 0.3, WARM, TOTAL),
                    tsched.cosine_schedule(s, 0.3, WARM, TOTAL)),
                   (jsched.cosine_schedule(js, 0.3, WARM, TOTAL, floor=0.0),
                    tsched.cosine_schedule(s, 0.3, WARM, TOTAL, floor=0.0))):
        assert isinstance(tv, torch.Tensor) and tv.dtype == torch.float32
        assert abs(float(tv) - float(jv)) <= F32_TOL * max(abs(float(jv)),
                                                           1e-3)


def test_schedule_of_a_zero_warmup():
    for step in (0, 5):
        assert float(tsched.linear_warmup(step, 1.0, 0)) == \
            pytest.approx(float(jsched.linear_warmup(step, 1.0, 0)))
        assert float(tsched.cosine_schedule(step, 1.0, 0, 5)) == \
            pytest.approx(float(jsched.cosine_schedule(step, 1.0, 0, 5)))


# --------------------------------------------------------------------------
# the reference's TestOptim (tests/test_substrates.py:55-95), mirrored
# --------------------------------------------------------------------------


def _grad(fn, p: dict) -> dict:
    w = p["w"].detach().requires_grad_()
    g, = torch.autograd.grad(fn(w), w)
    return {"w": g}


class TestOptim:
    def test_adamw_converges_quadratic(self):
        p = {"w": torch.tensor([5.0, -3.0])}
        s = tadamw.adamw_init(p)
        for _ in range(300):
            g = _grad(lambda w: torch.sum((w - 1.0) ** 2), p)
            p, s, _ = tadamw.adamw_update(p, g, s, 0.05, weight_decay=0.0)
        assert np.allclose(p["w"].numpy(), 1.0, atol=1e-2)

    def test_clipping(self):
        g = {"a": torch.tensor([3.0, 4.0])}
        clipped, norm = tadamw.clip_by_global_norm(g, 1.0)
        assert abs(float(norm) - 5.0) < 1e-6
        assert np.allclose(clipped["a"].numpy(), [0.6, 0.8])

    def test_bf16_states_still_converge(self):
        p = {"w": torch.tensor([5.0])}
        s = tadamw.adamw_init(p, state_dtype=torch.bfloat16)
        for _ in range(300):
            g = _grad(lambda w: torch.sum(w ** 2), p)
            p, s, _ = tadamw.adamw_update(p, g, s, 0.05, weight_decay=0.0)
        assert abs(float(p["w"][0])) < 0.15

    def test_row_adagrad(self):
        t = torch.ones((4, 3))
        t0 = t.clone()
        s = tadamw.row_adagrad_init(t)
        g = torch.zeros((4, 3))
        g[2] = 1.0
        t2, s2 = tadamw.row_adagrad_update(t, g, s, lr=0.1)
        assert float((t2[0] - t0[0]).abs().sum()) == 0  # untouched row
        assert float(t2[2][0]) < 1.0
        assert float(s2.accum[2]) > 0

    def test_schedules(self):
        assert float(tsched.linear_warmup(0, 1.0, 10)) == pytest.approx(0.1)
        assert float(tsched.cosine_schedule(10, 1.0, 10, 110)) == \
            pytest.approx(1.0, abs=0.01)
        assert float(tsched.cosine_schedule(110, 1.0, 10, 110)) == \
            pytest.approx(0.1, abs=0.01)
