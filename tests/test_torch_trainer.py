"""The port's fault-tolerant training loop (``repro_torch.train.Trainer``)
against the JAX package's, on the CPU.

* The reference's ``TestTrainerFaultTolerance``
  (``tests/test_trainer_checkpoint.py:123-190``), mirrored on the port's
  in-place AdamW: a bit-identical resume, the NaN guard, the NaN fuse, the
  data replay.
* Both packages' trainers on the same quadratic problem: losses and
  gradient norms step for step within ``F32_TOL`` = 1e-6 relative (the
  same float32 arithmetic; XLA's and PyTorch's reductions and ``pow`` may
  differ in the last ulp).
* Straggler counting under one patched clock: the same counts and log
  lines from both.
* A bit-identical resume of the LM: ``launch.train.train_lm`` on the
  reduced llama3.2-3b in bfloat16 with bfloat16 moments (so the
  checkpoint's bf16 leaves, C3, are restored), 6 steps straight against 3
  steps with an async checkpoint at step 2 and 3 more from a trainer built
  on freshly drawn parameters: parameters, moments and the losses of steps
  3-5 equal bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.train import Trainer as JaxTrainer
from repro.train import trainer as jtrainer_mod
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.launch.train import reduced_lm, train_lm
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import global_norm
from repro_torch.train import Trainer
from repro_torch.train import trainer as trainer_mod

F32_TOL = 1e-6
TARGET = [3.0, -1.0, 0.5, 2.0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread is faster, and the test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quadratic_step(lr=0.1):
    """The reference's quadratic step on the port: autograd for the
    gradient, AdamW in place, and the train step's rule for a non-finite
    loss (nothing is updated)."""
    def step(params, opt_state, batch):
        w = params["w"].detach().requires_grad_()
        loss = torch.sum((w - batch["target"]) ** 2)
        g, = torch.autograd.grad(loss, w)
        if not torch.isfinite(loss):
            return params, opt_state, loss.detach(), global_norm([g])
        p, o, gn = adamw_update(params, {"w": g}, opt_state, lr,
                                weight_decay=0.0)
        return p, o, loss.detach(), gn

    return step


def make_batch_at(nan_at=None, target=None):
    def batch_at(i):
        t = torch.tensor(target) if target else torch.full((4,), 3.0)
        if nan_at is not None and i == nan_at:
            t = t * math.nan
        return {"target": t}
    return batch_at


def init_state():
    params = {"w": torch.zeros((4,))}
    return params, adamw_init(params)


class TestTrainerFaultTolerance:
    def test_resume_is_bit_identical(self, tmp_path):
        step = quadratic_step()
        # uninterrupted run: 10 steps
        p, o = init_state()
        t_full = Trainer(step, p, o, make_batch_at(), log_every=0)
        t_full.run(10)
        # interrupted run: 6 steps (ckpt at 5), "crash", resume to 10
        ck = str(tmp_path / "ck")
        p, o = init_state()
        t1 = Trainer(step, p, o, make_batch_at(), ckpt_dir=ck, ckpt_every=5,
                     log_every=0)
        t1.run(6)
        t1.ckpt.wait()
        # a new process would draw its parameters again; the trainer
        # restores from step 5
        p0, o0 = init_state()
        t2 = Trainer(step, p0, o0, make_batch_at(), ckpt_dir=ck,
                     ckpt_every=5, log_every=0)
        assert t2.step == 6  # resumed after the step-5 checkpoint
        t2.run(4)
        assert torch.equal(t_full.params["w"], t2.params["w"])
        assert torch.equal(t_full.opt_state.mu["w"], t2.opt_state.mu["w"])
        assert int(t_full.opt_state.step) == int(t2.opt_state.step) == 10

    def test_nan_guard_skips_update(self):
        step = quadratic_step()
        p, o = init_state()
        t = Trainer(step, p, o, make_batch_at(nan_at=3), log_every=0,
                    nan_fuse=5)
        t.run(6)
        assert bool(torch.isfinite(t.params["w"]).all())
        bad = [m for m in t.metrics if not np.isfinite(m["loss"])]
        assert len(bad) == 1
        assert int(t.opt_state.step) == 5           # one update skipped

    def test_nan_fuse_aborts(self):
        def bad_step(params, opt_state, batch):
            return params, opt_state, math.nan, torch.zeros(())
        p, o = init_state()
        t = Trainer(bad_step, p, o, make_batch_at(), log_every=0, nan_fuse=3)
        with pytest.raises(FloatingPointError):
            t.run(10)

    def test_deterministic_data_replay(self):
        from repro_torch.data.lm import TokenBatches
        d = TokenBatches(vocab=100, batch=2, seq_len=8, seed=9)
        a = d.batch_at(5)
        b = d.batch_at(5)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert not np.array_equal(d.batch_at(5)["tokens"],
                                  d.batch_at(6)["tokens"])


def test_functional_step_is_discarded_on_a_non_finite_loss():
    """A train step that returns new trees (as the reference's do): the
    trainer keeps the old ones where the loss is not finite."""
    def step(params, opt_state, batch):
        new = {"w": params["w"] + batch["target"]}
        return new, opt_state, torch.sum(new["w"]), torch.zeros(())
    p, o = init_state()
    t = Trainer(step, p, o, make_batch_at(nan_at=1), log_every=0)
    t.run(3)
    assert t.params["w"].tolist() == [6.0] * 4


# --------------------------------------------------------------------------
# the two packages' trainers
# --------------------------------------------------------------------------


def _jax_quadratic_step(lr=0.1):
    def loss_fn(p, b):
        return jnp.sum((p["w"] - b["target"]) ** 2)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        p, o, gn = jadamw_update(params, grads, opt_state, lr,
                                 weight_decay=0.0)
        return p, o, loss, gn

    return jax.jit(step)


def test_trainers_agree_step_for_step():
    jparams = {"w": jnp.zeros((4,))}
    jt = JaxTrainer(_jax_quadratic_step(), jparams, jadamw_init(jparams),
                    lambda i: {"target": jnp.asarray(TARGET)}, log_every=0)
    p, o = init_state()
    tt = Trainer(quadratic_step(), p, o, make_batch_at(target=TARGET),
                 log_every=0)
    jm, tm = jt.run(12), tt.run(12)
    assert [m["step"] for m in jm] == [m["step"] for m in tm]
    for a, b in zip(jm, tm):
        for key in ("loss", "gnorm"):
            assert abs(a[key] - b[key]) <= F32_TOL * abs(a[key]), (key, a, b)
    np.testing.assert_allclose(tt.params["w"].numpy(),
                               np.asarray(jt.params["w"]), rtol=F32_TOL)


class _Clock:
    """perf_counter for a trainer: each step takes ``durations[i]``."""

    def __init__(self, durations):
        self.now, self.durations, self.calls = 0.0, list(durations), 0

    def __call__(self):
        if self.calls % 2:                    # the end of a step
            self.now += self.durations[self.calls // 2]
        self.calls += 1
        return self.now


def test_straggler_counting_matches_the_reference(monkeypatch):
    durations = [1.0, 1.0, 5.0, 1.0, 1.0, 2.5, 1.0, 9.0, 1.0, 1.0]
    logs = {}
    for name, mod, make in (
            ("jax", jtrainer_mod, lambda log: JaxTrainer(
                lambda p, o, b: (p, o, 1.0, 0.0), {"w": jnp.zeros(1)}, None,
                lambda i: None, log_every=0, log_fn=log)),
            ("torch", trainer_mod, lambda log: Trainer(
                lambda p, o, b: (p, o, torch.tensor(1.0), torch.zeros(())),
                {"w": torch.zeros(1)}, None, lambda i: None, log_every=0,
                log_fn=log))):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(durations))
        lines: list = []
        t = make(lines.append)
        t.run(len(durations))
        monkeypatch.undo()
        logs[name] = (t.straggler_steps, lines,
                      [m["sec"] for m in t.metrics])
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][0] == 2 and len(logs["torch"][1]) == 2
    assert logs["torch"][2] == durations


# --------------------------------------------------------------------------
# the LM: a bit-identical resume
# --------------------------------------------------------------------------


def test_lm_resume_is_bit_identical(tmp_path):
    cfg = reduced_lm(get_arch("llama3.2-3b").cfg)
    from dataclasses import replace
    cfg = replace(cfg, dtype=torch.bfloat16, opt_dtype=torch.bfloat16,
                  microbatch=2)
    kw = dict(batch=4, seq=32, device="cpu", log_every=0, log_fn=print)
    straight = train_lm(cfg, 6, **kw)["trainer"]
    ck = str(tmp_path / "ck")
    first = train_lm(cfg, 3, ckpt_dir=ck, ckpt_every=2, **kw)["trainer"]
    assert first.ckpt.all_steps() == [2]
    lines: list = []
    second = train_lm(cfg, 3, ckpt_dir=ck, ckpt_every=2, seed=1,
                      **dict(kw, log_fn=lines.append))["trainer"]
    assert lines[0] == "[trainer] resumed from step 2"
    assert [m["step"] for m in second.metrics] == [3, 4, 5]
    assert [m["loss"] for m in second.metrics] == \
        [m["loss"] for m in straight.metrics[3:]]
    got = tree.leaves((second.params, second.opt_state))
    want = tree.leaves((straight.params, straight.opt_state))
    assert got[0].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(second.opt_state.step) == 6
