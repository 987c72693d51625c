"""Fault-tolerant training loop.

Ported from the JAX package's ``src/repro/train/trainer.py``; the loop
owns the three production behaviours:

  * **checkpoint/restart**: every ``ckpt_every`` steps the full (params,
    opt_state) tree is saved asynchronously (atomic publish, host copies
    taken on this thread; see :mod:`..checkpoint`); on construction the
    trainer restores the newest complete checkpoint and the deterministic
    data pipeline (``batch_at(step)``) replays exactly the batch the failed
    run would have seen next.  Node failure = process death = restart and
    resume; the tests stop a run and check a bit-identical continuation.
  * **straggler mitigation**: a per-step wall-time EWMA with a deadline
    multiplier; steps exceeding it are logged and counted.  A step's wall
    time ends when its loss has reached the host, so on the card it holds
    the step's device time too.
  * **NaN/inf guard**: a non-finite loss skips the update and counts
    toward a fuse that aborts if it persists.  ``train_step`` may update in
    place (``models.lm.make_train_step`` does, and then leaves everything
    as it was for a non-finite loss) or return new trees (the trainer then
    keeps the old ones): the loop is the same for both.
"""

from __future__ import annotations

import math
import time

from ..checkpoint import CheckpointManager


class Trainer:
    def __init__(self, train_step, params, opt_state, batch_at,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 straggler_factor: float = 3.0, nan_fuse: int = 5,
                 log_every: int = 10, log_fn=print):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.batch_at = batch_at
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.nan_fuse = nan_fuse
        self.log_every = log_every
        self.log = log_fn
        self.step = 0
        self.metrics: list[dict] = []
        self._ewma = None
        self.straggler_steps = 0
        self._nan_streak = 0
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state = self.ckpt.restore(
                    latest, like=(self.params, self.opt_state))
                self.params, self.opt_state = state
                self.step = latest + 1
                self.log(f"[trainer] resumed from step {latest}")

    def run(self, n_steps: int):
        end = self.step + n_steps
        while self.step < end:
            batch = self.batch_at(self.step)
            t0 = time.perf_counter()
            out = self.train_step(self.params, self.opt_state, batch)
            new_params, new_opt, loss, gnorm = out
            loss = float(loss)
            dt = time.perf_counter() - t0
            # straggler watch
            if self._ewma is None:
                self._ewma = dt
            elif dt > self.straggler_factor * self._ewma:
                self.straggler_steps += 1
                self.log(f"[trainer] straggler step {self.step}: "
                         f"{dt:.3f}s vs ewma {self._ewma:.3f}s")
            self._ewma = 0.9 * self._ewma + 0.1 * dt
            # NaN guard
            if not math.isfinite(loss):
                self._nan_streak += 1
                self.log(f"[trainer] non-finite loss at step {self.step}; "
                         f"skipping update ({self._nan_streak}/{self.nan_fuse})")
                if self._nan_streak >= self.nan_fuse:
                    raise FloatingPointError("persistent non-finite loss")
            else:
                self._nan_streak = 0
                self.params, self.opt_state = new_params, new_opt
            self.metrics.append({"step": self.step, "loss": loss,
                                 "gnorm": float(gnorm), "sec": dt})
            if self.log_every and self.step % self.log_every == 0:
                self.log(f"[trainer] step {self.step} loss {loss:.4f} "
                         f"({dt*1e3:.1f} ms)")
            if (self.ckpt is not None and self.step % self.ckpt_every == 0
                    and self.step > 0):
                self.ckpt.save(self.step, (self.params, self.opt_state),
                               blocking=False)
            self.step += 1
        if self.ckpt is not None:
            self.ckpt.save(self.step - 1, (self.params, self.opt_state),
                           blocking=True)
        return self.metrics
