"""End-to-end training driver: ``python -m repro_torch.launch.train --arch <id>``.

Ported from the JAX package's ``src/repro/launch/train.py``: a REDUCED
config of the selected architecture (:func:`reduced_lm`), wired through the
production stack: config -> parameters drawn on the device -> AdamW ->
fault-tolerant :class:`~repro_torch.train.Trainer` (checkpoint/restart,
straggler log, NaN fuse) -> deterministic data pipeline
(``data/lm.py`` ``TokenBatches``).  It runs on the card unless
``--device`` names another torch device (``--device cpu`` here), and
raises where there is no card.

:func:`train_lm` beside :func:`main` runs any ``LMConfig``, the full
widths too, as ``launch/serve.py``'s ``serve_lm`` does for serving.  The
LM family only so far: the ``gnn`` and ``recsys`` arch ids raise the
"not ported yet" ``KeyError`` of ``configs.get_arch``.
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from ..models.lm import LMConfig, MoEConfig


def reduced_lm(cfg: LMConfig) -> LMConfig:
    """The reference's reduced LM: 2 layers, d_model 128, 4 heads (2 KV) of
    32, d_ff 256, vocab 512 padded to 16, at most 8 experts and top-2,
    float32."""
    moe = cfg.moe
    if moe is not None:
        moe = MoEConfig(n_experts=min(moe.n_experts, 8),
                        top_k=min(moe.top_k, 2))
    return replace(cfg, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                   d_head=32, d_ff=256, vocab=512, moe=moe, microbatch=1,
                   q_chunk=32, kv_chunk=64, loss_chunk=64, pad_multiple=16,
                   dtype=torch.float32)


def train_lm(cfg: LMConfig, steps: int, *, batch: int, seq: int,
             ckpt_dir: str | None = None, ckpt_every: int = 10,
             device=None, lr=1e-3, seed: int = 0, data=None,
             log_every: int = 10, log_fn=print) -> dict:
    """Train ``cfg`` for ``steps`` steps through the :class:`Trainer`.

    The parameters are drawn on ``device`` (None means the card) from a
    generator seeded with ``seed``, the AdamW moments are of
    ``cfg.opt_dtype``, and ``lr`` is a float or a function of the
    optimizer's step counter (a 0-d tensor on the device, e.g. a
    :func:`~repro_torch.optim.cosine_schedule`).  ``data`` has
    ``batch_at(step)`` returning numpy ``tokens`` and ``labels`` (B, S);
    the default is ``TokenBatches(cfg.vocab, batch, seq)``.  With
    ``ckpt_dir`` the trainer saves every ``ckpt_every`` steps and resumes
    from the newest checkpoint there.  On a CUDA device each step ends in
    a synchronize, so the trainer's clock holds all of a step, its
    in-place update too (the reference's trainer waits for one XLA program
    that ends with the update).  Returns the ``trainer`` (its
    ``params``, ``opt_state``, ``metrics`` and ``straggler_steps``) and
    the printed ``line``."""
    from ..core.device_index import resolve_device
    from ..data.lm import TokenBatches
    from ..models import lm as lm_mod
    from ..optim import adamw_init, adamw_update
    from ..train import Trainer

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm_mod.init_params(cfg, device, gen)
    opt = adamw_init(params, state_dtype=cfg.opt_dtype)

    def update(p, g, s):
        rate = lr(s.step) if callable(lr) else lr
        return adamw_update(p, g, s, rate)

    train_step = lm_mod.make_train_step(cfg, update)

    def step(p, o, b):
        out = train_step(p, o, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    if data is None:
        data = TokenBatches(cfg.vocab, batch, seq)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}

    trainer = Trainer(step, params, opt, batch_at, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, log_every=log_every,
                      log_fn=log_fn)
    del params, opt      # a restore replaces them: keep one copy alive
    metrics = trainer.run(steps)
    first, last = metrics[0]["loss"], metrics[-1]["loss"]
    line = (f"[train] {cfg.name}: loss {first:.4f} -> {last:.4f} over "
            f"{len(metrics)} steps; stragglers={trainer.straggler_steps}")
    return {"trainer": trainer, "line": line}


def main(argv=None):
    from ..configs import get_arch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="the torch device (default the card)")
    args = ap.parse_args(argv)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise KeyError(f"arch {args.arch!r} ({arch.family}) is not ported "
                       f"yet for training; the LM family is")
    out = train_lm(reduced_lm(arch.cfg), args.steps, batch=args.batch,
                   seq=args.seq, ckpt_dir=args.ckpt_dir, device=args.device)
    print(out["line"])
    return out


if __name__ == "__main__":
    main()
