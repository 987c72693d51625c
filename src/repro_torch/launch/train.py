"""End-to-end training driver: ``python -m repro_torch.launch.train --arch <id>``.

Ported from the JAX package's ``src/repro/launch/train.py``: a REDUCED
config of the selected architecture, wired through the production stack:
config -> parameters drawn on the device -> AdamW -> fault-tolerant
:class:`~repro_torch.train.Trainer` (checkpoint/restart, straggler log,
NaN fuse) -> deterministic data pipeline.  For an LM id that is
:func:`reduced_lm` on ``data/lm.py``'s ``TokenBatches``; for any recsys id
it is the reference's reduced DLRM (:func:`reduced_dlrm`, whichever recsys
model is named, as in the reference) on ``data/recsys.py``'s
``RecsysBatches``.  It runs on the card unless ``--device`` names another
torch device (``--device cpu`` here), and raises where there is no card.

:func:`train_lm` and :func:`train_recsys` beside :func:`main` run any
``LMConfig`` and any recsys architecture, the full widths too, as
``launch/serve.py``'s ``serve_lm`` does for serving.  The ``gnn`` arch id
raises the "not ported yet" ``KeyError`` of ``configs.get_arch``.
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from ..core.device_index import resolve_device
from ..models.lm import LMConfig, MoEConfig
from ..models.recsys import DLRMConfig
from ..optim import adamw_init, adamw_update


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
             log_every: int = 10, log_fn=print,
             name: str | None = None) -> dict:
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
    the reference's ``[train]`` ``line`` for it, under ``name`` (default
    the config's)."""
    from ..data.lm import TokenBatches
    from ..models import lm as lm_mod

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm_mod.init_params(cfg, device, gen)
    opt = adamw_init(params, state_dtype=cfg.opt_dtype)
    if data is None:
        data = TokenBatches(cfg.vocab, batch, seq)
    trainer = _run(lambda u: lm_mod.make_train_step(cfg, u), params, opt,
                   data, steps, device=device, lr=lr, ckpt_dir=ckpt_dir,
                   ckpt_every=ckpt_every, log_every=log_every, log_fn=log_fn)
    return {"trainer": trainer, "line": _line(name or cfg.name, trainer)}


def reduced_dlrm() -> DLRMConfig:
    """The reference's reduced DLRM (``src/repro/launch/train.py``'s
    recsys branch): four fields of 512, 256, 128 and 64 rows, embed_dim
    16, bottom MLP 13-32-16, top MLP 64-32-1."""
    return DLRMConfig(table_rows=(512, 256, 128, 64), embed_dim=16,
                      bot_mlp=(32, 16), top_mlp=(64, 32, 1))


def train_recsys(arch_or_cfg, kind, steps: int, *, batch: int,
                 device=None, lr=1e-3, seed: int = 0, data=None,
                 ckpt_dir: str | None = None, ckpt_every: int = 10,
                 log_every: int = 10, log_fn=print,
                 name: str | None = None) -> dict:
    """Train a recsys model for ``steps`` steps through the
    :class:`Trainer`, as :func:`train_lm` trains an LM.

    ``arch_or_cfg`` is a :class:`~repro_torch.configs.common.RecsysArch`
    (``kind`` None or its kind) or a model config (``DLRMConfig``,
    ``SASRecConfig``, ``DINConfig``, ``TwoTowerConfig``) with its ``kind``
    (``dlrm``, ``sasrec``, ``din``, ``twotower``).  The parameters are drawn
    on ``device`` (None means the card) from a generator seeded with
    ``seed``, the AdamW moments are float32, and ``lr`` is a float or a
    function of the step counter.  ``data`` has ``batch_at(step)`` returning
    the model's batch as numpy arrays; the default is
    ``ModelBatches(kind, cfg, batch)``.  Checkpoints, the synchronize that
    ends each step on CUDA, ``name`` and the result are
    :func:`train_lm`'s."""
    from ..configs.common import RecsysArch
    from ..data.recsys import ModelBatches
    from ..models.recsys import make_train_step

    if isinstance(arch_or_cfg, RecsysArch):
        arch = arch_or_cfg
        if kind not in (None, arch.kind):
            raise ValueError(f"kind {kind!r} for a {arch.kind} arch")
    else:
        arch = RecsysArch(arch_or_cfg.name, arch_or_cfg, kind)
    device = resolve_device(device)
    params = arch.init(device, torch.Generator(device=device)
                       .manual_seed(seed))
    opt = adamw_init(params)
    loss_fn, _ = arch.loss_and_serve()
    if data is None:
        data = ModelBatches(arch.kind, arch.cfg, batch)
    trainer = _run(lambda u: make_train_step(loss_fn, u), params, opt,
                   data, steps, device=device, lr=lr, ckpt_dir=ckpt_dir,
                   ckpt_every=ckpt_every, log_every=log_every, log_fn=log_fn)
    return {"trainer": trainer, "line": _line(name or arch.cfg.name, trainer)}


def _run(make_step, params, opt, data, steps: int, *, device, lr,
         ckpt_dir, ckpt_every: int, log_every: int, log_fn):
    """``steps`` steps of ``make_step(update)``'s train step with AdamW at
    ``lr`` through the :class:`Trainer` on ``data``'s batches; returns the
    trainer."""
    from ..train import Trainer

    def update(p, g, s):
        rate = lr(s.step) if callable(lr) else lr
        return adamw_update(p, g, s, rate)

    train_step = make_step(update)

    def step(p, o, b):
        out = train_step(p, o, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    def batch_at(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}

    trainer = Trainer(step, params, opt, batch_at, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, log_every=log_every,
                      log_fn=log_fn)
    del params, opt      # a restore replaces them: keep one copy alive
    trainer.run(steps)
    return trainer


def _line(name: str, trainer) -> str:
    """The reference's ``[train]`` line."""
    m = trainer.metrics
    return (f"[train] {name}: loss {m[0]['loss']:.4f} -> {m[-1]['loss']:.4f} "
            f"over {len(m)} steps; stragglers={trainer.straggler_steps}")


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
    kw = dict(batch=args.batch, ckpt_dir=args.ckpt_dir, device=args.device,
              name=args.arch)
    if arch.family == "lm":
        out = train_lm(reduced_lm(arch.cfg), args.steps, seq=args.seq, **kw)
    else:       # recsys: the reduced DLRM whichever model is named
        out = train_recsys(reduced_dlrm(), "dlrm", args.steps, **kw)
    print(out["line"])
    return out


if __name__ == "__main__":
    main()
