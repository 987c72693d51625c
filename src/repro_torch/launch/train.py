"""End-to-end training driver: ``python -m repro_torch.launch.train --arch <id>``.

Ported from the JAX package's ``src/repro/launch/train.py``: a REDUCED
config of the selected architecture, wired through the production stack:
config -> parameters drawn on the device -> AdamW -> fault-tolerant
:class:`~repro_torch.train.Trainer` (checkpoint/restart, straggler log,
NaN fuse) -> deterministic data pipeline.  For an LM id that is
:func:`reduced_lm` on ``data/lm.py``'s ``TokenBatches``; for schnet, the
gnn id, the reference's reduced SchNet (:func:`reduced_schnet`) on
:class:`GraphBatches`, ``--batch`` small random graphs a step drawn as
the reference draws them; for any recsys id it is the reference's reduced
DLRM (:func:`reduced_dlrm`, whichever recsys model is named, as in the
reference) on ``data/recsys.py``'s ``RecsysBatches``.  It runs on the
card unless ``--device`` names another torch device (``--device cpu``
here), and raises where there is no card.

:func:`train_lm`, :func:`train_gnn` and :func:`train_recsys` beside
:func:`main` run any ``LMConfig``, SchNet config and recsys architecture,
the full widths too, as ``launch/serve.py``'s ``serve_lm`` does for
serving.
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np
import torch

from ..core.device_index import resolve_device
from ..models.gnn import SchNetConfig
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


def reduced_schnet() -> SchNetConfig:
    """The reference's reduced SchNet (``src/repro/launch/train.py``'s gnn
    branch): 2 interactions, d_hidden 32, 16 RBFs, d_feat 16, the
    regression head."""
    return SchNetConfig(n_interactions=2, d_hidden=32, n_rbf=16, d_feat=16,
                        n_out=1)


class GraphBatches:
    """The reference's gnn branch's batches: at step ``i``, ``n_graphs``
    graphs of 16 nodes and 40 edges each on average, drawn from
    ``np.random.default_rng(i)`` in the reference's order (features
    N(0, 1), sources and destinations uniform over all N = 16 n_graphs
    nodes, distances uniform on [0, 10)), node ``v`` in graph ``v mod
    n_graphs``, every target 0."""

    def __init__(self, n_graphs: int):
        self.n_graphs = n_graphs

    def batch_at(self, i: int) -> dict:
        B = self.n_graphs
        N, E = B * 16, B * 40
        r = np.random.default_rng(i)
        return {
            "node_feat": r.standard_normal((N, 16)).astype(np.float32),
            "src": r.integers(0, N, E).astype(np.int32),
            "dst": r.integers(0, N, E).astype(np.int32),
            "dist": (r.random(E) * 10).astype(np.float32),
            "edge_mask": np.ones(E, bool),
            "node_mask": np.ones(N, np.float32),
            "graph_ids": (np.arange(N) % B).astype(np.int32),
            "target": np.zeros(B, np.float32)}


def train_gnn(cfg_or_arch, steps: int, *, data, n_graphs: int = 1,
              shape: str | None = None, device=None, lr=1e-3, seed: int = 0,
              ckpt_dir: str | None = None, ckpt_every: int = 10,
              log_every: int = 10, log_fn=print,
              name: str | None = None) -> dict:
    """Train SchNet for ``steps`` steps through the :class:`Trainer`, as
    :func:`train_lm` trains an LM.

    ``cfg_or_arch`` is a ``SchNetConfig`` or a
    :class:`~repro_torch.configs.common.GNNArch` (its ``cfg_for(shape)``,
    or its base config where ``shape`` is None).  ``data`` has
    ``batch_at(step)`` returning the batch with ``models.gnn.input_specs``'
    keys, as numpy arrays or as tensors already on ``device``;
    ``n_graphs`` is the regression head's graphs a batch.  The parameters
    are drawn on ``device`` (None means the card) from a generator seeded
    with ``seed``, the AdamW moments are float32, and ``lr`` is a float or
    a function of the step counter.  Checkpoints, the synchronize that
    ends each step on CUDA, ``name`` and the result are
    :func:`train_lm`'s."""
    from ..configs.common import GNNArch
    from ..models import gnn as gnn_mod

    cfg = cfg_or_arch
    if isinstance(cfg, GNNArch):
        cfg = cfg.cfg_for(shape) if shape else cfg.base_cfg
    device = resolve_device(device)
    params = gnn_mod.init_params(cfg, device, torch.Generator(
        device=device).manual_seed(seed))
    opt = adamw_init(params)
    trainer = _run(lambda u: gnn_mod.make_train_step(cfg, u, n_graphs),
                   params, opt, data, steps, device=device, lr=lr,
                   ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                   log_every=log_every, log_fn=log_fn)
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

    def batch_at(i):    # numpy arrays are copied over, tensors there kept
        return {k: torch.as_tensor(v, device=device)
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
    kw = dict(ckpt_dir=args.ckpt_dir, device=args.device, name=args.arch)
    if arch.family == "lm":
        out = train_lm(reduced_lm(arch.cfg), args.steps, batch=args.batch,
                       seq=args.seq, **kw)
    elif arch.family == "gnn":
        out = train_gnn(reduced_schnet(), args.steps, n_graphs=args.batch,
                        data=GraphBatches(args.batch), **kw)
    else:       # recsys: the reduced DLRM whichever model is named
        out = train_recsys(reduced_dlrm(), "dlrm", args.steps,
                           batch=args.batch, **kw)
    print(out["line"])
    return out


if __name__ == "__main__":
    main()
