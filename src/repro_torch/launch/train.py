"""Training entry point of the port: so far only :func:`reduced_lm`.

The JAX package's ``src/repro/launch/train.py`` runs a reduced config of an
architecture through its fault-tolerant trainer.  The port's ``main``
waits for the training slice (``lm_loss``, ``make_train_step``,
``optim/``, ``train/``, ``checkpoint/``); :func:`reduced_lm` is here now
because ``launch/serve.py`` takes its reduced LM from it, as the
reference's does.
"""

from __future__ import annotations

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
