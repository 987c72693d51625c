"""mistral-large-123b [dense]: 88L d=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

At 123B params x 256 chips the HBM budget forces the full memory toolkit:
microbatch=16 grad accumulation, sequence-parallel boundary activations,
bf16 AdamW moments (PaLM-style), recursive flash-attention remat."""

import torch

from .common import LMArch
from ..models.lm import LMConfig

ARCH = LMArch(
    arch_id="mistral-large-123b",
    cfg=LMConfig(
        name="mistral-large-123b",
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=28672, vocab=32768, d_head=128,
        # §Perf H3: dmodel boundaries (the default) cut FSDP weight-gather
        # traffic 6.5x/pass, freeing memory to halve the microbatch count
        # (16 -> 8): predicted step collective time 536s -> 233s.
        microbatch=8, q_chunk=256, kv_chunk=1024, loss_chunk=256,
        opt_dtype=torch.bfloat16,
    ))
