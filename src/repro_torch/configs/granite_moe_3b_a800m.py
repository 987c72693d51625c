"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base;
hf]"""

from .common import LMArch
from ..models.lm import LMConfig, MoEConfig

ARCH = LMArch(
    arch_id="granite-moe-3b-a800m",
    cfg=LMConfig(
        name="granite-moe-3b-a800m",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155, d_head=64,
        moe=MoEConfig(n_experts=40, top_k=8),
        microbatch=2, q_chunk=512, kv_chunk=1024, loss_chunk=512,
    ))
