"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 (early-fusion backbone; modality frontend
stubbed per brief).  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from .common import LMArch
from ..models.lm import LMConfig, MoEConfig

ARCH = LMArch(
    arch_id="llama4-scout-17b-a16e",
    cfg=LMConfig(
        name="llama4-scout-17b-a16e",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, d_head=128,
        moe=MoEConfig(n_experts=16, top_k=1),
        microbatch=4, q_chunk=512, kv_chunk=1024, loss_chunk=512,
    ))
