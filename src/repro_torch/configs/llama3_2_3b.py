"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""

from .common import LMArch
from ..models.lm import LMConfig

ARCH = LMArch(
    arch_id="llama3.2-3b",
    cfg=LMConfig(
        name="llama3.2-3b",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, d_head=128,
        microbatch=2, q_chunk=512, kv_chunk=1024, loss_chunk=512,
    ))
