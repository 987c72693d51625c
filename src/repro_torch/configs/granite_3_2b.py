"""granite-3-2b [dense]: 40L d=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""

from .common import LMArch
from ..models.lm import LMConfig

ARCH = LMArch(
    arch_id="granite-3-2b",
    cfg=LMConfig(
        name="granite-3-2b",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=49155, d_head=64,
        microbatch=2, q_chunk=512, kv_chunk=1024, loss_chunk=512,
    ))
