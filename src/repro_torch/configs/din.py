"""din [recsys]: embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80,
target attention.  [arXiv:1706.06978; paper]

As the JAX package's ``src/repro/configs/din.py`` configures it.
"""

from ..models.recsys import DINConfig
from .common import RecsysArch

ARCH = RecsysArch(
    arch_id="din", kind="din",
    # n_items padded 1e6 -> 512-multiple, as the reference pads it for row
    # sharding
    cfg=DINConfig(name="din", n_items=1_000_448, embed_dim=18, seq_len=100,
                  attn_mlp=(80, 40), mlp=(200, 80)))
