"""sasrec [recsys]: embed_dim=50 n_blocks=2 n_heads=1 seq_len=50,
self-attentive sequential recommendation.  [arXiv:1808.09781; paper]

As the JAX package's ``src/repro/configs/sasrec.py`` configures it.
"""

from ..models.recsys import SASRecConfig
from .common import RecsysArch

ARCH = RecsysArch(
    arch_id="sasrec", kind="sasrec",
    # n_items padded 1e6 -> 512-multiple, as the reference pads it for row
    # sharding
    cfg=SASRecConfig(name="sasrec", n_items=1_000_448, embed_dim=50,
                     n_blocks=2, n_heads=1, seq_len=50))
