"""two-tower-retrieval at full width: embed_dim 256, towers 1024-512-256,
dot interaction (Yi et al., RecSys'19), as the JAX package's
``src/repro/configs/two_tower_retrieval.py`` configures it.

The vocabularies are 2,000,000 padded to a multiple of 512 (2,000,384), as
the reference pads them for row sharding.  ``CFG`` is ``ARCH.cfg``.
``RETRIEVAL_CAND`` is the reference's retrieval_cand scoring shape
(``configs/common.py``): one user against 1,000,000 candidates, padded to
512 as ``_pad512`` does.

This is the architecture the paper's index plugs into directly: the
immediate-access dynamic index generates the candidates that the dense
stage scores (``examples/hybrid_retrieval_torch.py``).
"""

from ..models.recsys import TwoTowerConfig
from .common import RecsysArch


def _pad512(n: int) -> int:
    return (n + 511) // 512 * 512


ARCH = RecsysArch(
    arch_id="two-tower-retrieval", kind="twotower",
    cfg=TwoTowerConfig(name="two-tower-retrieval", n_users_vocab=2_000_384,
                       n_items=2_000_384, embed_dim=256,
                       tower_mlp=(1024, 512, 256), n_user_feats=8))
CFG = ARCH.cfg

#: candidates scored per query at the retrieval_cand shape
RETRIEVAL_CAND = _pad512(1_000_000)
