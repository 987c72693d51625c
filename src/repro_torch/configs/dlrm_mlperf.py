"""dlrm-mlperf [recsys]: 13 dense + 26 sparse, embed_dim=128,
bot 13-512-256-128, top 1024-1024-512-256-1, dot interaction (MLPerf Criteo
1TB row counts, 40M cap).  [arXiv:1906.00091; paper]

As the JAX package's ``src/repro/configs/dlrm_mlperf.py`` configures it.
The fused table is 204,184,588 rows (padded to 204,185,088) × 128 float32,
104.5 GB: more than one H100's 80 GB, so a run on the card caps the rows
and says so (``chip_smoke.py``'s recsys phase).
"""

from ..data.recsys import CRITEO_TABLE_ROWS
from ..models.recsys import DLRMConfig
from .common import RecsysArch

ARCH = RecsysArch(
    arch_id="dlrm-mlperf", kind="dlrm",
    cfg=DLRMConfig(
        name="dlrm-mlperf", table_rows=tuple(CRITEO_TABLE_ROWS),
        embed_dim=128, n_dense=13, bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1)))
