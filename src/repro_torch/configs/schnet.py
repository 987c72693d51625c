"""schnet [gnn]: n_interactions=3 d_hidden=64 rbf=300 cutoff=10.
[arXiv:1706.08566; paper]

As the JAX package's ``src/repro/configs/schnet.py`` configures it.
"""

from ..models.gnn import SchNetConfig
from .common import GNNArch

ARCH = GNNArch(
    arch_id="schnet",
    base_cfg=SchNetConfig(
        name="schnet", n_interactions=3, d_hidden=64, n_rbf=300,
        cutoff=10.0))
