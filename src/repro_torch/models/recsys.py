"""The two-tower retrieval model (Yi et al., RecSys'19), for serving.

Ported from the two-tower part of the JAX package's
``src/repro/models/recsys.py``: a user tower over a bag of hashed user
features and an item tower over an item's embedding row, each an MLP with
ReLU between its layers (not after the last), and L2-normalised outputs
(the norm floored at 1e-6), so a score is a cosine in [-1, 1].

* The tables are ``nn.Embedding``s looked up with JAX's clamped gather
  (:func:`..sparse.ops.take_rows`): an item id ≥ ``n_items`` reads the last
  row, as in the reference, instead of raising.
* The towers are ``nn.Linear``s; ``Linear.weight`` is the transpose of the
  reference's (in, out) ``w``.
* Initialisation draws the reference's distributions from an explicit
  ``torch.Generator`` on the target device: tables N(0, 0.01²), weights
  N(0, 1)·√(2/in), biases zero.  The same seed gives other numbers than
  ``jax.random``; :func:`..convert.twotower_from_jax` carries the
  reference's parameters across instead.  Parameters are allocated and
  drawn on the device: the full-width tables (2 × 2,000,384 × 256 float32,
  4.10 GB) never pass through host memory.
* The reference's ``mesh`` argument and its sharding constraint go: the
  port runs on one device.  Training (the in-batch softmax loss) is not
  ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from ..core.device_index import resolve_device
from ..sparse.ops import embedding_bag, take_rows


@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_users_vocab: int = 2_000_000
    n_items: int = 2_000_000
    embed_dim: int = 256
    tower_mlp: Sequence[int] = (1024, 512, 256)
    n_user_feats: int = 8
    dtype: torch.dtype = torch.float32


def _tower(dims, dtype, device, gen) -> nn.Sequential:
    """Linear layers over ``dims`` with ReLU between them, initialised as
    the reference's ``_mlp_init``."""
    layers: list[nn.Module] = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        lin = nn.utils.skip_init(nn.Linear, d_in, d_out, device=device,
                                 dtype=dtype)
        with torch.no_grad():
            lin.weight.normal_(0.0, math.sqrt(2.0 / d_in), generator=gen)
            lin.bias.zero_()
        layers.append(lin)
        if i + 2 < len(dims):
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-6)


class TwoTower(nn.Module):
    """Two-tower retriever on one device.

    ``device`` None means the card (raises without CUDA); ``generator``
    (a ``torch.Generator`` on ``device``) draws the initial parameters,
    default one seeded with 0.
    """

    def __init__(self, cfg: TwoTowerConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        D, dims = cfg.embed_dim, (cfg.embed_dim, *cfg.tower_mlp)
        self.user_table = nn.utils.skip_init(
            nn.Embedding, cfg.n_users_vocab, D, device=device,
            dtype=cfg.dtype)
        self.item_table = nn.utils.skip_init(
            nn.Embedding, cfg.n_items, D, device=device, dtype=cfg.dtype)
        with torch.no_grad():
            self.user_table.weight.normal_(0.0, 0.01, generator=generator)
            self.item_table.weight.normal_(0.0, 0.01, generator=generator)
        self.user_tower = _tower(dims, cfg.dtype, device, generator)
        self.item_tower = _tower(dims, cfg.dtype, device, generator)

    @property
    def device(self) -> torch.device:
        return self.item_table.weight.device

    def user_embedding(self, batch: dict) -> torch.Tensor:
        """(B, D') unit rows from ``batch["user_feats"]`` (B, F) hashed
        feature ids, summed with ``batch["user_mask"]`` (B, F) weights."""
        bag = embedding_bag(self.user_table.weight, batch["user_feats"],
                            weights=batch["user_mask"], mode="sum")
        return _normalize(self.user_tower(bag))

    def item_embedding(self, item_ids: torch.Tensor) -> torch.Tensor:
        """(*ids.shape, D') unit rows; ids ≥ ``n_items`` read the last row."""
        return _normalize(self.item_tower(
            take_rows(self.item_table.weight, item_ids)))

    def serve(self, batch: dict) -> torch.Tensor:
        """The reference's ``twotower_serve``: (B,) scores of given (user,
        ``batch["item"]``) pairs."""
        u = self.user_embedding(batch)
        v = self.item_embedding(batch["item"])
        return (u * v).sum(dim=-1)

    def retrieve(self, batch: dict) -> torch.Tensor:
        """The reference's ``twotower_retrieve``: (B, C) scores of each user
        against ``batch["cand_ids"]`` (C,), a plain matrix product."""
        u = self.user_embedding(batch)
        return u @ self.item_embedding(batch["cand_ids"]).T
