"""RecSys model family: DLRM, SASRec, DIN, two-tower retrieval.

Ported from the JAX package's ``src/repro/models/recsys.py``.  Each model's
parameters are a tree of dicts and lists with the reference's leaf names
(``table``, ``bot``/``top`` lists of ``{"w": (in, out), "b": (out,)}``,
SASRec's ``blocks`` stacked on a leading axis, ...), and each function takes
that tree as the reference's does, so the port's ``tree.py``, AdamW,
``CheckpointManager`` and ``Trainer`` take them in JAX's leaf order, and
``convert.recsys_from_jax`` carries the reference's trees across.

  * DLRM  (arXiv:1906.00091): bottom MLP -> dot interaction -> top MLP,
    all sparse fields in one fused table looked up in one gather;
  * SASRec (arXiv:1808.09781): causal self-attention over the item history
    (one head whatever ``n_heads`` says, as in the reference);
  * DIN   (arXiv:1706.06978): target attention, a sigmoid-weighted sum;
  * two-tower (Yi et al., RecSys'19): dual MLP towers, an in-batch sampled
    softmax with logQ correction for training; :class:`TwoTower` holds the
    parameters as modules for serving and computes with the same
    functions through a dict view of them.

Every lookup goes through :func:`..sparse.ops.take_rows`, JAX's clamped
gather: an id past a DLRM field's rows reads the next field's rows, an id
past the table reads its last row and sends it no gradient, as in the
reference.  The ``init`` functions draw the reference's distributions on
the device from an explicit ``torch.Generator`` (default one seeded with
0): tables N(0, 0.01²), MLP weights N(0, 1)·√(2/in), biases zero,
SASRec's block weights N(0, 0.05²) and its norms at 1.  The same seed gives
other numbers than ``jax.random``.

The mesh: each model function takes ``mesh=None``.  With a ``DeviceMesh``
and DTensor inputs (``configs.common.RecsysArch.build``: the batch split
over the whole mesh, tables of more than 100,000 rows split by rows over
it, the MLPs replicated) the reference's constraints lay the looked-up
rows out by the batch again, and ``take_rows`` reads a row-sharded table
by a masked gather from each rank's own rows (the ids replicated, the
result reduced to the batch's layout): no table is gathered whole.  With
``mesh=None`` nothing changes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from .. import tree
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.device_index import resolve_device
from ..distributed.sharding import constrain, wrap_local
from ..optim.adamw import global_norm
from ..sparse.ops import embedding_bag, take_rows


def _generator(device, generator):
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return device, generator


def _normal(shape, std, dtype, device, gen) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, std, generator=gen)


def _mlp_init(dims, dtype, device, gen) -> list:
    return [{"w": _normal((i, o), math.sqrt(2.0 / i), dtype, device, gen),
             "b": torch.zeros((o,), dtype=dtype, device=device)}
            for i, o in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers, x, final_act=False):
    for i, lp in enumerate(layers):
        x = x @ lp["w"] + lp["b"]
        if i + 1 < len(layers) or final_act:
            x = torch.relu(x)
    return x


def bce_pointwise(logit, label):
    logit = logit.float()
    return (torch.clamp(logit, min=0) - logit * label
            + torch.log1p(torch.exp(-logit.abs())))


def bce_loss(logit, label):
    return bce_pointwise(logit, label).mean()


# ==========================================================================
# DLRM
# ==========================================================================


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    table_rows: Sequence[int] = ()
    embed_dim: int = 128
    n_dense: int = 13
    bot_mlp: Sequence[int] = (512, 256, 128)
    top_mlp: Sequence[int] = (1024, 1024, 512, 256, 1)
    dtype: torch.dtype = torch.float32

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.table_rows)[:-1]]).astype(
            np.int64)

    @property
    def total_rows(self) -> int:
        """Fused-table rows, padded to 512 as the reference pads them for
        row sharding (padding rows sit at the end and are never
        addressed)."""
        n = int(sum(self.table_rows))
        return (n + 511) // 512 * 512


def dlrm_init(cfg: DLRMConfig, device=None, generator=None) -> dict:
    device, gen = _generator(device, generator)
    n = len(cfg.table_rows)
    return {
        "table": _normal((cfg.total_rows, cfg.embed_dim), 0.01, cfg.dtype,
                         device, gen),
        "bot": _mlp_init((cfg.n_dense, *cfg.bot_mlp), cfg.dtype, device, gen),
        "top": _mlp_init((cfg.embed_dim + (n + 1) * n // 2, *cfg.top_mlp),
                         cfg.dtype, device, gen),
    }


_ALL = ("pod", "data", "model")


def dlrm_forward(params, batch, cfg: DLRMConfig, mesh=None):
    dense = _mlp_apply(params["bot"], batch["dense"], final_act=True)
    offsets = torch.as_tensor(cfg.offsets, device=dense.device)
    emb = take_rows(params["table"], batch["sparse"].long() + offsets)
    emb = constrain(emb, mesh, _ALL, None, None)
    feats = torch.cat([dense[:, None, :], emb], dim=1)        # (B, 27, D)
    inter = torch.bmm(feats, feats.transpose(1, 2))
    n = feats.shape[1]
    iu, ju = torch.triu_indices(n, n, 1, device=dense.device)
    pairs = _upper_pairs(inter, iu, ju)                       # (B, 351)
    top_in = torch.cat([dense, pairs], dim=1)
    return _mlp_apply(params["top"], top_in)[:, 0]


def _upper_pairs(inter, iu, ju):
    """``inter[:, iu, ju]``.  A DTensor split along the batch alone is
    indexed shard by shard: DTensor's own strategy for the index's
    backward (``index_put``) fails on some torch releases."""
    if isinstance(inter, DTensor) and all(
            isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim == 0)
            for p in inter.placements):
        return wrap_local(inter.to_local()[:, iu, ju], inter.device_mesh,
                          inter.placements, (inter.shape[0], iu.numel()))
    return inter[:, iu, ju]


def dlrm_loss(params, batch, cfg: DLRMConfig, mesh=None):
    return bce_loss(dlrm_forward(params, batch, cfg, mesh), batch["label"])


# ==========================================================================
# SASRec
# ==========================================================================


@dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dtype: torch.dtype = torch.float32


def sasrec_init(cfg: SASRecConfig, device=None, generator=None) -> dict:
    device, gen = _generator(device, generator)
    D, L = cfg.embed_dim, cfg.n_blocks

    def w(shape):
        return _normal((L, *shape), 0.05, cfg.dtype, device, gen)

    return {
        "item_embed": _normal((cfg.n_items, D), 0.01, cfg.dtype, device, gen),
        "pos_embed": _normal((cfg.seq_len, D), 0.01, cfg.dtype, device, gen),
        "blocks": {"wqkv": w((D, 3 * D)), "wo": w((D, D)), "ff1": w((D, D)),
                   "ff2": w((D, D)),
                   "ln1": torch.ones((L, D), dtype=cfg.dtype, device=device),
                   "ln2": torch.ones((L, D), dtype=cfg.dtype, device=device)},
    }


def _ln(x, g, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g


def sasrec_hidden(params, seq_ids, cfg: SASRecConfig, mesh=None):
    S = seq_ids.shape[1]
    D = cfg.embed_dim
    x = take_rows(params["item_embed"], seq_ids) + params["pos_embed"][None, :S]
    # a batch that the mesh does not divide (retrieval_cand's one user)
    # stays whole: DTensor cannot flatten an uneven batch into a product
    whole = mesh is not None and seq_ids.shape[0] % mesh.size()
    x = constrain(x, mesh, None if whole else _ALL, None, None)
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    for i in range(cfg.n_blocks):
        bp = {k: v[i] for k, v in params["blocks"].items()}
        h = _ln(x, bp["ln1"])
        q, k, v = torch.split(h @ bp["wqkv"], D, dim=-1)
        # bmm on a mesh: DTensor's einsum reshapes the batch, which a batch
        # of one split over the mesh cannot take (the same product)
        s = (torch.bmm(q, k.transpose(1, 2)) if isinstance(q, DTensor)
             else torch.einsum("bqd,bkd->bqk", q, k)) / math.sqrt(D)
        s = torch.where(mask[None], s, -1e30)
        x = x + (torch.softmax(s, -1) @ v) @ bp["wo"]
        h2 = _ln(x, bp["ln2"])
        x = x + torch.relu(h2 @ bp["ff1"]) @ bp["ff2"]
    return x                                                  # (B, S, D)


def sasrec_loss(params, batch, cfg: SASRecConfig, mesh=None):
    """BCE over (positive, sampled negative) next items, per position."""
    h = sasrec_hidden(params, batch["seq"], cfg, mesh)
    pos_l = (h * take_rows(params["item_embed"], batch["pos"])).sum(-1)
    neg_l = (h * take_rows(params["item_embed"], batch["neg"])).sum(-1)
    m = batch["seq_mask"]
    loss = (bce_pointwise(pos_l, 1.0) + bce_pointwise(neg_l, 0.0)) * m
    return loss.sum() / torch.clamp(m.sum(), min=1.0)


def sasrec_serve(params, batch, cfg: SASRecConfig, mesh=None):
    """Score candidate items given a user's history (online inference)."""
    h = sasrec_hidden(params, batch["seq"], cfg, mesh)[:, -1]  # (B, D)
    cand = take_rows(params["item_embed"], batch["cands"])    # (B, C, D)
    if isinstance(cand, DTensor):                             # see above
        return torch.bmm(cand, h[:, :, None])[..., 0]
    return torch.einsum("bd,bcd->bc", h, cand)


# ==========================================================================
# DIN
# ==========================================================================


@dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Sequence[int] = (80, 40)
    mlp: Sequence[int] = (200, 80)
    dtype: torch.dtype = torch.float32


def din_init(cfg: DINConfig, device=None, generator=None) -> dict:
    device, gen = _generator(device, generator)
    D = cfg.embed_dim
    return {
        "item_embed": _normal((cfg.n_items, D), 0.01, cfg.dtype, device, gen),
        "attn": _mlp_init((4 * D, *cfg.attn_mlp, 1), cfg.dtype, device, gen),
        "mlp": _mlp_init((2 * D, *cfg.mlp, 1), cfg.dtype, device, gen),
    }


def din_forward(params, batch, cfg: DINConfig, mesh=None):
    hist = take_rows(params["item_embed"], batch["history"])  # (B, L, D)
    hist = constrain(hist, mesh, _ALL, None, None)
    tgt = take_rows(params["item_embed"], batch["target"])    # (B, D)
    t = tgt[:, None, :].expand_as(hist)
    a_in = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    w = _mlp_apply(params["attn"], a_in)[..., 0]              # (B, L)
    w = torch.sigmoid(w) * batch["hist_mask"]
    user = torch.einsum("bl,bld->bd", w, hist)                # weighted sum
    x = torch.cat([user, tgt], dim=-1)
    return _mlp_apply(params["mlp"], x)[:, 0]


def din_loss(params, batch, cfg: DINConfig, mesh=None):
    return bce_loss(din_forward(params, batch, cfg, mesh), batch["label"])


# ==========================================================================
# two-tower retrieval
# ==========================================================================


@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_users_vocab: int = 2_000_000
    n_items: int = 2_000_000
    embed_dim: int = 256
    tower_mlp: Sequence[int] = (1024, 512, 256)
    n_user_feats: int = 8
    dtype: torch.dtype = torch.float32


def twotower_init(cfg: TwoTowerConfig, device=None, generator=None) -> dict:
    device, gen = _generator(device, generator)
    D = cfg.embed_dim
    return {
        "user_table": _normal((cfg.n_users_vocab, D), 0.01, cfg.dtype,
                              device, gen),
        "item_table": _normal((cfg.n_items, D), 0.01, cfg.dtype, device,
                              gen),
        "user_tower": _mlp_init((D, *cfg.tower_mlp), cfg.dtype, device, gen),
        "item_tower": _mlp_init((D, *cfg.tower_mlp), cfg.dtype, device, gen),
    }


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def user_embedding(params, batch, cfg: TwoTowerConfig, mesh=None):
    """(B, D') unit rows from ``batch["user_feats"]`` (B, F) hashed feature
    ids, summed with ``batch["user_mask"]`` (B, F) weights."""
    bag = embedding_bag(params["user_table"], batch["user_feats"],
                        weights=batch["user_mask"], mode="sum")
    return _unit(_mlp_apply(params["user_tower"], bag))


def item_embedding(params, item_ids, cfg: TwoTowerConfig, mesh=None):
    """(*ids.shape, D') unit rows; ids ≥ ``n_items`` read the last row."""
    return _unit(_mlp_apply(params["item_tower"],
                            take_rows(params["item_table"], item_ids)))


def twotower_loss(params, batch, cfg: TwoTowerConfig, mesh=None,
                  tau=0.05):
    """In-batch sampled softmax with logQ correction (Yi et al. '19)."""
    u = user_embedding(params, batch, cfg)                    # (B, D')
    v = item_embedding(params, batch["item"], cfg)            # (B, D')
    logits = ((u @ v.T) / tau - batch["logq"][None, :]).float()
    lse = torch.logsumexp(logits, -1)
    return (lse - logits.diagonal()).mean()


def twotower_serve(params, batch, cfg: TwoTowerConfig, mesh=None):
    """Online inference: score given (user, item) pairs."""
    u = user_embedding(params, batch, cfg)
    v = item_embedding(params, batch["item"], cfg)
    return (u * v).sum(-1)


def twotower_retrieve(params, batch, cfg: TwoTowerConfig, mesh=None):
    """retrieval_cand: score each user against ``batch["cand_ids"]``."""
    u = user_embedding(params, batch, cfg)                    # (B, D')
    cand = item_embedding(params, batch["cand_ids"], cfg)     # (C, D')
    return u @ constrain(cand, mesh, ("data", "model"), None).T


def _tower(layers: list, device) -> nn.Sequential:
    """``nn.Linear`` layers holding ``layers``' ``{"w", "b"}`` (a weight is
    the transpose of ``w``), ReLU between them: called as a module, the
    tower computes what :func:`_mlp_apply` computes over
    :meth:`TwoTower.params`, which serving goes through."""
    mods: list[nn.Module] = []
    for i, lp in enumerate(layers):
        d_in, d_out = lp["w"].shape
        lin = nn.utils.skip_init(nn.Linear, d_in, d_out, device=device,
                                 dtype=lp["w"].dtype)
        with torch.no_grad():
            lin.weight.copy_(lp["w"].T)
            lin.bias.copy_(lp["b"])
        mods.append(lin)
        if i + 1 < len(layers):
            mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class TwoTower(nn.Module):
    """Two-tower retriever on one device, for serving.

    ``device`` None means the card (raises without CUDA).  ``params``, a
    tree laid out as :func:`twotower_init`'s, is adopted (its tables
    without a copy); otherwise :func:`twotower_init` draws one from
    ``generator``.  The tables are ``nn.Embedding``s, the towers
    ``nn.Linear``s; :meth:`params` views them as the functions' tree."""

    def __init__(self, cfg: TwoTowerConfig, device=None,
                 generator: torch.Generator | None = None,
                 params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        if params is None:
            params = twotower_init(cfg, device, generator)
        D, dims = cfg.embed_dim, (cfg.embed_dim, *cfg.tower_mlp)
        tower = [{"w": (i, o), "b": (o,)} for i, o in zip(dims[:-1], dims[1:])]
        want = {"user_table": (cfg.n_users_vocab, D),
                "item_table": (cfg.n_items, D),
                "user_tower": tower, "item_tower": tower}
        got = tree.tree_map(lambda t: tuple(t.shape), params)
        if got != want:
            raise ValueError(f"parameters of shapes {got}, the config "
                             f"needs {want}")
        params = tree.tree_map(lambda t: t.to(device=device, dtype=cfg.dtype),
                               params)
        self.cfg = cfg
        self.user_table = nn.Embedding.from_pretrained(params["user_table"],
                                                       freeze=False)
        self.item_table = nn.Embedding.from_pretrained(params["item_table"],
                                                       freeze=False)
        self.user_tower = _tower(params["user_tower"], device)
        self.item_tower = _tower(params["item_tower"], device)

    @property
    def device(self) -> torch.device:
        return self.item_table.weight.device

    def params(self) -> dict:
        """The parameter tree the functions take (views, no copies)."""
        def layers(seq):
            return [{"w": m.weight.T, "b": m.bias} for m in seq
                    if isinstance(m, nn.Linear)]
        return {"user_table": self.user_table.weight,
                "item_table": self.item_table.weight,
                "user_tower": layers(self.user_tower),
                "item_tower": layers(self.item_tower)}

    def user_embedding(self, batch: dict) -> torch.Tensor:
        return user_embedding(self.params(), batch, self.cfg)

    def item_embedding(self, item_ids: torch.Tensor) -> torch.Tensor:
        return item_embedding(self.params(), item_ids, self.cfg)

    def serve(self, batch: dict) -> torch.Tensor:
        """The reference's ``twotower_serve``: (B,) scores of given (user,
        ``batch["item"]``) pairs."""
        return twotower_serve(self.params(), batch, self.cfg)

    def retrieve(self, batch: dict) -> torch.Tensor:
        """The reference's ``twotower_retrieve``: (B, C) scores of each user
        against ``batch["cand_ids"]`` (C,), a plain matrix product."""
        return twotower_retrieve(self.params(), batch, self.cfg)


# ==========================================================================
# generic step factory
# ==========================================================================


def make_train_step(loss_fn, optimizer_update):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    loss, gnorm) for ``loss_fn(params, batch)``, a scalar.

    The gradient of every leaf of ``params`` (a tree of tensors; a leaf
    the loss does not reach gets zeros) goes to ``optimizer_update(params,
    grads, opt_state) -> (params, opt_state, gnorm)``, in place for
    :func:`..optim.adamw_update`.  The reference's rule for a non-finite
    loss holds as in ``models.lm.make_train_step``: the step reads
    ``torch.isfinite(loss)`` on the host before it updates and, where the
    loss is not finite, returns the parameters, moments and step counter
    untouched with the gradient's global norm.  A loss that is a DTensor
    (a mesh's cell, ``configs.common``) is applied whatever it is, with no
    read on the host, as the reference's step does."""

    def train_step(params, opt_state, batch):
        flat, treedef = tree.flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        loss = loss_fn(tree.unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        del leaves
        grads = tree.unflatten(treedef, list(grads))
        loss = loss.detach()
        if not isinstance(loss, DTensor) and not torch.isfinite(loss):
            return params, opt_state, loss, global_norm(grads)
        params, opt_state, gnorm = optimizer_update(params, grads, opt_state)
        return params, opt_state, loss, gnorm

    return train_step
