"""The LM, GNN and recsys families' shapes and architecture records.

Ported from the JAX package's ``src/repro/configs/common.py``:
:data:`LM_SHAPES` and :class:`LMArch` with its analytic ``flops``;
:data:`GNN_SHAPES`, :func:`_pad512` and :class:`GNNArch` with
``cfg_for`` (the shape's feature width, head and edge chunks) and its
analytic ``flops``; and :data:`REC_SHAPES` and :class:`RecsysArch` with
the batch shapes of each recsys model, its loss, serve and init
functions, and its analytic ``flops``.  The reference's ``build``
methods, which lower a JAX ``Cell`` with shardings for its HLO dry-run,
and ``RecsysArch._pshard``, the tables' mesh specs, are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from ..models import recsys as rec_mod
from ..models.gnn import SchNetConfig
from ..models.lm import LMConfig

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


@dataclass
class LMArch:
    arch_id: str
    cfg: LMConfig
    family: str = "lm"
    shapes: tuple = tuple(LM_SHAPES)

    def flops(self, shape_id: str) -> float:
        s = LM_SHAPES[shape_id]
        cfg = self.cfg
        n_act = cfg.active_params_count
        if s["kind"] == "train":
            toks = s["seq"] * s["batch"]
            return 6.0 * n_act * toks
        if s["kind"] == "prefill":
            toks = s["seq"] * s["batch"]
            attn = (4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head
                    * s["seq"] * toks / 2)  # causal half
            return 2.0 * n_act * toks + attn
        # decode: one token per sequence against a seq-long cache
        toks = s["batch"]
        attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * s["seq"] * toks
        return 2.0 * n_act * toks + attn


# ==========================================================================
# GNN family (SchNet)
# ==========================================================================

def _pad512(n: int) -> int:
    """Round node/edge counts up to 512, as the reference pads them for
    its meshes (the padding is masked)."""
    return (n + 511) // 512 * 512


GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          classify=47, kind="train"),
    "minibatch_lg": dict(n_nodes=184320, n_edges=179200, d_feat=602,
                         classify=41, kind="train"),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                         classify=47, kind="train"),
    "molecule": dict(n_nodes=3840, n_edges=8192, d_feat=16, classify=0,
                     n_graphs=128, kind="train"),
}


@dataclass
class GNNArch:
    arch_id: str
    base_cfg: SchNetConfig
    family: str = "gnn"
    shapes: tuple = tuple(GNN_SHAPES)

    def cfg_for(self, shape_id: str) -> SchNetConfig:
        """The config at ``shape_id``: its feature width, its head (47 or
        41 classes, or the regression's 1) and, past 4 Mi padded edges, 16
        edge chunks."""
        s = GNN_SHAPES[shape_id]
        e_pad = _pad512(s["n_edges"])
        # chunk the cfconv at >4M edges (ogb_products: 74 GB rbf otherwise)
        chunk = e_pad // 16 if e_pad > (1 << 22) else None
        return replace(self.base_cfg, d_feat=s["d_feat"],
                       n_out=(s["classify"] or 1), edge_chunk=chunk)

    def flops(self, shape_id: str) -> float:
        """The reference's analytic flops of one train step at
        ``shape_id`` (the real, unpadded counts)."""
        s = GNN_SHAPES[shape_id]
        c = self.base_cfg
        e, n, dh, nr = s["n_edges"], s["n_nodes"], c.d_hidden, c.n_rbf
        per_layer = 2.0 * e * (nr * dh + dh * dh) + 2.0 * n * 2 * dh * dh
        proj = 2.0 * n * s["d_feat"] * dh
        fb = 3.0  # fwd + bwd
        return fb * (c.n_interactions * per_layer + proj)


# ==========================================================================
# RecSys family
# ==========================================================================

REC_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieve"),
}


@dataclass
class RecsysArch:
    arch_id: str
    cfg: Any
    kind: str                    # dlrm | sasrec | din | twotower
    family: str = "recsys"
    shapes: tuple = tuple(REC_SHAPES)

    def _batch_specs(self, B: int, serve: bool = False) -> dict:
        """The batch of ``B`` examples as meta tensors (shape and dtype),
        with the reference's keys."""
        def S(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        f32, i32 = torch.float32, torch.int32
        c = self.cfg
        if self.kind == "dlrm":
            sp = {"dense": S((B, c.n_dense), f32),
                  "sparse": S((B, len(c.table_rows)), i32)}
            if not serve:
                sp["label"] = S((B,), f32)
            return sp
        if self.kind == "sasrec":
            sp = {"seq": S((B, c.seq_len), i32)}
            if serve:
                sp["cands"] = S((B, 100), i32)
            else:
                sp.update(pos=S((B, c.seq_len), i32),
                          neg=S((B, c.seq_len), i32),
                          seq_mask=S((B, c.seq_len), f32))
            return sp
        if self.kind == "din":
            sp = {"history": S((B, c.seq_len), i32),
                  "hist_mask": S((B, c.seq_len), f32),
                  "target": S((B,), i32)}
            if not serve:
                sp["label"] = S((B,), f32)
            return sp
        if self.kind == "twotower":
            sp = {"user_feats": S((B, c.n_user_feats), i32),
                  "user_mask": S((B, c.n_user_feats), f32),
                  "item": S((B,), i32)}
            if not serve:
                sp.update(logq=S((B,), f32))
            return sp
        raise ValueError(self.kind)

    def loss_and_serve(self):
        """(loss_fn(params, batch), serve_fn(params, batch)) of the
        model."""
        c = self.cfg
        loss, serve = {
            "dlrm": (rec_mod.dlrm_loss, rec_mod.dlrm_forward),
            "sasrec": (rec_mod.sasrec_loss, rec_mod.sasrec_serve),
            "din": (rec_mod.din_loss, rec_mod.din_forward),
            "twotower": (rec_mod.twotower_loss, rec_mod.twotower_serve),
        }[self.kind]
        return (lambda p, b: loss(p, b, c)), (lambda p, b: serve(p, b, c))

    def init(self, device=None, generator=None) -> dict:
        """The model's parameters drawn on ``device`` (None means the
        card) from ``generator``."""
        return {"dlrm": rec_mod.dlrm_init, "sasrec": rec_mod.sasrec_init,
                "din": rec_mod.din_init,
                "twotower": rec_mod.twotower_init}[self.kind](
                    self.cfg, device, generator)

    def flops(self, shape_id: str, batch: int | None = None) -> float:
        """The reference's analytic flops of ``shape_id``; ``batch``, where
        given, takes the place of the shape's batch (the two-tower's (B, B)
        logits grow with its square)."""
        s = REC_SHAPES[shape_id]
        c = self.cfg
        B = s["batch"] if batch is None else batch
        if self.kind == "dlrm":
            bot = sum(2 * i * o for i, o in zip(
                (c.n_dense, *c.bot_mlp[:-1]), c.bot_mlp))
            n = len(c.table_rows) + 1
            inter = 2 * n * n * c.embed_dim
            top_in = c.embed_dim + n * (n - 1) // 2
            top = sum(2 * i * o for i, o in zip(
                (top_in, *c.top_mlp[:-1]), c.top_mlp))
            per = bot + inter + top
        elif self.kind == "sasrec":
            D, S = c.embed_dim, c.seq_len
            per = c.n_blocks * (2 * S * 3 * D * D + 4 * S * S * D
                                + 2 * S * 2 * D * D)
        elif self.kind == "din":
            D, L = c.embed_dim, c.seq_len
            attn = sum(2 * i * o for i, o in zip(
                (4 * D, *c.attn_mlp), (*c.attn_mlp, 1)))
            mlp = sum(2 * i * o for i, o in zip(
                (2 * D, *c.mlp), (*c.mlp, 1)))
            per = L * attn + mlp + 2 * L * D
        else:  # twotower
            D = c.embed_dim
            tower = sum(2 * i * o for i, o in zip(
                (D, *c.tower_mlp[:-1]), c.tower_mlp))
            per = 2 * tower
        mult = 3.0 if s["kind"] == "train" else 1.0
        flops = mult * B * per
        if self.kind == "twotower" and s["kind"] == "train":
            # in-batch sampled softmax: the (B, B) logits matmul dominates
            flops += mult * 2.0 * B * B * self.cfg.tower_mlp[-1]
        if s["kind"] == "retrieve":
            C = s["n_candidates"]
            if self.kind == "twotower":
                tower = sum(2 * i * o for i, o in zip(
                    (self.cfg.embed_dim, *self.cfg.tower_mlp[:-1]),
                    self.cfg.tower_mlp))
                flops = C * tower + 2 * C * self.cfg.tower_mlp[-1]
            else:
                flops = per * C
        return float(flops)
