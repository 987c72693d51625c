"""Family adapters: a model config and a shape id become a cell of the
dry run.

Ported from the JAX package's ``src/repro/configs/common.py``:
:data:`LM_SHAPES` and :class:`LMArch`; :data:`GNN_SHAPES`,
:func:`_pad512` and :class:`GNNArch` with ``cfg_for`` (the shape's
feature width, head and edge chunks); and :data:`REC_SHAPES` and
:class:`RecsysArch` with the batch shapes of each recsys model, its loss,
serve and init functions and ``_pshard``.  Each has its analytic
``flops`` and ``build(mesh, shape_id)``, which returns a :class:`Cell`:
the function of one step, its arguments as ``meta`` tensors (never
allocated at full size), each argument's placements on ``mesh`` in
``distributed.sharding.tree_shardings``' form (a flat list in JAX's leaf
order), the analytic MODEL_FLOPS, the donated arguments and the
reference's notes and ``cost_scale``.  The function takes DTensors laid
out so and runs under ``implicit_replication`` (a plain tensor it makes,
such as a mask, counts as replicated).  ``launch/dryrun.py`` runs it on
fake tensors over a fake world; ``chip_smoke.py`` on a card.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Any, Callable

import torch
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.experimental import implicit_replication

from .. import tree
from ..distributed.sharding import (batch_axes, lm_param_rules, local_cat,
                                    local_slice, placements, tree_shardings)
from ..models import gnn as gnn_mod
from ..models import lm as lm_mod
from ..models import recsys as rec_mod
from ..models.gnn import SchNetConfig
from ..models.lm import LMConfig
from ..optim.adamw import adamw_init, adamw_update


@dataclass
class Cell:
    arch_id: str
    shape_id: str
    kind: str                    # train_step | serve_step | prefill | query
    fn: Callable
    args: tuple                  # meta tensors (trees allowed)
    in_shardings: Any            # per argument, tree_shardings' flat list
    model_flops: float
    notes: str = ""
    donate_argnums: tuple = ()
    # the reference's trip count of its chunking scan (XLA counts a while
    # body once); the port's eager trace counts every chunk, so its dry
    # run does not scale by it
    cost_scale: float = 1.0


def _implicit(fn):
    """``fn`` run under ``implicit_replication``."""
    @functools.wraps(fn)
    def run(*args):
        with implicit_replication():
            return fn(*args)
    return run


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _spec(mesh, x, *spec) -> tuple:
    return placements(spec, x.dim(), mesh)


def _replicated(tree_, mesh) -> list:
    return [(Replicate(),) * mesh.ndim for _ in tree.leaves(tree_)]


def _batch_shardings(specs: dict, mesh, dp) -> list:
    """A batch dict's placements: every leaf split along dimension 0 over
    ``dp``, in sorted-key order."""
    return [_spec(mesh, v, dp) for _, v in sorted(specs.items())]


def adamw_like_shardings(pshard: list, mesh) -> list:
    """AdamW state placements (the reference's ``adamw_like_shardings``):
    the step counter replicated, mu and nu mirroring the parameters."""
    return [(Replicate(),) * mesh.ndim, *pshard, *pshard]

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

    def build(self, mesh, shape_id: str, probe_layers: int | None = None
              ) -> Cell:
        """The cell of ``shape_id`` on ``mesh``: train (params, AdamW
        state, batch; both donated), prefill (params, tokens) or decode
        (params, cache, token at the last position; the cache donated).
        ``probe_layers`` gives the reference's probe cell: that many
        layers, one microbatch, chunks of half the sequence, no remat."""
        s = LM_SHAPES[shape_id]
        cfg = self.cfg
        if probe_layers is not None:
            half = max(256, s["seq"] // 2)
            cfg = replace(cfg, probe_layers=probe_layers, probe_unroll=True,
                          microbatch=1, q_chunk=half, kv_chunk=half,
                          loss_chunk=half, remat=False)
        rules = lm_param_rules(mesh)
        shapes = lm_mod.param_shapes(cfg)
        pshape = {k: ({n: _meta(sh, cfg.dtype) for n, sh in v.items()}
                      if k == "layers" else _meta(v, cfg.dtype))
                  for k, v in shapes.items()}
        pshard = tree_shardings(pshape, mesh, rules)
        dp = batch_axes(mesh)
        B, S = s["batch"], s["seq"]

        if s["kind"] == "train":
            opt_shape = adamw_init(pshape, state_dtype=cfg.opt_dtype)
            opt_shard = tree_shardings(opt_shape, mesh, rules)
            batch = {"tokens": _meta((B, S), torch.int32),
                     "labels": _meta((B, S), torch.int32)}
            step = lm_mod.make_train_step(
                cfg, lambda p, g, st: adamw_update(p, g, st, 3e-4),
                mesh=mesh, param_shardings=pshard)
            return Cell(self.arch_id, shape_id, "train_step", _implicit(step),
                        (pshape, opt_shape, batch),
                        (pshard, opt_shard,
                         _batch_shardings(batch, mesh, dp)),
                        self.flops(shape_id),
                        donate_argnums=(0, 1) if probe_layers is None
                        else ())
        if s["kind"] == "prefill":
            tokens = _meta((B, S), torch.int32)
            return Cell(self.arch_id, shape_id, "serve_step",
                        _implicit(lm_mod.make_prefill_step(cfg, mesh)),
                        (pshape, tokens),
                        (pshard, [_spec(mesh, tokens, dp)]),
                        self.flops(shape_id))
        # decode: serve_step(params, cache, token, pos)
        cache = lm_mod.make_cache_shape(cfg, B, S)
        model = mesh.shape[mesh.mesh_dim_names.index("model")]
        if B >= mesh.size() // model:
            cspec, tokspec = (None, dp, None, "model"), (dp,)  # batch-sharded
        else:
            cspec, tokspec = (None, None, dp, "model"), ()  # sequence-sharded
        token = _meta((B,), torch.int32)
        serve = lm_mod.make_serve_step(cfg, mesh)
        pos = S - 1

        def step(params, cache_, token_):
            return serve(params, cache_, token_, pos)

        return Cell(self.arch_id, shape_id, "serve_step", _implicit(step),
                    (pshape, cache, token),
                    (pshard, [_spec(mesh, c, *cspec)
                              for _, c in sorted(cache.items())],
                     [_spec(mesh, token, *tokspec)]),
                    self.flops(shape_id),
                    donate_argnums=(1,) if probe_layers is None else ())


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

    def build(self, mesh, shape_id: str) -> Cell:
        """The train cell of ``shape_id`` on ``mesh``: nodes and edges
        (padded to 512) split over the whole mesh, SchNet having no tensor
        dimension for "model"; parameters and AdamW state replicated."""
        s = GNN_SHAPES[shape_id]
        cfg = self.cfg_for(shape_id)
        dp = tuple(a for a in ("pod", "data", "model")
                   if a in mesh.mesh_dim_names)
        e_pad = _pad512(s["n_edges"])
        specs = gnn_mod.input_specs(cfg, _pad512(s["n_nodes"]), e_pad,
                                    n_graphs=s.get("n_graphs", 1),
                                    classify=bool(s["classify"]))
        bshard = [_spec(mesh, v, *(() if k == "target" else (dp,)))
                  for k, v in sorted(specs.items())]
        pshape = gnn_mod.init_params(cfg, "meta", torch.Generator())
        opt_shape = adamw_init(pshape)
        step = gnn_mod.make_train_step(
            cfg, lambda p, g, st: adamw_update(p, g, st, 1e-3),
            s.get("n_graphs", 1), mesh)
        n_chunks = (e_pad // cfg.edge_chunk) if cfg.edge_chunk else 1
        return Cell(self.arch_id, shape_id, "train_step", _implicit(step),
                    (pshape, opt_shape, specs),
                    (_replicated(pshape, mesh), _replicated(opt_shape, mesh),
                     bshard), self.flops(shape_id),
                    donate_argnums=(0, 1), cost_scale=float(n_chunks),
                    notes="edge-chunked cfconv" if n_chunks > 1 else "")


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

    def loss_and_serve(self, mesh=None):
        """(loss_fn(params, batch), serve_fn(params, batch)) of the
        model, on ``mesh`` where one is given."""
        c = self.cfg
        loss, serve = {
            "dlrm": (rec_mod.dlrm_loss, rec_mod.dlrm_forward),
            "sasrec": (rec_mod.sasrec_loss, rec_mod.sasrec_serve),
            "din": (rec_mod.din_loss, rec_mod.din_forward),
            "twotower": (rec_mod.twotower_loss, rec_mod.twotower_serve),
        }[self.kind]
        return ((lambda p, b: loss(p, b, c, mesh)),
                (lambda p, b: serve(p, b, c, mesh)))

    def _pshard(self, pshape, mesh) -> list:
        """Embedding tables of more than 100,000 rows split by rows over
        the whole mesh; every other leaf replicated."""
        all_axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.mesh_dim_names)

        def pick(name, leaf):
            if ("table" in name or "embed" in name) and leaf.dim() == 2 \
                    and leaf.shape[0] > 100_000:
                return _spec(mesh, leaf, all_axes, None)
            return (Replicate(),) * mesh.ndim

        return [pick(n, leaf) for n, leaf in zip(tree.path_names(pshape),
                                                 tree.leaves(pshape))]

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

    def build(self, mesh, shape_id: str) -> Cell:
        """The cell of ``shape_id`` on ``mesh``: the batch split over the
        whole mesh (the recsys models have no tensor dimension for
        "model"), tables row-split (``_pshard``).  retrieval_cand scores
        1,000,000 candidates (padded to 512) for one user context: the
        two-tower model in one product, SASRec through its serve function
        (the candidates ride dimension 1), DLRM and DIN in 16 chunks of
        the candidates, each rank scoring the chunk of its own shard."""
        s = REC_SHAPES[shape_id]
        dp = tuple(a for a in ("pod", "data", "model")
                   if a in mesh.mesh_dim_names)
        loss_fn, serve_fn = self.loss_and_serve(mesh)
        pshape = self.init("meta", torch.Generator())
        pshard = self._pshard(pshape, mesh)
        if s["kind"] == "train":
            specs = self._batch_specs(s["batch"])
            opt_shape = adamw_init(pshape)
            step = rec_mod.make_train_step(
                loss_fn, lambda p, g, st: adamw_update(p, g, st, 1e-3))
            return Cell(self.arch_id, shape_id, "train_step", _implicit(step),
                        (pshape, opt_shape, specs),
                        (pshard, adamw_like_shardings(pshard, mesh),
                         _batch_shardings(specs, mesh, dp)),
                        self.flops(shape_id), donate_argnums=(0, 1))
        if s["kind"] == "serve":
            specs = self._batch_specs(s["batch"], serve=True)
            return Cell(self.arch_id, shape_id, "serve_step",
                        _implicit(serve_fn), (pshape, specs),
                        (pshard, _batch_shardings(specs, mesh, dp)),
                        self.flops(shape_id))
        C = _pad512(s["n_candidates"])
        if self.kind == "twotower":
            c = self.cfg
            specs = {"user_feats": _meta((1, c.n_user_feats), torch.int32),
                     "user_mask": _meta((1, c.n_user_feats), torch.float32),
                     "cand_ids": _meta((C,), torch.int32)}
            bshard = [_spec(mesh, v, *((dp,) if k == "cand_ids" else ()))
                      for k, v in sorted(specs.items())]

            def fn(p, b, _cfg=c):
                return rec_mod.twotower_retrieve(p, b, _cfg, mesh)

            return Cell(self.arch_id, shape_id, "serve_step", _implicit(fn),
                        (pshape, specs), (pshard, bshard),
                        self.flops(shape_id))
        specs = self._retrieval_specs(C)
        bshard = [_spec(mesh, v, *((dp,) if v.shape[0] == C else ()))
                  for _, v in sorted(specs.items())]
        cost_scale = 1.0
        if self.kind == "sasrec":
            fn = serve_fn  # candidates ride dim 1; no big gather
        else:
            n_chunks = 16
            cost_scale = float(n_chunks)

            def fn(p, b, _serve=serve_fn, _C=C, _n=n_chunks):
                big = {k: v for k, v in b.items() if v.shape[0] == _C}
                small = {k: v for k, v in b.items() if v.shape[0] != _C}
                return local_cat([
                    _serve(p, {**{k: local_slice(v, _n, i)
                                  for k, v in big.items()}, **small})
                    for i in range(_n)])

        return Cell(self.arch_id, shape_id, "serve_step", _implicit(fn),
                    (pshape, specs), (pshard, bshard), self.flops(shape_id),
                    cost_scale=cost_scale,
                    notes="chunked candidate scoring" if cost_scale > 1
                    else "")

    def _retrieval_specs(self, C: int) -> dict:
        """retrieval_cand's inputs for C candidates (DLRM, SASRec, DIN)."""
        f32, i32 = torch.float32, torch.int32
        c = self.cfg
        if self.kind == "dlrm":
            return {"dense": _meta((C, c.n_dense), f32),
                    "sparse": _meta((C, len(c.table_rows)), i32)}
        if self.kind == "sasrec":
            return {"seq": _meta((1, c.seq_len), i32),
                    "cands": _meta((1, C), i32)}
        if self.kind == "din":
            return {"history": _meta((C, c.seq_len), i32),
                    "hist_mask": _meta((C, c.seq_len), f32),
                    "target": _meta((C,), i32)}
        raise ValueError(self.kind)
