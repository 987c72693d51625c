"""SchNet (Schütt et al., arXiv:1706.08566), a continuous-filter conv GNN.

Ported from the JAX package's ``src/repro/models/gnn.py``.  Message passing
is an edge gather (:func:`..sparse.ops.take_rows`, JAX's clamped gather:
an out-of-range source id reads a clamped row) and a scatter
(:func:`..sparse.ops.segment_sum`, which drops an out-of-range
destination).  The parameters are the reference's tree: ``embed_in``,
``read1``, ``read2`` and ``inter``, whose leaves are stacked on a leading
axis of ``n_interactions`` (one interaction too), each a ``{"w": (in,
out), "b": (out,)}``; ``convert.gnn_from_jax`` carries the reference's
across.

One model covers the four graph shapes of ``configs/common.py``:

  * molecule: batched small graphs, a sum-pooled energy regression;
  * full_graph_sm / ogb_products: one graph, a node classification head
    (features are projected into the hidden width; pairwise "distances"
    are supplied as edge features);
  * minibatch_lg: fanout-sampled blocks from ``data/graph.py``, the model
    consuming the flattened union subgraph with edge masks.

Edge chunks: with ``edge_chunk`` set the continuous-filter conv runs over
the edges a chunk at a time, in the reference's order, each chunk under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` inside a
``lax.scan``), so that only one chunk's (chunk, n_rbf) expansion is alive
in the forward and in the backward: at ogb_products the whole expansion is
74 GB an interaction.  Unchunked, the one chunk is all the edges, under
the checkpoint too.

The mesh: :func:`forward`, :func:`graph_loss` and :func:`make_train_step`
take ``mesh=None``.  With a ``DeviceMesh`` and DTensor inputs
(``configs.common.GNNArch.build``) the reference's two constraints put
each chunk's radial basis and messages over the whole mesh, edges split
over ("pod", "data", "model"); the gather of the node states reads a
copy gathered whole (it is smaller than the rows looked up), and
``segment_sum`` adds each rank's own messages into a full node buffer,
partial over the mesh (the reference's all-reduce after its segment
sum).  An edge chunk is each rank's own slice of its edge shard
(``local_slice``), so a chunk holds other edges than the reference's
chunk of the same number; the chunks' sum is the same up to float32
rounding.  With ``mesh=None`` nothing changes.
:func:`init_params` draws the reference's distributions on the device
from an explicit ``torch.Generator``; the same seed gives other numbers
than ``jax.random``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..core.device_index import resolve_device
from ..distributed.sharding import constrain, local_slice
from ..sparse.ops import segment_sum, take_rows
from .recsys import make_train_step as _make_loss_step


@dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_feat: int = 16          # input feature width (arch-shape dependent)
    n_out: int = 1            # 1 = regression; >1 = node classification
    dtype: torch.dtype = torch.float32
    # edges a checkpointed chunk of the cfconv (None: all of them)
    edge_chunk: int | None = None


_LOG2 = math.log(2.0)


def ssp(x):
    """Shifted softplus, SchNet's activation.  ``F.softplus`` returns x
    itself above x = 20, where JAX's ``softplus`` computes log1p(exp(-x))
    + x; the two differ there by less than 2e-9."""
    return F.softplus(x) - _LOG2


def init_params(cfg: SchNetConfig, device=None, generator=None) -> dict:
    """The reference's initial distributions drawn on ``device`` (None
    means the card) from ``generator`` (default one seeded with 0): each
    ``w`` N(0, 1)/sqrt(in), each ``b`` zero."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dh, nr = cfg.d_hidden, cfg.n_rbf

    def lin(i, o):
        w = torch.empty((i, o), dtype=cfg.dtype, device=device).normal_(
            generator=generator)
        return {"w": w / math.sqrt(i),
                "b": torch.zeros((o,), dtype=cfg.dtype, device=device)}

    embed_in, read1, read2 = (lin(cfg.d_feat, dh), lin(dh, dh // 2),
                              lin(dh // 2, cfg.n_out))
    inter = [{"filt1": lin(nr, dh), "filt2": lin(dh, dh),
              "in_lin": lin(dh, dh), "out1": lin(dh, dh),
              "out2": lin(dh, dh)} for _ in range(cfg.n_interactions)]
    flat = [tree.flatten(lp)[0] for lp in inter]
    treedef = tree.flatten(inter[0])[1]
    return {"embed_in": embed_in,
            "inter": tree.unflatten(treedef,
                                    [torch.stack(xs) for xs in zip(*flat)]),
            "read1": read1, "read2": read2}


def _ap(lp, x):
    return x @ lp["w"] + lp["b"]


def rbf_expand(dist, cfg: SchNetConfig):
    """Gaussian radial basis of each distance: (E, n_rbf)."""
    centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, dtype=dist.dtype,
                             device=dist.device)
    gamma = cfg.n_rbf / cfg.cutoff
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


def forward(params, batch, cfg: SchNetConfig, mesh=None):
    """batch: node_feat (N, d_feat), src/dst (E,), dist (E,), edge_mask (E,).

    Returns per-node hidden (N, d_hidden) transformed to (N, n_out).
    """
    x = ssp(_ap(params["embed_in"], batch["node_feat"]))   # (N, dh)
    src, dst, dist = batch["src"], batch["dst"], batch["dist"]
    emask = batch["edge_mask"].to(cfg.dtype)
    N, E = x.shape[0], src.shape[0]
    ec = cfg.edge_chunk or E
    n_chunks = max(1, E // ec)
    if n_chunks == 1:
        ec = E
    elif n_chunks * ec != E:
        raise ValueError(f"{E} edges do not split into chunks of {ec}")

    def cfconv_chunk(h, dist_c, src_c, dst_c, emask_c, lp):
        """One edge chunk of the continuous-filter conv."""
        rbf = rbf_expand(dist_c, cfg)                        # (ec, n_rbf)
        rbf = constrain(rbf, mesh, ("pod", "data", "model"), None)
        filt = _ap(lp["filt2"], ssp(_ap(lp["filt1"], rbf)))  # (ec, dh)
        msg = take_rows(h, src_c) * filt * emask_c[:, None]  # cfconv
        msg = constrain(msg, mesh, ("pod", "data", "model"), None)
        return segment_sum(msg, dst_c, N)

    def interaction(x, lp):
        h = _ap(lp["in_lin"], x)
        agg = None
        for c in range(n_chunks):
            out = checkpoint(cfconv_chunk, h,
                             *(local_slice(t, n_chunks, c)
                               for t in (dist, src, dst, emask)),
                             lp, use_reentrant=False)
            agg = out if agg is None else agg + out
        v = _ap(lp["out2"], ssp(_ap(lp["out1"], agg)))
        return x + v

    for i in range(cfg.n_interactions):
        x = interaction(x, tree.tree_map(lambda a: a[i], params["inter"]))
    return _ap(params["read2"], ssp(_ap(params["read1"], x)))


def graph_loss(params, batch, cfg: SchNetConfig, n_graphs: int = 1,
               mesh=None):
    """Regression (graph-pooled) or node classification, by config.  A
    label out of range gives a NaN loss, as JAX's ``take_along_axis``
    fills it (a negative label counts from the end)."""
    out = forward(params, batch, cfg, mesh)                # (N, n_out)
    if cfg.n_out == 1:
        # molecule energies: sum-pool per graph via graph_ids
        energy = segment_sum(out[:, 0] * batch["node_mask"],
                             batch["graph_ids"], n_graphs)
        return torch.mean(torch.square(energy - batch["target"]))
    logits = out.float()
    lse = torch.logsumexp(logits, -1)
    n = logits.shape[-1]
    lab = batch["labels"].long()
    lab = torch.where(lab < 0, lab + n, lab)
    inside = (lab >= 0) & (lab < n)
    gold = logits.gather(-1, lab.clamp(0, n - 1)[:, None])[:, 0]
    gold = torch.where(inside, gold, torch.nan)
    mask = batch["node_mask"]
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


def make_train_step(cfg: SchNetConfig, optimizer_update, n_graphs: int = 1,
                    mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    loss, gnorm) over :func:`graph_loss`, with ``models.recsys``'s rule for
    a non-finite loss (nothing is updated; on a mesh the update is applied
    whatever the loss, as the reference's step does)."""
    return _make_loss_step(
        lambda p, b: graph_loss(p, b, cfg, n_graphs, mesh), optimizer_update)


def input_specs(cfg: SchNetConfig, n_nodes: int, n_edges: int,
                n_graphs: int = 1, classify: bool = False) -> dict:
    """The batch's keys as meta tensors (shape and dtype)."""
    def S(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    f32, i32 = torch.float32, torch.int32
    specs = {
        "node_feat": S((n_nodes, cfg.d_feat), f32),
        "src": S((n_edges,), i32), "dst": S((n_edges,), i32),
        "dist": S((n_edges,), f32), "edge_mask": S((n_edges,), torch.bool),
        "node_mask": S((n_nodes,), f32),
    }
    if classify:
        specs["labels"] = S((n_nodes,), i32)
    else:
        specs["graph_ids"] = S((n_nodes,), i32)
        specs["target"] = S((n_graphs,), f32)
    return specs
