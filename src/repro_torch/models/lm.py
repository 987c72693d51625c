"""Transformer LM family: dense + MoE, GQA, RoPE, SwiGLU.

Ported from the JAX package's ``src/repro/models/lm.py``.  One
implementation covers the five LM architectures of ``configs/``
(llama4-scout, granite-moe, granite-3-2b, llama3.2-3b, mistral-large).  The
parameters keep the reference's layout: a dict with ``embed`` (Vp, D),
``ln_f`` (D,), ``out_proj`` (D, Vp) and ``layers``, whose entries are
stacked (L, ...).  :class:`LM` holds them as an ``nn.Module`` with
``prefill`` and ``decode``; the functional forms (:func:`forward`,
:func:`lm_loss`, :func:`make_train_step`, :func:`make_prefill_step`,
:func:`make_serve_step`) take the dict, as the reference's do, so the tests
hold each against its counterpart.

What stays the reference's arithmetic:

* :func:`flash_attention` is the reference's chunked running-softmax
  algorithm in torch ops (q chunks, kv chunks, running max/denominator/
  accumulator; the causal mask fills -1e30, the running max starts at
  -inf, the denominator is floored at 1e-20).  Where the reference asks
  XLA for float32 products of bf16 operands (``preferred_element_type``),
  the operands are cast to float32 first, and the results are cast back
  where the reference casts them.  A kv chunk that lies wholly after a q
  chunk is skipped: in the reference's scan it adds exactly zero (its
  scores are -1e30 below a finite running max), so the result is the same.
* :func:`moe_ffn` is the reference's sort-based dispatch: the capacity
  ``C = max(8, min(int(cf·N·K/E), N))`` from the static N, a stable sort by
  expert, every padded expert computed at capacity C on zero rows, clipped
  gathers, and the same tokens dropped.  Top-k breaks ties towards the
  lower expert index, as ``lax.top_k`` does (a stable descending sort),
  and the per-expert counts are a scatter-add rather than
  ``torch.bincount``, which reads its maximum back to the host on CUDA:
  nothing in the function waits for the card.
* Logits keep the padded vocabulary columns; callers take
  ``logits[:, :cfg.vocab]``.  :func:`lm_loss` fills them with -1e30, as
  the reference's loss does.
* Training: :func:`lm_loss` is the reference's chunked cross-entropy and
  :func:`make_train_step` its microbatched step, gradients accumulated in
  the parameters' dtype.  ``cfg.remat`` puts each layer under
  ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
  scan body).  The backward pass is deterministic by construction: the
  gathers (``embed[tokens]``, the MoE's ``x[order // K]``, ``sorted_tok``
  and ``flat_out[src]``) go back through ``index_put_(accumulate=True)``,
  which PyTorch computes on CUDA by sorting the indices and adding each
  row's contributions in that order, and ``moe_ffn``'s one ``index_add_``
  adds integers (the counts), which carry no gradient.  So a run resumed
  from a checkpoint gives the bits of one that never stopped.

The mesh: :func:`forward`, :func:`lm_loss`, :func:`moe_ffn`,
:func:`make_prefill_step`, :func:`make_serve_step` and
:func:`make_train_step` take ``mesh=None``.  With a ``DeviceMesh`` and
parameters and inputs that are DTensors on it (``configs.common.LMArch.
build``), the reference's constraints are put back where it has them
(``..distributed.sharding.constrain`` redistributes a DTensor): the
activations batch-sharded over ("pod", "data"), the query heads over
"model", the layer boundaries as ``_boundary_constraint`` says
(``act_shard``), the MoE's dispatch and combine, the loss's logits with
the vocabulary over "model", and the train step's gradients pinned to the
parameters' placements (``param_shardings``).  The embedding and the
gold logit are read where the vocabulary lies (``take_rows``, a masked
gather from each rank's rows), and a microbatch is each rank's own slice
of its batch shard (``local_slice``).  With ``mesh=None`` every path
computes what it did without one, bit for bit; ``lax.scan`` over layers
and over loss chunks is a Python loop either way.

The probe mode: ``probe_layers`` runs that many layers (layer ``i %
n_layers``'s weights), as the reference's dry-run probes do, and
``probe_unroll`` is kept for parity and changes nothing here, since the
loops are Python loops already.  The reference's ``_flash_unrolled`` is
the arithmetic of :func:`flash_attention` with its loops unrolled,
skipping the same wholly masked tiles, so it is not ported apart.

The decode cache is laid out (L, B, S, KV*d_head) as in the reference.
:func:`make_serve_step`'s step writes the new token's K and V into the
cache it is given, in place, and returns that same cache (the reference
returns an updated copy).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import tree
from ..core.device_index import resolve_device
from ..distributed.sharding import (constrain, local_slice, replicate,
                                    shard_range, splits_evenly, wrap_local)
from ..optim.adamw import global_norm
from ..sparse.ops import take_rows


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    moe: MoEConfig | None = None
    rope_theta: float = 500_000.0
    dtype: torch.dtype = torch.bfloat16
    # execution knobs, kept so that the configs read as the reference's
    q_chunk: int = 256
    kv_chunk: int = 1024
    loss_chunk: int = 512
    microbatch: int = 1          # grad-accumulation factor (training)
    remat: bool = True           # (training)
    pad_multiple: int = 512      # mesh-divisibility padding (vocab, experts)
    act_shard: str = "dmodel"    # none|seq|dmodel (layer boundaries on a mesh)
    opt_dtype: torch.dtype = torch.float32  # AdamW moment dtype (training)
    # the dry run's probe mode: run probe_layers layers; probe_unroll is
    # the reference's flag for unrolled loops, a no-op here
    probe_layers: int | None = None
    probe_unroll: bool = False

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to ``pad_multiple``, as the reference pads the
        embedding for its shardings; the padded logit columns are kept."""
        m = self.pad_multiple
        return (self.vocab + m - 1) // m * m

    @property
    def n_experts_padded(self) -> int:
        """Experts rounded up to 16; padded experts receive zero tokens
        (router indices stay < n_experts)."""
        if not self.moe:
            return 0
        return (self.moe.n_experts + 15) // 16 * 16

    @property
    def params_count(self) -> int:
        D, H, KV, dh, Fd, V, L = (self.d_model, self.n_heads,
                                  self.n_kv_heads, self.d_head, self.d_ff,
                                  self.vocab, self.n_layers)
        attn = D * H * dh + 2 * D * KV * dh + H * dh * D
        if self.moe:
            ff = self.moe.n_experts * 3 * D * Fd + D * self.moe.n_experts
        else:
            ff = 3 * D * Fd
        return L * (attn + ff + 2 * D) + V * D + D * V + D

    @property
    def active_params_count(self) -> int:
        if not self.moe:
            return self.params_count
        D, Fd, L = self.d_model, self.d_ff, self.n_layers
        full = self.params_count
        ff_all = L * self.moe.n_experts * 3 * D * Fd
        ff_act = L * self.moe.top_k * 3 * D * Fd
        return full - ff_all + ff_act


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def param_shapes(cfg: LMConfig) -> dict:
    """The parameter dict's shapes (the reference's ``params_shape``)."""
    D, H, KV, dh, Fd, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_head, cfg.d_ff, cfg.n_layers)
    layers = {"wq": (L, D, H * dh), "wk": (L, D, KV * dh),
              "wv": (L, D, KV * dh), "wo": (L, H * dh, D),
              "ln1": (L, D), "ln2": (L, D)}
    if cfg.moe:
        E, Ep = cfg.moe.n_experts, cfg.n_experts_padded
        layers.update({"router": (L, D, E), "moe_w_gate": (L, Ep, D, Fd),
                       "moe_w_up": (L, Ep, D, Fd),
                       "moe_w_down": (L, Ep, Fd, D)})
    else:
        layers.update({"w_gate": (L, D, Fd), "w_up": (L, D, Fd),
                       "w_down": (L, Fd, D)})
    Vp = cfg.vocab_padded
    return {"embed": (Vp, D), "layers": layers, "ln_f": (D,),
            "out_proj": (D, Vp)}


def init_params(cfg: LMConfig, device=None,
                generator: torch.Generator | None = None) -> dict:
    """The reference's distributions: weights N(0, 0.02²) drawn in float32
    and cast to ``cfg.dtype``, norms at 1.  Drawn on ``device`` (None
    means the card) from ``generator`` (a ``torch.Generator`` on that
    device; default one seeded with 0), one layer's slice at a time, so
    the weights never pass through host memory and the float32 draw
    needs one slice of scratch.  The same seed gives other numbers than
    ``jax.random``; :func:`..convert.lm_from_jax` carries the reference's
    parameters across instead."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def rnd(shape):
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for part in (out if len(shape) > 2 else (out,)):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device,
                                   dtype=torch.float32).mul_(0.02))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    shapes = param_shapes(cfg)
    return {
        "embed": rnd(shapes["embed"]),
        "layers": {name: (ones if name in ("ln1", "ln2") else rnd)(shape)
                   for name, shape in shapes["layers"].items()},
        "ln_f": ones(shapes["ln_f"]),
        "out_proj": rnd(shapes["out_proj"]),
    }


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast back to ``x.dtype``, then scaled in that dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); rotates the two halves of dh (not interleaved),
    in float32, cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_chunk: int,
                    kv_chunk: int) -> torch.Tensor:
    """q (B, S, H, dh), k/v (B, S, KV, dh) -> (B, S, H, dh): the
    reference's chunked running softmax, GQA by grouping the query heads
    (K/V are never repeated).  S must be a multiple of both chunks (each
    taken as at most S), as in the reference."""
    B, S, Hq, dh = q.shape
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, k.shape[1])
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"sequence of {S} is not a multiple of the chunks "
                         f"({q_chunk}, {kv_chunk})")
    KV = k.shape[2]
    rep = Hq // KV
    scale = 1.0 / math.sqrt(dh)
    nq, nk = S // q_chunk, S // kv_chunk
    dev = q.device
    outs = []
    for qi in range(nq):
        q0 = qi * q_chunk
        qg = q[:, q0:q0 + q_chunk].reshape(B, q_chunk, KV, rep, dh).float()
        m = torch.full((B, Hq, q_chunk), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hq, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hq, q_chunk, dh), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k0 = ki * kv_chunk
            if causal and k0 > q0 + q_chunk - 1:
                break           # wholly masked: adds exactly zero
            kc = k[:, k0:k0 + kv_chunk].float()
            vc = v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kc) * scale
            if causal:
                qpos = q0 + torch.arange(q_chunk, device=dev)
                kpos = k0 + torch.arange(kv_chunk, device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
            s = s.reshape(B, Hq, q_chunk, kv_chunk)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pg = p.reshape(B, KV, rep, q_chunk, kv_chunk).to(q.dtype)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", pg.float(), vc.float()).reshape(
                    B, Hq, q_chunk, dh)
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))   # (B, qc, Hq, dh)
    return torch.cat(outs, 1).reshape(B, S, Hq, dh)


def moe_capacity(cfg: LMConfig, n_tokens: int) -> int:
    """Rows each expert takes for ``n_tokens`` flat tokens (a Python int
    from the static shape, as in the reference)."""
    mc = cfg.moe
    C = int(mc.capacity_factor * n_tokens * mc.top_k / mc.n_experts)
    return max(8, min(C, n_tokens))


def moe_ffn(x: torch.Tensor, lp: dict, cfg: LMConfig,
            drops: list | None = None, mesh=None) -> torch.Tensor:
    """Sort-based top-k MoE (x: (N, D) flat tokens) -> (N, D).

    Expert weights hold E padded to 16; router indices never reach the
    padded range, so padded experts process only zero rows.  Where
    ``drops`` is a list, the number of (token, slot) pairs dropped at
    capacity is appended to it as a 0-d tensor on x's device.

    On a mesh (x a DTensor) the routing, a global sort of the (N*K,)
    expert ids, runs on ids replicated on every rank; the tokens are
    gathered whole over the batch axes for the dispatch and each rank
    reads its slice of the sorted order from them; the experts' batches
    (Ep, C, D) are split over "model" as the reference constrains them,
    and the combine reads each token's rows where they lie.  The two
    replications are named in the notes of
    ``distributed.sharding.record_redistributes``."""
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    Ep = cfg.n_experts_padded
    N, D = x.shape
    C = moe_capacity(cfg, N)
    dev = x.device
    x = constrain(x, mesh, ("pod", "data"), None)
    logits = (x @ lp["router"]).float()                      # (N, E)
    logits = constrain(logits, mesh, ("pod", "data"), None)
    probs = torch.softmax(logits, -1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True,
                             stable=True)
    gates, eidx = gates[:, :K], eidx[:, :K]                  # (N, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = eidx.reshape(-1)                                # (N*K,)
    sharded = isinstance(flat_e, DTensor)
    if sharded:
        flat_e = replicate(flat_e, "moe routing: the (N*K,) expert ids "
                                   "replicated for the global sort"
                           ).to_local()
    # stable sort by expert; rank within expert = position - expert start
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * K, device=dev) - starts[sorted_e]
    starts_p = torch.cat([starts, torch.full((Ep - E,), N * K,
                                             dtype=torch.int64, device=dev)])
    arange_c = torch.arange(C, device=dev)
    take = starts_p[:, None] + arange_c[None, :]             # (Ep, C)
    counts_p = torch.cat([counts, torch.zeros(Ep - E, dtype=torch.int64,
                                              device=dev)])
    valid = arange_c[None, :] < torch.clamp(counts_p, max=C)[:, None]
    # combine: token (n, k) sits at sorted position inv[nk] with expert
    # rank rank[inv[nk]]; capacity-dropped tokens contribute zero
    inv = torch.argsort(order, stable=True)
    r_tok = rank[inv]
    kept = r_tok < C
    if drops is not None:
        drops.append((~kept).sum())
    src = torch.clamp(flat_e * C + torch.clamp(r_tok, max=C - 1), 0,
                      Ep * C - 1)
    take = torch.clamp(take, 0, N * K - 1)
    if not sharded:
        # expert e's batch is rows [starts[e], starts[e]+C) of the sorted
        # token matrix, masked at its count
        sorted_tok = x[order // K]
        h = sorted_tok[take] * valid[..., None]
    else:
        msh = x.device_mesh
        rows = _on_mesh(order // K, msh, ("pod", "data"))
        sorted_tok = take_rows(
            replicate(x, "moe dispatch: the (N, D) tokens gathered over "
                         "the batch axes"), rows)
        sorted_tok = constrain(sorted_tok, mesh, ("pod", "data"), None)
        h = take_rows(sorted_tok, _on_mesh(take, msh, "model")) \
            * valid[..., None]
        src = _on_mesh(src, msh, ("pod", "data"))
    h = constrain(h, mesh, "model", None, None)              # (Ep, C, D)
    a = torch.einsum("ecd,edf->ecf", h, lp["moe_w_gate"])
    b = torch.einsum("ecd,edf->ecf", h, lp["moe_w_up"])
    hh = F.silu(a) * b
    out_e = torch.einsum("ecf,efd->ecd", hh, lp["moe_w_down"])
    out_e = constrain(out_e, mesh, "model", None, None)
    flat_out = out_e.reshape(Ep * C, D)
    per_k = (take_rows(flat_out, src) if sharded else flat_out[src]) \
        * kept[:, None].to(x.dtype)
    per_k = constrain(per_k.reshape(N, K, D), mesh, ("pod", "data"), None,
                      None)
    return (per_k * gates[..., None].to(x.dtype)).sum(1)


def _on_mesh(t: torch.Tensor, mesh, axes) -> DTensor:
    """A tensor that every rank holds whole, as a DTensor on ``mesh``
    split along dimension 0 over ``axes`` (each rank keeps its block; no
    collective)."""
    full = wrap_local(t, mesh, (Replicate(),) * mesh.ndim, t.shape)
    return constrain(full, mesh, axes, *(None,) * (t.dim() - 1))


def dense_ffn(x: torch.Tensor, lp: dict) -> torch.Tensor:
    return (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]


def _layer(layers: dict, i: int) -> dict:
    return {name: w[i] for name, w in layers.items()}


def _ffn(h2: torch.Tensor, lp: dict, cfg: LMConfig, drops,
         mesh=None) -> torch.Tensor:
    if not cfg.moe:
        return dense_ffn(h2, lp)
    D = cfg.d_model
    return moe_ffn(h2.reshape(-1, D), lp, cfg, drops,
                   mesh=mesh).reshape(h2.shape)


def _n_layers(cfg: LMConfig) -> int:
    """Layers a pass runs: ``probe_layers`` in the probe mode."""
    return cfg.n_layers if cfg.probe_layers is None else cfg.probe_layers


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a DTensor table is read where its rows lie."""
    if isinstance(table, DTensor):
        return take_rows(table, tokens)
    return table[tokens]


# --------------------------------------------------------------------------
# forward / loss
# --------------------------------------------------------------------------


def _boundary_constraint(x, cfg: LMConfig, mesh):
    """The reference's layer-boundary sharding of (B, S, D): the sequence
    over "model" ("seq"), d_model over "model" ("dmodel"), or the batch
    alone ("none"); the batch over ("pod", "data") always."""
    if cfg.act_shard == "seq":
        return constrain(x, mesh, ("pod", "data"), "model", None)
    if cfg.act_shard == "dmodel":
        return constrain(x, mesh, ("pod", "data"), None, "model")
    return constrain(x, mesh, ("pod", "data"), None, None)


def _reshape_local(t, shape):
    """``t.reshape(shape)``; a DTensor is reshaped shard by shard, keeping
    its placements, which must tile the new shape as they tiled the old
    (the heads' splits and merges below), and its gradient is reshaped
    the same way back."""
    if not isinstance(t, DTensor):
        return t.reshape(shape)
    mesh, pl = t.device_mesh, t.placements
    local = [shard_range(n, mesh, pl, d)[1] for d, n in enumerate(shape)]
    return wrap_local(t.to_local().reshape(local), mesh, pl, shape)


def _split_heads(t, n: int, dh: int):
    """(B, S, n*dh) -> (B, S, n, dh).  A DTensor whose last dimension is
    sharded over more ranks than divide ``n`` is gathered along it first
    (a shard may not split a head)."""
    if not splits_evenly(t, t.dim() - 1, n):
        t = replicate(t, "attention: heads do not divide the model axis; "
                         "projections gathered over it before the head "
                         "split", dim=t.dim() - 1)
    return _reshape_local(t, (*t.shape[:-1], n, dh))


def _merge_heads(t):
    """(B, S, n, dh) -> (B, S, n*dh), a DTensor's head dimension gathered
    first where its ranks do not divide the heads."""
    if not splits_evenly(t, 2, t.shape[2]):
        t = replicate(t, "attention: heads do not divide the model axis; "
                         "the output gathered over it before the output "
                         "projection", dim=2)
    return _reshape_local(t, (*t.shape[:2], t.shape[2] * t.shape[3]))


def _attention(q, k, v, cfg: LMConfig):
    """:func:`flash_attention` of the block.  With q a DTensor whose heads
    are sharded, each rank runs it on its own heads: K and V are laid out
    as q on every other mesh dimension and whole over the heads' ones,
    each local head takes its K/V head (``h // rep``), and the result
    keeps q's placements.  K's and V's gradients are then partial over
    the heads' mesh dimensions."""
    heads = [isinstance(p, Shard) and p.dim == 2 for p in getattr(
        q, "placements", ())]
    if not any(heads):
        return flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                               kv_chunk=cfg.kv_chunk)
    mesh = q.device_mesh
    want = tuple(Replicate() if h else p for p, h in zip(q.placements,
                                                         heads))
    grad = tuple(Partial() if h else p for p, h in zip(q.placements, heads))
    k, v = (t if tuple(t.placements) == want else t.redistribute(mesh, want)
            for t in (k, v))
    lo, n = shard_range(q.shape[2], mesh, q.placements, 2)
    rep = cfg.n_heads // cfg.n_kv_heads
    idx = torch.div(torch.arange(lo, lo + n, device=q.device), rep,
                    rounding_mode="floor")
    kl, vl = (t.to_local(grad_placements=grad)[:, :, idx] for t in (k, v))
    out = flash_attention(q.to_local(), kl, vl, causal=True,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return wrap_local(out, mesh, q.placements, q.shape)


def _block(x: torch.Tensor, lp: dict, cfg: LMConfig,
           positions: torch.Tensor, drops, mesh=None):
    """One layer on x (B, S, D) -> (x, k, v)."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rmsnorm(x, lp["ln1"])
    h = constrain(h, mesh, ("pod", "data"), None, None)
    q = _split_heads(h @ lp["wq"], H, dh)
    k = _split_heads(h @ lp["wk"], KV, dh)
    v = _split_heads(h @ lp["wv"], KV, dh)
    q = constrain(q, mesh, ("pod", "data"), None, "model", None)
    k = constrain(k, mesh, ("pod", "data"), None, None, None)
    v = constrain(v, mesh, ("pod", "data"), None, None, None)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    att = _merge_heads(_attention(q, k, v, cfg))
    x = x + _boundary_constraint(att @ lp["wo"], cfg, mesh)
    h2 = constrain(rmsnorm(x, lp["ln2"]), mesh, ("pod", "data"), None, None)
    x = x + _boundary_constraint(_ffn(h2, lp, cfg, drops, mesh), cfg, mesh)
    return _boundary_constraint(x, cfg, mesh), k, v


def _remat_block(x: torch.Tensor, lp: dict, cfg: LMConfig,
                 positions: torch.Tensor, drops, mesh=None) -> torch.Tensor:
    """:func:`_block` under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): only x is kept for the backward pass, which runs
    the layer again.  ``drops`` is handed to the first run alone, so a
    recomputed layer's dropped tokens are not counted twice."""
    box = [drops]

    def run(x):
        return _block(x, lp, cfg, positions, box.pop() if box else None,
                      mesh)[0]

    return checkpoint(run, x, use_reentrant=False)


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            return_kv: bool = False, drops: list | None = None,
            mesh=None):
    """tokens (B, S) -> final hidden (B, S, D) [+ per-layer KV cache, a
    dict of (L, B, S, KV*dh) tensors].

    ``params["layers"]`` holds stacked (L, ...) tensors or, as the train
    step passes them, a list of L per-layer tensors under each name.  With
    ``cfg.remat``, autograd on and no cache asked for, each layer runs
    under :func:`_remat_block`, as the reference's scan body runs under
    ``jax.checkpoint`` (the probe mode runs its layers plainly, as the
    reference's does)."""
    B, S = tokens.shape
    KV, dh = cfg.n_kv_heads, cfg.d_head
    x = _boundary_constraint(_embed(params["embed"], tokens), cfg, mesh)
    positions = torch.arange(S, device=tokens.device)[None, :]
    remat = (cfg.remat and not return_kv and torch.is_grad_enabled()
             and cfg.probe_layers is None)
    ks, vs = [], []
    for i in range(_n_layers(cfg)):
        lp = _layer(params["layers"], i % cfg.n_layers)
        if remat:
            x = _remat_block(x, lp, cfg, positions, drops, mesh)
            continue
        x, k, v = _block(x, lp, cfg, positions, drops, mesh)
        if return_kv:
            ks.append(k.reshape(B, S, KV * dh))
            vs.append(v.reshape(B, S, KV * dh))
    out = rmsnorm(x, params["ln_f"])
    if return_kv:
        return out, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return out


def make_prefill_step(cfg: LMConfig, mesh=None):
    """prefill_step(params, tokens) -> (last-token logits, KV cache)."""

    def prefill_step(params, tokens, drops=None):
        hidden, cache = forward(params, tokens, cfg, return_kv=True,
                                drops=drops, mesh=mesh)
        return hidden[:, -1] @ params["out_proj"], cache

    return prefill_step


def _gold(lf: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``lf[..., y]``: each row's logit at its label.  On a DTensor whose
    last dimension (the vocabulary) is sharded, each rank reads the labels
    that fall in its columns, a result partial over those mesh
    dimensions."""
    if not isinstance(lf, DTensor):
        # one gathered column a row: its backward (a scatter-add on CUDA)
        # adds once to each address, so it is deterministic
        return torch.gather(lf, -1, y[..., None].long())[..., 0]
    mesh, last = lf.device_mesh, lf.dim() - 1
    vocab = [isinstance(p, Shard) and p.dim == last for p in lf.placements]
    want_y = tuple(Replicate() if c else p
                   for p, c in zip(lf.placements, vocab))
    if not isinstance(y, DTensor):
        y = wrap_local(y, mesh, (Replicate(),) * mesh.ndim, y.shape)
    if tuple(y.placements) != want_y:
        y = y.redistribute(mesh, want_y)
    loc = lf.to_local()
    lo, n = shard_range(lf.shape[last], mesh, lf.placements, last)
    yl = y.to_local().long()
    mine = (yl >= lo) & (yl < lo + n)
    got = torch.gather(loc, -1, (yl - lo).clamp(0, n - 1)[..., None])[..., 0]
    got = torch.where(mine, got, 0.0)
    return wrap_local(got, mesh, [Partial() if c else p for p, c in
                                  zip(want_y, vocab)], y.shape)


def _chunk_loss(h: torch.Tensor, y: torch.Tensor, out_proj: torch.Tensor,
                cfg: LMConfig, mesh=None) -> torch.Tensor:
    """Summed cross-entropy of one chunk of the sequence: the padded vocab
    columns filled with -1e30 in the logits' dtype, then ``logsumexp`` and
    the gold logit in float32."""
    logits = h @ out_proj                                  # (B, ch, Vp)
    logits = constrain(logits, mesh, ("pod", "data"), None, "model")
    if cfg.vocab_padded > cfg.vocab:                       # mask pad columns
        vmask = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab
        logits = torch.where(vmask, logits, -1e30)
    lf = logits.float()
    return (torch.logsumexp(lf, -1) - _gold(lf, y)).sum()


def lm_loss(params: dict, batch: dict, cfg: LMConfig,
            mesh=None) -> torch.Tensor:
    """Chunked cross-entropy: ``loss_chunk`` columns of the sequence at a
    time, the float32 sum divided by B·S (a 0-d float32 tensor).

    With autograd on, each chunk runs under ``torch.utils.checkpoint``, so
    the graph keeps a chunk's hidden slice and not its float32 logits
    (2 x 512 x 128,512 x 4 B = 526 MB a chunk for llama3.2-3b at full
    width); the backward pass computes each chunk's logits again."""
    hidden = forward(params, batch["tokens"], cfg, mesh=mesh)  # (B, S, D)
    labels = batch["labels"]
    B, S, _ = hidden.shape
    ch = min(cfg.loss_chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // ch):
        args = (hidden[:, i * ch:(i + 1) * ch],
                labels[:, i * ch:(i + 1) * ch], params["out_proj"], cfg,
                mesh)
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            tot = tot + _chunk_loss(*args)
    return tot / (B * S)


# --------------------------------------------------------------------------
# train / serve steps
# --------------------------------------------------------------------------


def _trainable(params: dict, cfg: LMConfig, microbatch: int):
    """(the tensors the train step differentiates, the gradient buffers).

    One zeroed buffer a leaf, laid out as ``params``.  The differentiated
    tensors share storage with the parameters and are autograd leaves, one
    a layer for each stacked (L, ...) leaf, whose ``.grad`` is preset to
    the matching slice of the buffer: autograd then adds each layer's
    gradient straight into the buffer as the backward pass reaches it (a
    slice of a stacked leaf would instead give a full-size gradient a
    layer).  Each leaf's gradient is divided by ``microbatch`` before it is
    added, as the reference accumulates ``acc + (g / mb).astype(acc)``."""
    grads = tree.tree_map(torch.zeros_like, params)

    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        if microbatch > 1:
            t.register_hook(lambda gr: gr / microbatch)
        return t

    L = cfg.n_layers
    return {"embed": leaf(params["embed"], grads["embed"]),
            "layers": {n: [leaf(w[i], grads["layers"][n][i])
                           for i in range(L)]
                       for n, w in params["layers"].items()},
            "ln_f": leaf(params["ln_f"], grads["ln_f"]),
            "out_proj": leaf(params["out_proj"], grads["out_proj"])}, grads


def _sharded_grads(params: dict, batch: dict, cfg: LMConfig, mesh,
                   param_shardings):
    """(mean loss, gradients) of the microbatched loss on a mesh: each
    microbatch is every rank's own slice of its batch shard
    (``local_slice``), each layer's gradient is pinned to its parameter's
    placements (``param_shardings``, flat in JAX's leaf order, or the
    parameters' own) and added to a buffer of the parameters' dtype as
    ``acc + (g / mb).astype(acc)``, as the reference's scan does."""
    mb = cfg.microbatch
    flat, treedef = tree.flatten(params)
    pins = (list(param_shardings) if param_shardings is not None
            else [p.placements for p in flat])
    grads = [torch.zeros_like(p) for p in flat]
    names = tree.path_names(params)
    loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for m in range(mb):
        part = {k: local_slice(v, mb, m) for k, v in batch.items()}
        leaves, slots = [], []
        for i, (name, p) in enumerate(zip(names, flat)):
            if name.startswith("layers/"):
                per = [p[j].detach().requires_grad_()
                       for j in range(cfg.n_layers)]
                leaves.append(per)
                slots.extend((i, j, t) for j, t in enumerate(per))
            else:
                t = p.detach().requires_grad_()
                leaves.append(t)
                slots.append((i, None, t))
        mb_loss = lm_loss(tree.unflatten(treedef, leaves), part, cfg,
                          mesh=mesh)
        gs = torch.autograd.grad(mb_loss, [t for _, _, t in slots],
                                 allow_unused=True, materialize_grads=True)
        for (i, j, _), g in zip(slots, gs):
            acc, pl = grads[i], tuple(pins[i])
            if j is not None:       # a layer of a stacked (L, ...) leaf
                acc = acc[j]
                pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                           for p in pl)
            if tuple(g.placements) != pl:
                g = g.redistribute(g.device_mesh, pl)
            acc.add_((g / mb).to(acc.dtype))
        loss = loss + mb_loss.detach() / mb
    return loss, tree.unflatten(treedef, grads)


def make_train_step(cfg: LMConfig, optimizer_update, *, mesh=None,
                    param_shardings=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    loss, gnorm).

    ``batch`` holds ``tokens`` and ``labels`` (B, S) on the parameters'
    device.  The batch is split into ``cfg.microbatch`` slices; each
    slice's gradient is accumulated in the parameters' dtype (see
    :func:`_trainable`) and the loss is the mean of the slices' losses.
    Then ``optimizer_update(params, grads, opt_state) -> (params,
    opt_state, gnorm)`` runs, in place for :func:`..optim.adamw_update`.

    The reference's rule for a non-finite loss holds: its trainer keeps the
    old parameters and moments then.  An in-place update cannot be taken
    back, so the step decides before it: it reads ``torch.isfinite(loss)``
    on the host (the one sync of a step, which the trainer's
    ``float(loss)`` makes anyway) and, where the loss is not finite,
    returns the parameters, moments and step counter untouched with the
    gradient's global norm.  A finite loss is applied even where the
    gradients are not finite, as in the reference.

    With a ``mesh`` (DTensor parameters, as ``LMArch.build`` lays them
    out) the step is the reference's cell function: gradients by
    :func:`_sharded_grads`, pinned to ``param_shardings`` (a flat list of
    placements in JAX's leaf order, or the parameters' own), and the
    update applied whatever the loss, with no read on the host."""

    def train_step(params, opt_state, batch):
        if mesh is not None:
            loss, grads = _sharded_grads(params, batch, cfg, mesh,
                                         param_shardings)
            params, opt_state, gnorm = optimizer_update(params, grads,
                                                        opt_state)
            return params, opt_state, loss, gnorm
        mb = cfg.microbatch
        tokens, labels = batch["tokens"], batch["labels"]
        sz = tokens.shape[0] // mb
        leaves, grads = _trainable(params, cfg, mb)
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(mb):
            part = {"tokens": tokens[i * sz:(i + 1) * sz],
                    "labels": labels[i * sz:(i + 1) * sz]}
            mb_loss = lm_loss(leaves, part, cfg)
            mb_loss.backward()
            loss = loss + mb_loss.detach() / mb
        del leaves
        if not torch.isfinite(loss):
            return params, opt_state, loss, global_norm(grads)
        params, opt_state, gnorm = optimizer_update(params, grads, opt_state)
        return params, opt_state, loss, gnorm

    return train_step


def _write_position(cache: torch.Tensor, pos: int, new: torch.Tensor):
    """``cache[:, pos] = new`` for one layer's (B, S, KV*dh) cache.  On a
    DTensor cache whose positions are sharded, only the rank that holds
    ``pos`` writes, into its own shard."""
    if not isinstance(cache, DTensor):
        cache[:, pos] = new
        return
    mesh = cache.device_mesh
    seq = [isinstance(p, Shard) and p.dim == 1 for p in cache.placements]
    want = tuple(Replicate() if s else (Shard(p.dim - 1) if isinstance(
        p, Shard) and p.dim > 1 else p)
        for p, s in zip(cache.placements, seq))
    if not isinstance(new, DTensor):
        new = wrap_local(new, mesh, (Replicate(),) * mesh.ndim, new.shape)
    if tuple(new.placements) != want:
        new = new.redistribute(mesh, want)
    lo, n = shard_range(cache.shape[1], mesh, cache.placements, 1)
    if lo <= pos < lo + n:
        cache.to_local()[:, pos - lo] = new.to_local()


def make_serve_step(cfg: LMConfig, mesh=None):
    """Returns serve_step(params, cache, token, pos) -> (logits, cache).

    cache: dict(k=(L, B, S, KV*dh), v=(L, B, S, KV*dh)); one new token per
    sequence (token: (B,)) is written at position ``pos`` (a Python int
    below S) in place and attends to positions 0..pos.  In the probe mode
    the first ``probe_layers`` layers run and the cache returned holds
    those layers (views of the cache given)."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rep = H // KV

    def serve_step(params, cache, token, pos: int, drops=None):
        B = token.shape[0]
        S = cache["k"].shape[2]
        if not 0 <= pos < S:
            raise ValueError(f"position {pos} outside a cache of {S}")
        dev = token.device
        x = _embed(params["embed"], token)[:, None, :]      # (B, 1, D)
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
        smask = torch.arange(S, device=dev) <= pos
        for i in range(_n_layers(cfg)):
            li = i % cfg.n_layers
            lp = _layer(params["layers"], li)
            kc, vc = cache["k"][li], cache["v"][li]         # (B, S, KV*dh)
            h = rmsnorm(x, lp["ln1"])
            q = _split_heads(h @ lp["wq"], H, dh)
            k = _split_heads(h @ lp["wk"], KV, dh)
            v = _split_heads(h @ lp["wv"], KV, dh)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            _write_position(kc, pos, k.reshape(B, KV * dh))
            _write_position(vc, pos, v.reshape(B, KV * dh))
            kk = _split_heads(kc, KV, dh)
            vv = _split_heads(vc, KV, dh)
            if not splits_evenly(q, 2, KV):
                q = replicate(q, "decode: query heads gathered over the "
                                 "model axis, whose ranks do not divide "
                                 "the KV groups", dim=2)
            qg = q.reshape(B, KV, rep, dh)
            s = torch.einsum("bgrd,bsgd->bgrs", qg.float(), kk.float())
            s = s / math.sqrt(dh)
            s = torch.where(smask, s, -1e30)
            p = torch.softmax(s, -1).to(x.dtype)
            att = torch.einsum("bgrs,bsgd->bgrd", p, vv)
            x = x + att.reshape(B, 1, H * dh) @ lp["wo"]
            x = x + _ffn(rmsnorm(x, lp["ln2"]), lp, cfg, drops, mesh)
        logits = rmsnorm(x, params["ln_f"]) @ params["out_proj"]
        if cfg.probe_layers is not None:
            n = cfg.probe_layers
            return logits[:, 0], {k: c[:n] for k, c in cache.items()}
        return logits[:, 0], cache

    return serve_step


def make_cache_shape(cfg: LMConfig, batch: int, seq: int) -> dict:
    """The decode cache's shape and dtype, as ``meta`` tensors (the
    counterpart of the reference's ``ShapeDtypeStruct``s)."""
    sh = (cfg.n_layers, batch, seq, cfg.n_kv_heads * cfg.d_head)
    return {name: torch.empty(sh, dtype=cfg.dtype, device="meta")
            for name in ("k", "v")}


class LM(nn.Module):
    """The LM's parameters on one device, with ``prefill`` and ``decode``.

    ``device`` None means the card (raises without CUDA).  ``params``, a
    dict laid out as :func:`param_shapes` says, is adopted as it is;
    otherwise :func:`init_params` draws one from ``generator``.  The
    parameters do not require grad: the module serves, and
    :func:`make_train_step` trains the dict of :meth:`params`."""

    def __init__(self, cfg: LMConfig, device=None,
                 generator: torch.Generator | None = None,
                 params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        if params is None:
            params = init_params(cfg, device, generator)
        shapes = param_shapes(cfg)
        got = {"embed": tuple(params["embed"].shape),
               "layers": {n: tuple(w.shape)
                          for n, w in params["layers"].items()},
               "ln_f": tuple(params["ln_f"].shape),
               "out_proj": tuple(params["out_proj"].shape)}
        if got != shapes:
            raise ValueError(f"parameters of shapes {got}, the config "
                             f"needs {shapes}")

        def param(t):
            return nn.Parameter(t.to(device=device, dtype=cfg.dtype),
                                requires_grad=False)

        self.cfg = cfg
        self.embed = param(params["embed"])
        self.layers = nn.ParameterDict(
            {n: param(w) for n, w in params["layers"].items()})
        self.ln_f = param(params["ln_f"])
        self.out_proj = param(params["out_proj"])
        self._prefill = make_prefill_step(cfg)
        self._serve = make_serve_step(cfg)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def params(self) -> dict:
        """The parameter dict the functional forms take (no copies)."""
        return {"embed": self.embed, "layers": dict(self.layers),
                "ln_f": self.ln_f, "out_proj": self.out_proj}

    def new_cache(self, batch: int, seq: int) -> dict:
        """A zeroed decode cache of ``seq`` positions on the device."""
        return {name: torch.zeros_like(t, device=self.device)
                for name, t in make_cache_shape(self.cfg, batch,
                                                seq).items()}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None,
                drops: list | None = None):
        """Last-token logits (B, Vp) and the KV cache of ``tokens`` (B, S),
        the cache padded with zeros to ``max_len`` positions (default S)
        so that :meth:`decode` can go on from position S."""
        logits, cache = self._prefill(self.params(), tokens, drops)
        S = tokens.shape[1]
        if max_len is not None and max_len > S:
            cache = {n: F.pad(c, (0, 0, 0, max_len - S))
                     for n, c in cache.items()}
        return logits, cache

    @torch.no_grad()
    def decode(self, cache: dict, token: torch.Tensor, pos: int,
               drops: list | None = None):
        """One greedy step's logits (B, Vp); ``cache`` is written at
        ``pos`` in place and returned."""
        return self._serve(self.params(), cache, token, pos, drops)
