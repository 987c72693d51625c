"""The port's LM (``repro_torch.models.lm``) against the JAX package's, on
the CPU.

The configurations are the reference's ``reduced_lm`` of llama3.2-3b
(dense), granite-moe-3b-a800m (8 experts, top-2) and llama4-scout (8
experts, top-1).  The reference's parameters come from
``init_params(cfg, PRNGKey(0))`` and are carried into the port by
``convert.lm_from_jax``; tokens and block inputs are made from a numpy
seed.  The reference's functions call its sharding constraint, which jax
0.9 accepts only on a mesh with Auto axes, so the oracle's mesh is built
with them.

Tolerances, as a maximum absolute difference over the largest |value| of
the reference's output:

* float32: ``F32_TOL`` = 1e-5.  Both sum float32 products in other orders
  (XLA's and PyTorch's CPU kernels); measured differences are below 1e-6.
* bfloat16: ``BF16_TOL`` = 2e-2, about five bfloat16 ulps (2^-8 each):
  each package rounds its bf16 products and sums to bf16 at its own
  points.

The MoE cases drop tokens at capacity (N = 128 flat tokens), and the MoE
configurations' prefill drops some as well, so their prefill logits differ
from the decode's; the port must reproduce that gap, not close it.
"""

from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.train import reduced_lm as jax_reduced_lm
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch.train import reduced_lm
from repro_torch.models import lm as tlm

F32_TOL = 1e-5
BF16_TOL = 2e-2
ARCHS = ["llama3.2-3b", "granite-moe-3b-a800m", "llama4-scout-17b-a16e"]
MOE_ARCHS = ARCHS[1:]
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
S_PREFILL = 128          # q_chunk 32 and kv_chunk 64 both below it
S_DECODE0, N_DECODE = 32, 16


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a, dtype=None) -> torch.Tensor:
    """A jax or numpy array as a CPU tensor (bfloat16 bits kept)."""
    t = convert._leaf(np.asarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module", params=ARCHS)
def lm_pair(request):
    """(arch, jax cfg, jax params, port cfg, port model)."""
    arch = request.param
    jcfg = jax_reduced_lm(jax_get_arch(arch).cfg)
    tcfg = reduced_lm(get_arch(arch).cfg)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return arch, jcfg, params, tcfg, model


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rmsnorm_matches(dt):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((3, 7, 128)) * 3, jdt)
    scale = jnp.asarray(1 + rng.standard_normal(128) * 0.1, jdt)
    want = jlm.rmsnorm(x, scale)
    got = tlm.rmsnorm(_t(x), _t(scale))
    assert got.dtype == tdt
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rope_matches(dt):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 40, 4, 32)), jdt)
    pos = jnp.asarray(np.arange(40)[None, :] + 5, jnp.int32)
    want = jlm.rope(x, pos, 500_000.0)
    got = tlm.rope(_t(x), _t(pos), 500_000.0)
    assert got.dtype == tdt
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dt,causal", [("float32", True),
                                       ("float32", False),
                                       ("bfloat16", True)])
def test_flash_attention_matches(dt, causal):
    """S = 128 in q chunks of 32 and kv chunks of 64 (both below S, and
    unequal), 8 query heads over 2 KV heads (GQA, rep 4)."""
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.standard_normal((2, 128, 8, 32)), jdt)
    k = jnp.asarray(rng.standard_normal((2, 128, 2, 32)), jdt)
    v = jnp.asarray(rng.standard_normal((2, 128, 2, 32)), jdt)
    want = jlm.flash_attention(q, k, v, causal=causal, q_chunk=32,
                               kv_chunk=64)
    got = tlm.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              q_chunk=32, kv_chunk=64)
    assert got.dtype == tdt
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_dense_ffn_matches(dt):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(4)
    lp = {n: jnp.asarray(rng.standard_normal(sh) * 0.05, jdt)
          for n, sh in (("w_gate", (128, 256)), ("w_up", (128, 256)),
                        ("w_down", (256, 128)))}
    x = jnp.asarray(rng.standard_normal((2, 9, 128)), jdt)
    want = jlm.dense_ffn(x, lp)
    got = tlm.dense_ffn(_t(x), {n: _t(w) for n, w in lp.items()})
    assert got.dtype == tdt
    assert _rel(got, want) <= tol


def _reference_drops(x, router, cfg) -> int:
    """(token, slot) pairs over capacity under the reference's routing."""
    probs = jax.nn.softmax((x @ router).astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, cfg.moe.top_k)
    counts = np.bincount(np.asarray(eidx).ravel(),
                         minlength=cfg.moe.n_experts)
    C = max(8, min(int(cfg.moe.capacity_factor * x.shape[0]
                       * cfg.moe.top_k / cfg.moe.n_experts), x.shape[0]))
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_and_drops_the_same_tokens(mesh, arch, dt):
    """N = 128 flat tokens: some experts get more than their capacity C,
    and the port drops as many (token, slot) pairs as the reference."""
    jdt, tdt, tol = DTYPES[dt]
    jcfg = replace(jax_reduced_lm(jax_get_arch(arch).cfg), dtype=jdt)
    tcfg = replace(reduced_lm(get_arch(arch).cfg), dtype=tdt)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((128, jcfg.d_model)), jdt)
    want = jlm.moe_ffn(x, lp, jcfg, mesh)
    drops = []
    got = tlm.moe_ffn(_t(x), {n: _t(w) for n, w in lp.items()}, tcfg, drops)
    assert got.dtype == tdt
    assert _rel(got, want) <= tol
    assert tlm.moe_capacity(tcfg, 128) < 128
    if dt == "float32":
        n_drop = _reference_drops(x, lp["router"], jcfg)
        assert n_drop > 0
        assert int(drops[0]) == n_drop


def test_moe_ffn_runs_padded_experts_on_zero_rows():
    """The padded experts (8 -> 16) are computed at capacity on zero rows:
    their weights never reach the output, whatever they hold."""
    tcfg = reduced_lm(get_arch("granite-moe-3b-a800m").cfg)
    model = tlm.LM(tcfg, device="cpu")
    lp = {n: w[0].clone() for n, w in model.layers.items()}
    x = torch.randn(64, tcfg.d_model, generator=torch.Generator().manual_seed(6))
    before = tlm.moe_ffn(x, lp, tcfg)
    E = tcfg.moe.n_experts
    for name in ("moe_w_gate", "moe_w_up", "moe_w_down"):
        lp[name][E:] = 1e6
    assert torch.equal(tlm.moe_ffn(x, lp, tcfg), before)


# --------------------------------------------------------------------------
# the model: prefill, decode
# --------------------------------------------------------------------------


def test_prefill_matches(lm_pair, mesh):
    arch, jcfg, params, tcfg, model = lm_pair
    toks = _tokens(jcfg, 2, S_PREFILL)
    logits_j, cache_j = jax.jit(jlm.make_prefill_step(jcfg, mesh))(
        params, jnp.asarray(toks))
    logits_t, cache_t = model.prefill(torch.from_numpy(toks).long())
    assert logits_t.shape == (2, tcfg.vocab_padded)
    assert _rel(logits_t, logits_j) <= F32_TOL
    for name in ("k", "v"):
        assert cache_t[name].shape == tuple(cache_j[name].shape)
        assert _rel(cache_t[name], cache_j[name]) <= F32_TOL


def _decode_both(jcfg, params, model, mesh, toks, n, S0):
    """Prefill ``S0`` tokens, then ``n`` greedy decode steps in both
    packages; returns per-step logits, greedy tokens and final caches."""
    prefill = jax.jit(jlm.make_prefill_step(jcfg, mesh))
    serve = jax.jit(jlm.make_serve_step(jcfg, mesh))
    lj, cj = prefill(params, jnp.asarray(toks[:, :S0]))
    cj = {k: jnp.pad(c, ((0, 0), (0, 0), (0, n), (0, 0)))
          for k, c in cj.items()}
    lt, ct = model.prefill(torch.from_numpy(toks[:, :S0]).long(),
                           max_len=S0 + n)
    out = {"lj": [], "lt": [], "tj": [], "tt": []}
    V = jcfg.vocab
    for i in range(n):
        tj = jnp.argmax(lj[:, :V], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, :V], -1)
        out["tj"].append(np.asarray(tj))
        out["tt"].append(tt.numpy())
        lj, cj = serve(params, cj, tj, S0 + i)
        lt, ct = model.decode(ct, tt, S0 + i)
        out["lj"].append(lj)
        out["lt"].append(lt)
    out["cj"], out["ct"] = cj, ct
    return out


def test_decode_matches(lm_pair, mesh):
    """16 greedy decode steps after a prefill of 32: every step's logits,
    the greedy tokens and the final cache."""
    arch, jcfg, params, tcfg, model = lm_pair
    toks = _tokens(jcfg, 2, S_DECODE0, seed=7)
    out = _decode_both(jcfg, params, model, mesh, toks, N_DECODE, S_DECODE0)
    np.testing.assert_array_equal(np.stack(out["tt"]), np.stack(out["tj"]))
    assert max(_rel(a, b) for a, b in zip(out["lt"], out["lj"])) <= F32_TOL
    for name in ("k", "v"):
        assert _rel(out["ct"][name], out["cj"][name]) <= F32_TOL


def test_prefill_against_decode_as_the_reference(lm_pair, mesh):
    """prefill(t + 1 tokens)'s last logits against decode after
    prefill(t): equal for the dense model; for the MoE models prefill
    drops tokens at capacity, and the gap is the reference's.  t + 1 = 32,
    so that both lengths divide into their chunks (min(32, S))."""
    arch, jcfg, params, tcfg, model = lm_pair
    t = 31
    toks = _tokens(jcfg, 2, t + 1, seed=8)
    full_j, _ = jax.jit(jlm.make_prefill_step(jcfg, mesh))(
        params, jnp.asarray(toks))
    lj, cj = jax.jit(jlm.make_prefill_step(jcfg, mesh))(
        params, jnp.asarray(toks[:, :t]))
    cj = {k: jnp.pad(c, ((0, 0), (0, 0), (0, 1), (0, 0)))
          for k, c in cj.items()}
    dec_j, _ = jax.jit(jlm.make_serve_step(jcfg, mesh))(
        params, cj, jnp.asarray(toks[:, t]), t)
    tt = torch.from_numpy(toks).long()
    full_t, _ = model.prefill(tt)
    _, ct = model.prefill(tt[:, :t], max_len=t + 1)
    dec_t, _ = model.decode(ct, tt[:, t], t)
    gap_j = np.abs(np.asarray(full_j) - np.asarray(dec_j)).max()
    gap_t = float((full_t - dec_t).abs().max())
    scale = float(np.abs(np.asarray(full_j)).max())
    if tcfg.moe is None:
        assert gap_t <= F32_TOL * scale and gap_j <= F32_TOL * scale
    else:
        assert gap_j > 100 * F32_TOL * scale      # the reference drops
        assert abs(gap_t - gap_j) <= F32_TOL * scale
    assert _rel(full_t, full_j) <= F32_TOL
    assert _rel(dec_t, dec_j) <= F32_TOL


def test_bf16_model_matches(mesh):
    """The dense reduced model in bfloat16: prefill and 4 decode steps."""
    jcfg = replace(jax_reduced_lm(jax_get_arch("llama3.2-3b").cfg),
                   dtype=jnp.bfloat16)
    tcfg = replace(reduced_lm(get_arch("llama3.2-3b").cfg),
                   dtype=torch.bfloat16)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    assert model.embed.dtype == torch.bfloat16
    toks = _tokens(jcfg, 2, S_DECODE0, seed=9)
    out = _decode_both(jcfg, params, model, mesh, toks, 4, S_DECODE0)
    assert max(_rel(a, b) for a, b in zip(out["lt"], out["lj"])) <= BF16_TOL
    for name in ("k", "v"):
        assert _rel(out["ct"][name], out["cj"][name]) <= BF16_TOL


# --------------------------------------------------------------------------
# parameters and the config
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_lm_from_jax_carries_every_bit(dt):
    jdt, tdt, _ = DTYPES[dt]
    jcfg = replace(jax_reduced_lm(jax_get_arch("granite-moe-3b-a800m").cfg),
                   dtype=jdt)
    tcfg = replace(reduced_lm(get_arch("granite-moe-3b-a800m").cfg),
                   dtype=tdt)
    params = jax.tree.map(np.asarray,
                          jlm.init_params(jcfg, jax.random.PRNGKey(3)))
    model = convert.lm_from_jax(params, tcfg, device="cpu")
    got = model.params()
    pairs = [(got["embed"], params["embed"]), (got["ln_f"], params["ln_f"]),
             (got["out_proj"], params["out_proj"])]
    pairs += [(got["layers"][n], w) for n, w in params["layers"].items()]
    bits = np.uint16 if dt == "bfloat16" else np.uint32
    tbits = torch.int16 if dt == "bfloat16" else torch.int32
    for t, a in pairs:
        assert t.dtype == tdt
        np.testing.assert_array_equal(t.view(tbits).numpy().view(bits),
                                      np.asarray(a).view(bits))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-3-2b",
                                  "mistral-large-123b",
                                  "granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e"])
def test_param_shapes_match_the_reference(arch):
    want = jlm.params_shape(jax_get_arch(arch).cfg)
    got = tlm.param_shapes(get_arch(arch).cfg)
    assert jax.tree.map(lambda s: tuple(s.shape), want) == got


def test_init_params_draws_the_reference_distributions():
    tcfg = reduced_lm(get_arch("granite-moe-3b-a800m").cfg)
    p1 = tlm.init_params(tcfg, "cpu", torch.Generator().manual_seed(11))
    p2 = tlm.init_params(tcfg, "cpu", torch.Generator().manual_seed(11))
    p3 = tlm.init_params(tcfg, "cpu", torch.Generator().manual_seed(12))
    assert torch.equal(p1["embed"], p2["embed"])
    assert not torch.equal(p1["embed"], p3["embed"])
    for name, w in p1["layers"].items():
        assert torch.equal(w, p2["layers"][name])
        if name in ("ln1", "ln2"):
            assert torch.equal(w, torch.ones_like(w))
        else:
            assert abs(float(w.std()) - 0.02) < 0.002, name
            assert abs(float(w.mean())) < 0.002, name
    assert torch.equal(p1["ln_f"], torch.ones_like(p1["ln_f"]))
    # each layer's slice is drawn anew, not repeated
    assert not torch.equal(p1["layers"]["wq"][0], p1["layers"]["wq"][1])


def test_lm_defaults_to_the_card_and_checks_shapes():
    tcfg = reduced_lm(get_arch("llama3.2-3b").cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlm.LM(tcfg)
    params = tlm.init_params(tcfg, "cpu")
    params["layers"]["wq"] = params["layers"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="shapes"):
        tlm.LM(tcfg, device="cpu", params=params)


def test_flash_attention_rejects_a_ragged_sequence():
    q = torch.zeros(1, 48, 4, 8)
    k = torch.zeros(1, 48, 2, 8)
    with pytest.raises(ValueError, match="multiple"):
        tlm.flash_attention(q, k, k, causal=True, q_chunk=32, kv_chunk=48)


def test_cache_shape_and_decode_writes_in_place():
    tcfg = reduced_lm(get_arch("llama3.2-3b").cfg)
    model = tlm.LM(tcfg, device="cpu")
    shape = tlm.make_cache_shape(tcfg, 3, 20)
    assert {n: (tuple(t.shape), t.dtype) for n, t in shape.items()} == {
        n: ((2, 3, 20, 64), torch.float32) for n in ("k", "v")}
    cache = model.new_cache(3, 20)
    _, out = model.decode(cache, torch.tensor([1, 2, 3]), 4)
    assert out is cache
    assert cache["k"][:, :, 4].abs().sum() > 0
    assert cache["k"][:, :, 5:].abs().sum() == 0
    with pytest.raises(ValueError, match="outside"):
        model.decode(cache, torch.tensor([1, 2, 3]), 20)


def test_config_fields_read_as_the_reference():
    tcfg = get_arch("mistral-large-123b").cfg
    jcfg = jax_get_arch("mistral-large-123b").cfg
    names = {f.name for f in fields(tcfg)}
    assert names == {f.name for f in fields(jcfg)}
    assert tcfg.opt_dtype == torch.bfloat16
