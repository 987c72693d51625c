"""The port's serving entry point (``repro_torch.launch.serve``) and its
architecture registry (``repro_torch.configs``) against the JAX package's.

* ``serve_index``: the same synthetic stream and queries through both
  packages; each query's answer must be equal, the first ``[serve-index]``
  line equal, and the second equal but for its latencies.
* ``serve_lm(device="cpu")``: the reference's parameters carried across
  (``convert.lm_from_jax``); its greedy tokens and page overheads must
  equal the reference's decode loop.  The reference's ``serve_lm`` builds
  its mesh with Explicit axes, which jax 0.9 rejects in its sharding
  constraint, and returns nothing; the test runs the same loop
  (``src/repro/launch/serve.py:59-91``) on a mesh with Auto axes instead.
* ``get_arch``: every LM, GNN and recsys id and alias resolves to the
  reference's config field for field.
"""

import re
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.query as jax_query
from repro.configs import ALIASES as JAX_ALIASES
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.launch.serve import serve_index as jax_serve_index
from repro.launch.train import reduced_lm as jax_reduced_lm
from repro.models import lm as jlm
from repro.serve import PagedKVCache as JaxPool
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.launch.train import reduced_lm

ROOT = Path(__file__).resolve().parents[1]
LM_IDS = ["llama4_scout_17b_a16e", "granite_moe_3b_a800m", "granite_3_2b",
          "llama3_2_3b", "mistral_large_123b"]
GNN_IDS = ["schnet"]
RECSYS_IDS = ["dlrm_mlperf", "dlrm-mlperf", "sasrec", "din",
              "two_tower_retrieval", "two-tower-retrieval"]


# --------------------------------------------------------------------------
# serve_index
# --------------------------------------------------------------------------


def _mask_numbers(line: str) -> str:
    return re.sub(r"\d+\.\d+", "#", line)


@pytest.mark.parametrize("n_docs,n_queries", [(400, 30), (1200, 100)])
def test_serve_index_matches_the_reference(monkeypatch, capsys, n_docs,
                                           n_queries):
    got = serve.serve_index(n_docs, n_queries)
    port_out = capsys.readouterr().out.splitlines()

    answers = []

    def capture(fn):
        def wrapped(*args, **kwargs):
            answers.append(fn(*args, **kwargs))
            return answers[-1]
        return wrapped

    monkeypatch.setattr(jax_query, "conjunctive_query",
                        capture(jax_query.conjunctive_query))
    monkeypatch.setattr(jax_query, "ranked_disjunctive_taat",
                        capture(jax_query.ranked_disjunctive_taat))
    jax_serve_index(n_docs, n_queries)
    ref_out = capsys.readouterr().out.splitlines()

    assert port_out == got["lines"]
    assert len(port_out) == len(ref_out) == 2
    assert port_out[0] == ref_out[0]
    assert _mask_numbers(port_out[1]) == _mask_numbers(ref_out[1])
    assert port_out[1].split(";")[-1].split("over")[-1] == \
        ref_out[1].split(";")[-1].split("over")[-1]
    assert len(got["answers"]) == len(answers) == len(got["queries"])
    assert len(answers) == min(n_queries, n_docs // 10)
    for i, (a, b) in enumerate(zip(got["answers"], answers)):
        if i % 2 == 0:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("args", [["--mode", "index"],
                                  ["--mode", "lm", "--device", "cpu",
                                   "--steps", "4"]])
def test_serve_runs_as_a_module(args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    tag = "[serve-index]" if args[1] == "index" else "[serve-lm]"
    lines = [l for l in out.stdout.splitlines() if l.startswith(tag)]
    assert len(lines) == (2 if args[1] == "index" else 1)
    if args[1] == "index":
        assert "over 100 queries" in lines[1]


# --------------------------------------------------------------------------
# serve_lm
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _reference_decode(cfg, params, mesh, steps, B=2, S=128):
    """The reference's ``serve_lm`` loop, returning what it computes."""
    pool = JaxPool(n_pages=256, page_tokens=16, policy="triangle")
    for b in range(B):
        pool.add_sequence(b)
    step = jax.jit(jlm.make_serve_step(cfg, mesh))
    cache = {k: jnp.zeros(v.shape, v.dtype)
             for k, v in jlm.make_cache_shape(cfg, B, S).items()}
    tok = jnp.zeros((B,), jnp.int32)
    toks = []
    for pos in range(steps):
        for b in range(B):
            pool.append_tokens(b, 1)
        logits, cache = step(params, cache, tok, pos)
        tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    return np.stack(toks, 1), [pool.overhead_tokens(b) for b in range(B)]


@pytest.mark.parametrize("arch,steps", [("llama3.2-3b", 40),
                                        ("granite-moe-3b-a800m", 20)])
def test_serve_lm_matches_the_reference_decode(mesh, capsys, arch, steps):
    jcfg = jax_reduced_lm(jax_get_arch(arch).cfg)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.lm_from_jax(
        jax.tree.map(np.asarray, params),
        reduced_lm(configs.get_arch(arch).cfg), device="cpu")
    got = serve.serve_lm(steps, model=model)
    line = capsys.readouterr().out.strip()
    want_tokens, want_ovh = _reference_decode(jcfg, params, mesh, steps)
    np.testing.assert_array_equal(got["tokens"], want_tokens)
    assert got["overhead"] == want_ovh
    assert got["finite"] and len(got["step_s"]) == steps
    assert line == got["line"]
    assert re.fullmatch(rf"\[serve-lm\] {steps} decode steps x 2 seqs in "
                        rf"\d+\.\d\ds \(\d+\.\d ms/step\); page overhead/seq "
                        rf"\[{want_ovh[0]}, {want_ovh[1]}\] tokens", line)
    if model.cfg.moe:
        assert got["dropped"] == 0          # N = 2 tokens <= C = 8
    else:
        assert got["dropped"] is None


def test_serve_lm_default_is_the_reduced_llama_on_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_lm(2)
    got = serve.serve_lm(3, device="cpu")
    again = serve.serve_lm(3, device="cpu")
    np.testing.assert_array_equal(got["tokens"], again["tokens"])
    assert got["tokens"].shape == (2, 3)
    assert got["pool"].policy == "triangle"
    with pytest.raises(ValueError, match="do not fit"):
        serve.serve_lm(129, device="cpu")


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------


def _jax_dtype_name(d) -> str:
    return jnp.dtype(d).name


@pytest.mark.parametrize("arch_id", LM_IDS + [a for a, m in JAX_ALIASES.items()
                                              if m in LM_IDS])
def test_get_arch_matches_the_reference(arch_id):
    got, want = configs.get_arch(arch_id), jax_get_arch(arch_id)
    assert (got.arch_id, got.family, got.shapes) == \
        (want.arch_id, want.family, want.shapes)
    tc, jc = got.cfg, want.cfg
    for f in fields(tc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if isinstance(a, torch.dtype):
            assert str(a).removeprefix("torch.") == _jax_dtype_name(b), f.name
        elif f.name == "moe":
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.n_experts, a.top_k, a.capacity_factor) == \
                    (b.n_experts, b.top_k, b.capacity_factor)
        else:
            assert a == b, f.name
    for prop in ("vocab_padded", "n_experts_padded", "params_count",
                 "active_params_count"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    for shape in got.shapes:
        assert got.flops(shape) == want.flops(shape)
    red_t, red_j = reduced_lm(tc), jax_reduced_lm(jc)
    assert (red_t.n_layers, red_t.d_model, red_t.vocab_padded,
            red_t.n_experts_padded, red_t.q_chunk, red_t.kv_chunk) == \
        (red_j.n_layers, red_j.d_model, red_j.vocab_padded,
         red_j.n_experts_padded, red_j.q_chunk, red_j.kv_chunk)
    assert red_t.dtype == torch.float32


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_get_arch_resolves_the_recsys_archs(arch_id):
    got, want = configs.get_arch(arch_id), jax_get_arch(arch_id)
    assert type(got).__name__ == "RecsysArch"
    assert (got.arch_id, got.kind, got.family, got.shapes) == \
        (want.arch_id, want.kind, want.family, want.shapes)
    tc, jc = got.cfg, want.cfg
    assert [f.name for f in fields(tc)] == [f.name for f in fields(jc)]
    for f in fields(tc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if isinstance(a, torch.dtype):
            assert str(a).removeprefix("torch.") == _jax_dtype_name(b), f.name
        else:
            assert a == b, f.name
    if got.kind == "dlrm":
        assert tc.total_rows == jc.total_rows == 204_185_088
        assert np.array_equal(tc.offsets, jc.offsets)


@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_get_arch_raises_for_what_is_not_ported(arch_id):
    """Nothing is left unported: schnet, the last id to come, resolves to
    a ``GNNArch`` equal to the reference's field for field, its base
    config's and each shape's config's too."""
    got, want = configs.get_arch(arch_id), jax_get_arch(arch_id)
    assert type(got).__name__ == type(want).__name__ == "GNNArch"
    assert (got.arch_id, got.family, got.shapes) == \
        (want.arch_id, want.family, want.shapes)
    for shape in (None, *got.shapes):
        tc = got.cfg_for(shape) if shape else got.base_cfg
        jc = want.cfg_for(shape) if shape else want.base_cfg
        assert [f.name for f in fields(tc)] == [f.name for f in fields(jc)]
        for f in fields(tc):
            a, b = getattr(tc, f.name), getattr(jc, f.name)
            if isinstance(a, torch.dtype):
                assert str(a).removeprefix("torch.") == \
                    _jax_dtype_name(b), f.name
            else:
                assert a == b, f.name
    assert configs.PORTED == set(configs.ARCH_IDS)


def test_get_arch_ids_and_unknown():
    assert configs.ARCH_IDS == JAX_ARCH_IDS
    assert configs.ALIASES == JAX_ALIASES
    assert configs.get_arch("paper_index").family == \
        jax_get_arch("paper_index").family
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("gpt-2")
