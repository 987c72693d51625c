"""The port's two-tower candidate-scoring op against the JAX package's.

The same query and candidate embeddings, made from a seed with numpy, go
through the JAX ``candidate_scores`` (the Pallas kernel in interpret mode,
tiled as ``tests/test_kernels.py`` runs it) and its ``retrieval_dot_ref``,
and through the port's ``candidate_scores`` on the CPU (its plain
version), in float32 and bf16.  Tolerance rtol 1e-5, atol 2e-5: both sides
accumulate in float32 in different orders (the Pallas kernel by 32-wide
slices of d); the reference's own test allows 1e-4.  The CUDA kernel is
held against the plain version by the ``gpu`` tests in
``tests/test_torch_gpu_dense_kernels.py``, which import no jax and run on
the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.retrieval_dot.ops import candidate_scores as jax_scores
from repro.kernels.retrieval_dot.ref import retrieval_dot_ref as jax_ref
from repro_torch.kernels import registry
from repro_torch.kernels.retrieval_dot import ops
from repro_torch.kernels.retrieval_dot.ref import retrieval_dot_ref

SHAPES = [(8, 700, 96), (1, 2048, 256), (17, 333, 64), (3, 1000, 30)]
#: at the kernel's blocking: n off its 2 rows a warp and 16 a block, d off
#: its 256-float pass and d % 4 != 0, q past its 8-row query tile
EDGE_SHAPES = [(1, 7, 256), (1, 4099, 256), (17, 4099, 30), (2, 333, 31),
               (9, 17, 260)]
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
RTOL, ATOL = 1e-5, 2e-5


def _inputs(q, n, d, dtype):
    """(jax q, jax cand, torch q, torch cand) holding the same values."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(q * n + d)
    qv = jnp.asarray(rng.standard_normal((q, d)), jdt)
    cv = jnp.asarray(rng.standard_normal((n, d)), jdt)

    def port(x):       # exact: the values are representable in ``tdt``
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)

    return qv, cv, port(qv), port(cv)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q,n,d", SHAPES + EDGE_SHAPES)
def test_port_matches_jax_candidate_scores(q, n, d, dtype):
    qv, cv, tq, tc = _inputs(q, n, d, dtype)
    got = ops.candidate_scores(tq, tc)
    assert got.dtype == torch.float32 and got.shape == (q, n)
    pallas = np.asarray(jax_scores(qv, cv, tile_q=8, tile_n=128, tile_d=32,
                                   interpret=True))
    ref = np.asarray(jax_ref(qv, cv))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, retrieval_dot_ref(tq, tc))


@pytest.mark.parametrize("q", [1, 5])
def test_no_candidates_give_an_empty_row_per_query(q):
    from repro_torch.kernels.retrieval_dot import kernel
    before = kernel.launches
    out = ops.candidate_scores(torch.ones(q, 16), torch.ones(0, 16))
    assert out.shape == (q, 0) and out.dtype == torch.float32
    assert kernel.launches == before


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU the op never touches the kernel wrapper."""
    from repro_torch.kernels.retrieval_dot import kernel

    def boom(*a, **kw):
        raise AssertionError("kernel wrapper called for CPU tensors")

    monkeypatch.setattr(ops, "retrieval_dot_kernel", boom)
    before = kernel.launches
    _qv, _cv, tq, tc = _inputs(8, 700, 96, "f32")
    assert torch.equal(ops.candidate_scores(tq, tc),
                       retrieval_dot_ref(tq, tc))
    assert kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """A tensor off the card never falls back to the plain version."""
    from repro_torch.kernels.retrieval_dot.kernel import retrieval_dot_kernel
    _qv, _cv, tq, tc = _inputs(1, 2048, 256, "f32")
    with pytest.raises(ValueError, match="CUDA"):
        retrieval_dot_kernel(tq, tc)


def test_registered_outside_the_term_modes():
    spec = registry.get("retrieval_dot")
    assert spec.fn is ops.candidate_scores and spec.modes == ()
