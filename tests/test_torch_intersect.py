"""The port's sorted-list membership op against the JAX package's.

The same sorted int32 lists, made from a seed with numpy, go through the
JAX ``intersect_sorted`` (the Pallas kernel in interpret mode) and its
``intersect_ref``, and through the port's ``intersect_sorted`` on the CPU
(its plain version).  The flags must equal ``intersect_ref``'s exactly,
PAD entries of ``a`` never matching; the Pallas kernel's flags are compared
on the entries of ``a`` that are not PAD, since its tile compare finds a
PAD of ``a`` in a ``b`` that holds PAD too (the reference's callers never
pass a padded ``a``).  The CUDA kernel is held against the plain version
by the ``gpu`` test, which runs only where there is a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.intersect.ops import intersect_sorted as jax_intersect
from repro.kernels.intersect.ref import intersect_ref as jax_intersect_ref
from repro_torch.kernels.intersect import ops
from repro_torch.kernels.intersect.ref import PAD, intersect_ref

PAD_NP = np.iinfo(np.int32).max
CASES = ("overlap", "odd-lengths", "disjoint", "pad", "empty-a", "empty-b")


def _lists(case):
    """(a, b) sorted int32 lists for one edge case."""
    rng = np.random.default_rng(CASES.index(case))

    def sorted_unique(n, lo, hi):
        return np.unique(rng.integers(lo, hi, n)).astype(np.int32)

    if case == "overlap":
        return sorted_unique(700, 1, 4000), sorted_unique(1300, 1, 4000)
    if case == "odd-lengths":          # not multiples of 32 (or of 512)
        return sorted_unique(37, 1, 300)[:33], sorted_unique(90, 1, 300)[:61]
    if case == "disjoint":
        return sorted_unique(300, 1, 1000), sorted_unique(300, 2000, 3000)
    if case == "pad":                  # PAD-padded tails on both sides
        a = np.concatenate([sorted_unique(200, 1, 900),
                            np.full(40, PAD_NP, np.int32)])
        b = np.concatenate([sorted_unique(400, 1, 900),
                            np.full(25, PAD_NP, np.int32)])
        return a, b
    if case == "empty-a":
        return np.zeros(0, np.int32), sorted_unique(50, 1, 100)
    if case == "empty-b":
        return sorted_unique(50, 1, 100), np.zeros(0, np.int32)
    raise ValueError(case)


@pytest.mark.parametrize("case", CASES)
def test_port_matches_jax_intersect(case):
    a, b = _lists(case)
    got = ops.intersect_sorted(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.bool and got.shape == (len(a),)
    if len(a) and len(b):
        want = np.asarray(jax_intersect(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
        real = a != PAD_NP
        assert np.array_equal(got.numpy()[real], want[real])
        assert np.array_equal(
            got.numpy(),
            np.asarray(jax_intersect_ref(jnp.asarray(a), jnp.asarray(b))))
    # and the set semantics, PAD never matching
    expect = np.isin(a, b) & (a != PAD_NP)
    assert np.array_equal(got.numpy(), expect)


def test_pad_is_int32_max():
    assert PAD == PAD_NP


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU the op never touches the kernel wrapper."""
    from repro_torch.kernels.intersect import kernel

    def boom(*a, **kw):
        raise AssertionError("kernel wrapper called for CPU tensors")

    monkeypatch.setattr(ops, "intersect_kernel", boom)
    before = kernel.launches
    a, b = (torch.from_numpy(x) for x in _lists("overlap"))
    assert torch.equal(ops.intersect_sorted(a, b), intersect_ref(a, b))
    assert kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """A tensor off the card never falls back to the plain version."""
    from repro_torch.kernels.intersect.kernel import intersect_kernel
    a, b = (torch.from_numpy(x) for x in _lists("overlap"))
    with pytest.raises(ValueError, match="CUDA"):
        intersect_kernel(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.intersect.kernel import intersect_kernel
    a, b = (torch.from_numpy(x).cuda() for x in _lists(case))
    first = intersect_kernel(a, b)
    second = intersect_kernel(a, b)
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), intersect_ref(a, b).cpu())
