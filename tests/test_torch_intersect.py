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

The kernel takes all further lists of a conjunctive query in one launch;
its plain version for several lists, ``intersect_all_ref``, is held to the
AND over the lists of the JAX ``intersect_ref`` and of the Pallas kernel
(the cases of ``test_torch_gpu_term_kernels.py``), and the kernel backend
to one call per conjunctive query of two or more terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.intersect.ops import intersect_sorted as jax_intersect
from repro.kernels.intersect.ref import intersect_ref as jax_intersect_ref
from repro_torch.kernels.intersect import ops
from repro_torch.kernels.intersect.ref import (PAD, intersect_all_ref,
                                               intersect_ref)

from test_torch_gpu_term_kernels import intersect_cases

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


# --------------------------------------------------------------------------
# several further lists in one call, as the kernel takes them
# --------------------------------------------------------------------------

#: the cases of the ``gpu`` file but Path A's full shape, too large for the
#: Pallas kernel's interpret mode (a grid step per pair of 512-docid tiles)
MULTI = tuple(k for k in intersect_cases() if not k.startswith("Path A"))


def _jax_and(fn, a, lists):
    """The AND over the lists of a JAX one-list call (an empty list holds
    nothing)."""
    out = np.ones(len(a), bool)
    for b in lists:
        out &= (np.asarray(fn(jnp.asarray(a), jnp.asarray(b))) if len(b)
                else np.zeros(len(a), bool))
    return out


@pytest.mark.parametrize("case", MULTI)
def test_all_lists_match_the_jax_and(case):
    """``intersect_sorted(a, b, offsets)`` on the CPU (``intersect_all_ref``)
    equals the AND of the JAX ``intersect_ref`` over the lists, and of the
    Pallas kernel in interpret mode on the entries of ``a`` that are not
    PAD."""
    a, lists = intersect_cases()[case]
    bounds = np.cumsum([0] + [len(x) for x in lists]).astype(np.int32)
    got = ops.intersect_sorted(torch.from_numpy(a),
                               torch.from_numpy(np.concatenate(lists)),
                               offsets=torch.from_numpy(bounds)).numpy()
    assert np.array_equal(got, _jax_and(jax_intersect_ref, a, lists))
    real = a != PAD_NP
    pallas = _jax_and(lambda x, y: jax_intersect(x, y, interpret=True), a,
                      lists)
    assert np.array_equal(got[real], pallas[real])
    want = real & np.logical_and.reduce([np.isin(a, b) for b in lists])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bounds", [[0, 5], [0, 0, 5], [0, 3, 3, 5],
                                    [2, 4], [0, 5, 5]])
def test_all_lists_plain_version_is_the_and(bounds):
    """Host bounds (a list) and tensor bounds give the AND of the one-list
    plain version over the slices they mark."""
    a = torch.tensor([1, 2, 3, 5, 8, PAD], dtype=torch.int32)
    b = torch.tensor([1, 3, 5, 2, 3], dtype=torch.int32)
    want = torch.ones(6, dtype=torch.bool)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        want &= intersect_ref(a, b[lo:hi])
    assert torch.equal(intersect_all_ref(a, b, bounds), want)
    assert torch.equal(intersect_all_ref(
        a, b, torch.tensor(bounds, dtype=torch.int32)), want)


def test_offsets_must_bound_a_list():
    a = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="at least one list"):
        intersect_all_ref(a, a, [0])


def test_kernel_backend_makes_one_call_per_conjunctive_query(monkeypatch):
    """A conjunctive query of n >= 2 terms makes one intersect call with
    its n - 1 further lists; a one-term query makes none.  Answers equal
    the host backend's."""
    from dataclasses import replace

    from repro_torch.engine import Engine, Query
    from repro_torch.kernels import registry
    rng = np.random.default_rng(3)
    names = [f"w{i}" for i in range(40)]
    eng = Engine(B=64, growth="triangle", device="cpu")
    eng.add_documents([[names[i] for i in rng.integers(0, 40, 25)]
                       for _ in range(300)])
    spec = registry.get("intersect")
    calls = []

    def counting(a, b, offsets=None):
        calls.append(None if offsets is None else len(offsets) - 1)
        return spec.fn(a, b, offsets=offsets)

    monkeypatch.setitem(registry._REGISTRY, "intersect",
                        replace(spec, fn=counting))
    for n in (1, 2, 3, 4):
        terms = tuple(names[:n])
        calls.clear()
        got = eng.execute(Query(terms=terms, mode="conjunctive",
                                backend="kernel"))
        want = eng.execute(Query(terms=terms, mode="conjunctive",
                                 backend="host"))
        assert got.docids.tolist() == want.docids.tolist()
        assert len(want.docids) > 0
        assert calls == ([] if n == 1 else [n - 1])
