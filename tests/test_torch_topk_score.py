"""The port's score-accumulation op against the JAX package's.

The same (docid, weight) postings, made from a seed with numpy as a run of
segments of distinct ascending docids (one per query term, as the kernel
backend builds them), go through the JAX ``score_accumulate`` (the Pallas
kernel in interpret mode) and through the port's ``score_accumulate`` on
the CPU (its plain version).  With one segment every docid receives one
weight and the two agree exactly; with several, the JAX kernel sums each
docid's weights by one-hot matrix products tile by tile, the port segment
by segment, so the scores agree to rtol 1e-6 (float32 sums of up to four
terms in another order).  Docid 0 is the padding bucket: zero in both.
``n_docs`` stays at most 2,048, so the interpret mode stays quick.  The
CUDA kernel is held against the plain version by the ``gpu`` test, which
runs only where there is a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_score.ops import score_accumulate as jax_score
from repro_torch.kernels.topk_score import ops
from repro_torch.kernels.topk_score.ref import score_ref, segment_offsets


def _postings(nseg, n_docs, seed, with_zero=False):
    rng = np.random.default_rng(seed)
    ds, ws, offsets = [], [], [0]
    for _ in range(nseg):
        n = int(rng.integers(1, n_docs // 2))
        d = np.sort(rng.choice(np.arange(1, n_docs), size=n, replace=False))
        if with_zero:
            d = np.concatenate([[0], d[:-1]])
        ds.append(d.astype(np.int32))
        ws.append((rng.random(n) * 5).astype(np.float32))
        offsets.append(offsets[-1] + n)
    return np.concatenate(ds), np.concatenate(ws), offsets


CASES = [(1, 1500, False), (3, 2048, False), (4, 777, True), (2, 40, True)]


@pytest.mark.parametrize("nseg,n_docs,with_zero", CASES)
def test_port_matches_jax_score_accumulate(nseg, n_docs, with_zero):
    d, w, offsets = _postings(nseg, n_docs, seed=nseg * n_docs,
                              with_zero=with_zero)
    want = np.asarray(jax_score(jnp.asarray(d), jnp.asarray(w), n_docs=n_docs,
                                interpret=True))
    dt, wt = torch.from_numpy(d), torch.from_numpy(w)
    got = ops.score_accumulate(dt, wt, n_docs).numpy()
    assert got.shape == (n_docs,) and got[0] == 0.0 and want[0] == 0.0
    if nseg == 1:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # summing the caller's segments one by one gives the same bits as the
    # maximal ascending runs found from the data
    seg = torch.zeros(n_docs)
    for s, e in zip(offsets[:-1], offsets[1:]):
        keep = dt[s:e] < n_docs
        seg.index_add_(0, dt[s:e][keep].long(), wt[s:e][keep])
    seg[0] = 0.0
    assert np.array_equal(seg.numpy().view(np.int32), got.view(np.int32))
    # and so does the op given the caller's bounds
    given = ops.score_accumulate(dt, wt, n_docs, offsets=offsets).numpy()
    assert np.array_equal(given.view(np.int32), got.view(np.int32))


def test_segment_offsets_split_at_descents():
    d = torch.tensor([1, 5, 9, 2, 3, 3, 7], dtype=torch.int32)
    assert segment_offsets(d) == [0, 3, 5, 7]
    assert segment_offsets(torch.zeros(0, dtype=torch.int32)) == [0, 0]


def test_empty_input_gives_zeros():
    got = ops.score_accumulate(torch.zeros(0, dtype=torch.int32),
                               torch.zeros(0, dtype=torch.float32), 300)
    assert torch.equal(got, torch.zeros(300))


def test_out_of_range_docids_are_dropped():
    d = torch.tensor([3, 7, 12], dtype=torch.int32)
    w = torch.tensor([1.0, 2.0, 4.0])
    got = ops.score_accumulate(d, w, 10)
    want = torch.zeros(10)
    want[3], want[7] = 1.0, 2.0
    assert torch.equal(got, want)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU the op never touches the kernel wrapper."""
    from repro_torch.kernels.topk_score import kernel

    def boom(*a, **kw):
        raise AssertionError("kernel wrapper called for CPU tensors")

    monkeypatch.setattr(ops, "score_kernel", boom)
    before = kernel.launches
    d, w, _offsets = _postings(3, 500, seed=5)
    dt, wt = torch.from_numpy(d), torch.from_numpy(w)
    assert torch.equal(ops.score_accumulate(dt, wt, 500),
                       score_ref(dt, wt, 500))
    assert kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """A tensor off the card never falls back to the plain version."""
    from repro_torch.kernels.topk_score.kernel import score_kernel
    d, w, offsets = _postings(2, 300, seed=9)
    with pytest.raises(ValueError, match="CUDA"):
        score_kernel(torch.from_numpy(d), torch.from_numpy(w), 300,
                     torch.tensor(offsets, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("nseg,n_docs,with_zero", CASES)
def test_cuda_kernel_matches_plain_version(nseg, n_docs, with_zero):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.topk_score.kernel import score_kernel
    d, w, offsets = _postings(nseg, n_docs, seed=nseg + n_docs,
                              with_zero=with_zero)
    dt, wt = torch.from_numpy(d).cuda(), torch.from_numpy(w).cuda()
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    first = score_kernel(dt, wt, n_docs, off)
    second = score_kernel(dt, wt, n_docs, off)
    plain = score_ref(dt, wt, n_docs)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert torch.equal(first.cpu().view(torch.int32),
                       plain.cpu().view(torch.int32))
