"""The port's paged KV cache control plane (``repro_torch.serve.kv_cache``)
against the JAX package's (``repro.serve.kv_cache``, numpy only).

Mirrors the KV-cache cases of ``tests/test_substrates.py`` and drives both
packages' ``PagedKVCache`` through the same operations: after each one, the
pages claimed, the free list, each sequence's pages and capacities, the
overheads and the page tables must be equal, and so must the exhaustion
error.  The Triangle schedule is compared entry for entry.
"""

import numpy as np
import pytest

from repro.serve import PagedKVCache as JaxPool
from repro.serve import triangle_page_schedule as jax_schedule
from repro_torch.serve import PagedKVCache, triangle_page_schedule

POLICIES = ["const", "triangle"]


@pytest.mark.parametrize("base,h_cost", [(16, 1), (8, 1), (16, 4), (1, 1)])
def test_triangle_schedule_matches(base, h_cost):
    got = triangle_page_schedule(base, h_cost=h_cost, max_pages=512)
    assert got == jax_schedule(base, h_cost=h_cost, max_pages=512)
    assert got[0] == base
    assert all(b >= a for a, b in zip(got, got[1:]))
    assert all(s % base == 0 for s in got)


def _state(pool, seq_ids, pad_to):
    return {"free": list(pool.free),
            "seqs": {i: (s.length, list(s.pages), list(s.page_capacity))
                     for i, s in pool.seqs.items()},
            "overhead": {i: pool.overhead_tokens(i) for i in seq_ids
                         if i in pool.seqs},
            "tables": {i: pool.page_table(i, pad_to).tolist()
                       for i in seq_ids if i in pool.seqs}}


#: (op, seq_id, n_tokens): interleaved growth of three sequences, a release
#: that returns pages to the free list, and reuse of those pages
SCRIPT = [("add", 0, 0), ("add", 1, 0), ("append", 0, 1), ("append", 1, 40),
          ("append", 0, 15), ("append", 0, 1), ("add", 2, 0),
          ("append", 2, 300), ("append", 1, 1), ("release", 0, 0),
          ("append", 2, 17), ("append", 1, 100), ("add", 3, 0),
          ("append", 3, 33), ("release", 2, 0), ("append", 3, 250)]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("page_tokens", [16, 8])
def test_pool_matches_step_by_step(policy, page_tokens):
    pools = [PagedKVCache(n_pages=512, page_tokens=page_tokens,
                          policy=policy),
             JaxPool(n_pages=512, page_tokens=page_tokens, policy=policy)]
    for op, sid, n in SCRIPT:
        if op == "add":
            out = [p.add_sequence(sid).seq_id for p in pools]
        elif op == "append":
            out = [p.append_tokens(sid, n) for p in pools]
        else:
            out = [p.release(sid) for p in pools]
        assert out[0] == out[1], (op, sid, n)
        states = [_state(p, range(4), 64) for p in pools]
        assert states[0] == states[1], (op, sid, n)


def test_allocation_and_release():
    pool = PagedKVCache(n_pages=64, page_tokens=16, policy="const")
    pool.add_sequence(0)
    pages = pool.append_tokens(0, 40)  # needs 3 pages
    assert len(pages) == 3
    free_before = len(pool.free)
    pool.release(0)
    assert len(pool.free) == free_before + 3


@pytest.mark.parametrize("n_tokens", [50_000, 200_000])
@pytest.mark.parametrize("policy", POLICIES)
def test_overhead_and_entries_match(policy, n_tokens):
    out = []
    for cls in (PagedKVCache, JaxPool):
        pool = cls(n_pages=100_000, page_tokens=16, policy=policy)
        pool.add_sequence(0)
        pool.append_tokens(0, n_tokens)
        out.append((len(pool.seqs[0].page_capacity),
                    pool.overhead_tokens(0)))
    assert out[0] == out[1]


def test_triangle_overhead_sublinear_vs_const():
    """The paper's §5.4 claim transferred to KV paging: Triangle page-table
    entries grow sub-linearly while Const grows Θ(n)."""
    def entries(policy, n_tokens):
        pool = PagedKVCache(n_pages=100_000, page_tokens=16, policy=policy)
        pool.add_sequence(0)
        pool.append_tokens(0, n_tokens)
        return len(pool.seqs[0].page_capacity)

    assert entries("triangle", 200_000) < entries("const", 200_000) / 4
    growth = entries("triangle", 200_000) / entries("triangle", 50_000)
    assert growth < 2.5
    assert entries("const", 200_000) == 4 * entries("const", 50_000)


@pytest.mark.parametrize("policy", POLICIES)
def test_pool_exhaustion_raises_the_same(policy):
    errors, states = [], []
    for cls in (PagedKVCache, JaxPool):
        pool = cls(n_pages=6, page_tokens=16, policy=policy)
        pool.add_sequence(0)
        pool.append_tokens(0, 20)
        with pytest.raises(MemoryError) as e:
            pool.append_tokens(0, 1000)
        errors.append(str(e.value))
        states.append(_state(pool, [0], 8))
    assert errors[0] == errors[1]
    assert states[0] == states[1]


def test_page_table_pads_with_minus_one():
    pool = PagedKVCache(n_pages=32, page_tokens=16, policy="triangle")
    pool.add_sequence(5)
    pool.append_tokens(5, 70)
    table = pool.page_table(5, 12)
    assert table.dtype == np.int32
    n = len(pool.seqs[5].pages)
    assert (table[n:] == -1).all() and (table[:n] >= 0).all()
