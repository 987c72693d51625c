"""Paged KV cache with Triangle page-table growth (beyond-paper transfer).

The paper's §5.4 result — square-root block growth makes extensible-list
overhead o(n) instead of Θ(n) — applies to ANY append-only buffer whose final
length is unknown.  A serving KV cache is exactly that: each sequence's cache
grows one token at a time to an unknown final length.  vLLM-style paged
attention uses Const pages (linear page-table overhead + fixed tail waste);
here the per-sequence page capacity follows the paper's Eq. 6, so long
sequences hold a few large pages (small page tables, coalesced DMA) while
short sequences never over-allocate — the same head-block trick as §3.2:
the first page is small, later pages grow as sqrt of tokens held.

Device-side, pages live in one big (n_pages, page_tokens, kv_heads, d_head)
pool; the page table indirection is a gather, as in PagedAttention.  The
allocator below is the host-side control plane (as in vLLM); tests verify
the o(n) overhead claim against Const/Expon paging empirically.

A copy of the JAX package's ``serve/kv_cache.py``, which is numpy only.  As
there, the decode loop (``launch/serve.py`` ``serve_lm``) keeps this
control plane beside a dense (L, B, S, KV*d_head) cache on the device: the
pages account for the tokens, they do not yet hold them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def triangle_page_schedule(base_tokens: int, h_cost: int = 1,
                           max_pages: int = 4096) -> list[int]:
    """Per-page token capacities following Eq. 6 (B-aligned to base)."""
    sizes = [base_tokens]
    n = base_tokens
    for _ in range(max_pages - 1):
        raw = h_cost + math.sqrt(2.0 * h_cost * n)
        sizes.append(base_tokens * max(1, math.ceil(raw / base_tokens)))
        n += sizes[-1]
    return sizes


@dataclass
class SequenceState:
    seq_id: int
    length: int = 0
    pages: list[int] = field(default_factory=list)   # physical page ids
    page_capacity: list[int] = field(default_factory=list)


class PagedKVCache:
    """Host control plane of the paged KV pool (the device pool is a tensor).

    ``policy`` ∈ {"const", "triangle"}: const = vLLM-style fixed pages;
    triangle = the paper's growth schedule (capacities in units of the base
    page, physically realized as runs of consecutive base pages so the device
    pool stays uniform).
    """

    def __init__(self, n_pages: int, page_tokens: int = 16,
                 policy: str = "triangle"):
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.policy = policy
        self.free: list[int] = list(range(n_pages - 1, -1, -1))
        self.seqs: dict[int, SequenceState] = {}
        self._tri = triangle_page_schedule(page_tokens)

    # -- allocation -------------------------------------------------------

    def _next_capacity(self, seq: SequenceState) -> int:
        if self.policy == "const":
            return self.page_tokens
        z = len(seq.pages)
        return self._tri[min(z, len(self._tri) - 1)]

    def add_sequence(self, seq_id: int) -> SequenceState:
        s = SequenceState(seq_id=seq_id)
        self.seqs[seq_id] = s
        return s

    def append_tokens(self, seq_id: int, n_tokens: int) -> list[int]:
        """Reserve space for n new tokens; returns newly-claimed page ids."""
        s = self.seqs[seq_id]
        claimed: list[int] = []
        capacity = sum(s.page_capacity)
        s.length += n_tokens
        while capacity < s.length:
            cap = self._next_capacity(s)
            units = cap // self.page_tokens
            if len(self.free) < units:
                raise MemoryError("KV pool exhausted (preemption point)")
            run = [self.free.pop() for _ in range(units)]
            s.pages.extend(run)
            s.page_capacity.append(cap)
            claimed.extend(run)
            capacity += cap
        return claimed

    def release(self, seq_id: int) -> None:
        s = self.seqs.pop(seq_id)
        self.free.extend(reversed(s.pages))

    # -- accounting (the §5.4 claim, measured) ------------------------------

    def overhead_tokens(self, seq_id: int) -> int:
        """Allocated-but-unused token slots + 1 slot/page table entry."""
        s = self.seqs[seq_id]
        return sum(s.page_capacity) - s.length + len(s.page_capacity)

    def page_table(self, seq_id: int, pad_to: int) -> np.ndarray:
        s = self.seqs[seq_id]
        out = np.full(pad_to, -1, np.int32)
        out[: len(s.pages)] = s.pages
        return out
