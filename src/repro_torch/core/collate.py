"""Periodic collation (paper §5.5).

Rewrites the index array ``I`` so that every term's chain of blocks is stored
contiguously, in chain order.  Nothing inside any block changes except the
``n_ptr``/``t_ptr`` link fields; the hash array is updated to the new head
offsets.  On the paper's hardware this restored spatial locality (66% fewer
cache misses, conjunctive latency halved — Table 14); on TPU the same
permutation turns per-block gathers into a single contiguous DMA per term
(see device_index.py, which requires a collated image).

The paper performs the permutation through a disk file with ingest stalled;
we perform it in memory with the same observable result (a brief
stop-the-world copy), and expose ``collate()`` both as an in-place operation
and as a pure function returning a new index.

Collation is the FREEZE point of the engine's device-image lifecycle
(``repro_torch.engine``): ``Engine.collate_now`` collates, snapshots the result as
the frozen device image, and captures a ``DeltaBaseline`` so every later
refresh ships only post-freeze blocks to the device.  ``collation_stats``
quantifies how fragmented the chains currently are — the signal for deciding
when a full re-collation pays for itself.
"""

from __future__ import annotations

import numpy as np

from .blockstore import _OFF_NPTR, _OFF_TPTR, BlockStore
from .index import DynamicIndex


def collate(index: DynamicIndex) -> DynamicIndex:
    """Return a new DynamicIndex whose chains are contiguous (§5.5)."""
    store = index.store
    B = store.B
    new_store = BlockStore(B=B, policy=store.policy, F=store.F,
                           word_level=store.word_level,
                           initial_slots=max(1, store.nblocks))
    new_hash = np.zeros_like(index.hash)
    write_ptr = 0
    # §5.5: visit every non-empty element of (a copy of) the hash array; for
    # each term copy head block then the rest of the chain, rewriting links.
    for slot in np.flatnonzero(index.hash):
        h_ptr = int(index.hash[slot]) - 1
        chain = list(store.chain_slots(h_ptr))
        new_ptrs = []
        p = write_ptr
        for ptr, z, _ in chain:
            size = B if store.const_mode else store.block_size_at(z)
            slots = (size + B - 1) // B
            new_ptrs.append(p)
            p += slots
        # copy block bytes
        for (ptr, z, _), np_ in zip(chain, new_ptrs):
            size = B if store.const_mode else store.block_size_at(z)
            src = ptr * B
            dst = np_ * B
            new_store.I[dst:dst + size] = store.I[src:src + size]
        # rewrite links: n_ptr of every non-tail block, and head t_ptr
        hb = new_ptrs[0] * B
        new_store._set_u32(hb + _OFF_TPTR, new_ptrs[-1])
        for i in range(len(new_ptrs) - 1):
            base = new_ptrs[i] * B
            new_store._set_u32(base + _OFF_NPTR, new_ptrs[i + 1])
        new_hash[slot] = new_ptrs[0] + 1
        write_ptr = p
    new_store.nblocks = write_ptr
    out = DynamicIndex.__new__(DynamicIndex)
    out.store = new_store
    out.word_level = index.word_level
    out.F = index.F
    out.hash = new_hash
    out.vocab_size = index.vocab_size
    out.num_docs = index.num_docs
    out.num_postings = index.num_postings
    out.num_words = index.num_words
    out.tombstones = set(index.tombstones)
    out._cache = {}
    return out


def collation_stats(index: DynamicIndex) -> dict:
    """Fragmentation report: how far the store is from collated order.

    Returns chain/block counts plus ``fragmented_blocks`` — blocks that do
    not sit at their chain-contiguous position (each is one non-sequential
    cache line / DMA descriptor at query time).  ``frag_ratio`` near 0 means
    a fresh collation would buy little (Table 14's locality win is already
    in hand)."""
    store = index.store
    B = store.B
    chains = blocks = fragmented = 0
    for h_ptr in index.head_ptrs():
        chains += 1
        expect = h_ptr
        for ptr, z, _ in store.chain_slots(h_ptr):
            blocks += 1
            if ptr != expect:
                fragmented += 1
            size = B if store.const_mode else store.block_size_at(z)
            expect = ptr + (size + B - 1) // B
    return {"chains": chains, "blocks": blocks,
            "fragmented_blocks": fragmented,
            "frag_ratio": fragmented / max(1, blocks)}


def is_collated(index: DynamicIndex) -> bool:
    """True if every chain occupies consecutive slots in chain order."""
    store = index.store
    B = store.B
    for h_ptr in index.head_ptrs():
        expect = h_ptr
        for ptr, z, _ in store.chain_slots(h_ptr):
            if ptr != expect:
                return False
            size = B if store.const_mode else store.block_size_at(z)
            expect = ptr + (size + B - 1) // B
    return True
