"""Graph substrate: CSR storage, synthetic graphs, and a real neighbor
sampler.

A copy of the JAX package's ``src/repro/data/graph.py``, which is numpy
only: from the same seed, and the sampler from the same
``np.random.Generator``, it returns the same arrays bit for bit.  The
sampler is host-side numpy over CSR (as in every production GNN system:
DGL and PyG sample on CPU workers), emitting fixed-shape padded blocks
that the model consumes.

:func:`synthetic_power_law` draws each edge's destination as
``zipf(1.5) mod n``, so about 1/zeta(1.5), 38 %, of all edges point at
node 1: a hot spot of this generator, not of any published graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray   # (N+1,) int64
    indices: np.ndarray  # (E,) int32 — neighbor ids
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])


def synthetic_power_law(n_nodes: int, avg_degree: int,
                        seed: int = 0) -> CSRGraph:
    """Preferential-attachment-flavoured random graph in CSR."""
    rng = np.random.default_rng(seed)
    m = n_nodes * avg_degree
    # power-law destination popularity
    pop = rng.zipf(1.5, size=m).astype(np.int64) % n_nodes
    src = rng.integers(0, n_nodes, m)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], pop[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int32),
                    n_nodes=n_nodes)


@dataclass
class SampledBlock:
    """One layer of a sampled computation block (fixed/padded shapes)."""

    src: np.ndarray    # (E_pad,) int32 — positions into prev layer's nodes
    dst: np.ndarray    # (E_pad,) int32 — positions into this layer's seeds
    mask: np.ndarray   # (E_pad,) bool
    nodes: np.ndarray  # (N_pad,) int32 — global node ids of the layer input


def neighbor_sample(graph: CSRGraph, seeds: np.ndarray, fanouts: list[int],
                    rng: np.random.Generator) -> list[SampledBlock]:
    """GraphSAGE-style layered fanout sampling.

    Returns one block per layer, outermost first; block L maps its sampled
    frontier (src) onto the previous frontier (dst).  Shapes are padded to
    len(seeds_at_layer) * fanout, so every batch of a layer has one shape.
    """
    blocks: list[SampledBlock] = []
    frontier = seeds.astype(np.int64)
    for fan in fanouts:
        n_seed = len(frontier)
        e_pad = n_seed * fan
        src_g = np.zeros(e_pad, np.int64)    # global sampled neighbor ids
        dst_l = np.repeat(np.arange(n_seed, dtype=np.int32), fan)
        mask = np.zeros(e_pad, bool)
        for i, v in enumerate(frontier):
            lo, hi = int(graph.indptr[v]), int(graph.indptr[v + 1])
            deg = hi - lo
            if deg == 0:
                continue
            take = min(fan, deg)
            pick = rng.choice(deg, size=take, replace=deg < fan)
            src_g[i * fan: i * fan + take] = graph.indices[lo + pick]
            mask[i * fan: i * fan + take] = True
        # unique-ify the new frontier: frontier nodes first, then neighbors
        uniq, inv = np.unique(src_g[mask], return_inverse=True)
        layer_nodes = np.concatenate([frontier, uniq])
        src_l = np.zeros(e_pad, np.int32)
        src_l[mask] = (inv + n_seed).astype(np.int32)
        blocks.append(SampledBlock(src=src_l, dst=dst_l, mask=mask,
                                   nodes=layer_nodes.astype(np.int32)))
        frontier = layer_nodes.astype(np.int64)
    return blocks


def pad_block(block: SampledBlock, n_pad: int) -> SampledBlock:
    nodes = np.zeros(n_pad, np.int32)
    nodes[: len(block.nodes)] = block.nodes
    return SampledBlock(src=block.src, dst=block.dst, mask=block.mask,
                        nodes=nodes)


def edges_coo(graph: CSRGraph) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> (src, dst) COO int32 arrays."""
    src = np.repeat(np.arange(graph.n_nodes, dtype=np.int32),
                    np.diff(graph.indptr).astype(np.int64))
    return src, graph.indices.astype(np.int32)
