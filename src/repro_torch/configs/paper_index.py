"""paper-index: the paper's own architecture — the distributed
immediate-access dynamic index (document-partitioned query step over a
``DeviceMesh``), as the JAX package's ``src/repro/configs/paper_index.py``
sizes it.

Production sizing per shard: 2^20 Const-64 blocks (64 MiB of index,
≈ 30M postings at the paper's ~2.1 B/posting), 2^17 vocabulary terms, 2^20
documents; a batch of 256 conjunctive/ranked queries of up to 8 terms is
split over the "model" axis while the index is split over ("pod", "data").

The reference's ``Cell`` (``configs/common.py``) carries JAX shardings and
imports the ML models, so :meth:`IndexArch.build` returns the port's own
small record, :class:`IndexCell`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..core.sharded_index import make_sharded_query_step, sharded_input_specs

INDEX_SHAPES = {
    # (blocks/shard, vocab/shard, docs/shard, qbatch, qterms, max_blocks)
    "query_rank": dict(shard_blocks=1 << 20, vocab=1 << 17, docs=1 << 20,
                       qbatch=256, qterms=8, max_blocks=64),
    "query_rank_hot": dict(shard_blocks=1 << 18, vocab=1 << 15,
                           docs=1 << 18, qbatch=1024, qterms=4,
                           max_blocks=32),
    # conjunctive Boolean (the paper's §4.6 headline mode): hit bitmaps stay
    # on their shards; the only collective is the per-query count sum
    "query_conj": dict(shard_blocks=1 << 20, vocab=1 << 17, docs=1 << 20,
                       qbatch=256, qterms=4, max_blocks=64,
                       mode="conjunctive"),
}


@dataclass
class IndexCell:
    """What :meth:`IndexArch.build` returns: the rank's step ``fn`` and
    meta-tensor stand-ins ``args`` of its stacked inputs."""

    arch_id: str
    shape_id: str
    kind: str
    fn: Callable
    args: tuple
    model_flops: float
    notes: str = ""


@dataclass
class IndexArch:
    arch_id: str = "paper-index"
    family: str = "index"
    shapes: tuple = tuple(INDEX_SHAPES)

    def flops(self, shape_id: str) -> float:
        # The index workload is integer/memory bound: "useful work" is the
        # decoded-postings volume. We count 2 int-ops per payload byte
        # (shift+or) plus the score multiply-accumulate per posting.
        s = INDEX_SHAPES[shape_id]
        blocks_touched = s["qbatch"] * s["qterms"] * s["max_blocks"]
        payload = blocks_touched * 64
        return float(2 * payload + 2 * blocks_touched * 30)

    def build(self, mesh, shape_id: str, decode_fn=None,
              mode: str | None = None) -> IndexCell:
        """``mode='ranked'`` is the paper-faithful dense-accumulator scorer;
        ``ranked_sparse`` is the sort-based aggregation (the default);
        ``conjunctive`` is the Boolean mode (shape query_conj)."""
        s = INDEX_SHAPES[shape_id]
        if mode is None:
            mode = s.get("mode", "ranked_sparse")
        fn = make_sharded_query_step(
            mesh, k=10, max_blocks=s["max_blocks"], num_docs=s["docs"],
            decode_fn=decode_fn, mode=mode)
        args = sharded_input_specs(
            mesh, shard_blocks=s["shard_blocks"], B=64, vocab=s["vocab"],
            qbatch=s["qbatch"], qterms=s["qterms"])
        return IndexCell("paper-index", shape_id, "query_step", fn, args,
                         self.flops(shape_id),
                         notes=f"document-partitioned query fusion [{mode}]")


ARCH = IndexArch()
