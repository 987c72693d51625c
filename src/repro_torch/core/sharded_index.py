"""Distributed immediate-access index: the device-mesh query step over
``torch.distributed``, and the host fleet.

This realizes the paper's Figure 2 at datacenter scale.  Each rank of a
``DeviceMesh`` owns one document shard (a collated device image of its
slice of the stream); queries go to every shard and the per-shard top-k
results are fused:

  mesh axes:  "data" (and "pod" when multi-pod) partition the document space;
              "model" partitions the query batch.

  query:      replicated over data/pod, split over model
  index:      split over (pod, data), replicated over model
  execution:  local decode+score (device_index.query_step)
              -> local top-k
              -> all_gather over (pod, data)
              -> merge top-k            (the paper's "results fused")

Conjunctive queries need no merge (docid spaces are disjoint): each rank
keeps its hit bitmap, and only the per-query counts are summed.

Local docids are 1..N_shard; global ids are ``doc_offset[shard] + local``,
where the offsets are the exclusive prefix sum of the shards' own document
counts (:func:`shard_doc_offsets`) — exact even when shard sizes diverge.

Two layers live here:

  * :class:`ShardedQueryStep` (:func:`make_sharded_query_step`), the
    reference's ``shard_map`` query step as the code each rank runs, with
    ``torch.distributed`` collectives over the mesh's document axes, and
    :func:`sharded_query_plain`, the same step in one process; and
  * :class:`ShardedEngine` — the host-level fan-out of per-shard
    :class:`~repro_torch.engine.Engine` s with fleet-wide ranking
    statistics, coordinated freezes and fleet snapshots.  Each shard's
    device images live on its ``Engine.device``: the card unless
    ``device="cpu"`` is passed through ``engine_kwargs``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .device_index import DeviceIndex, _top_k, query_step

_META = ("term_slot", "term_nblk", "term_skip", "term_nx", "term_ft")


def stack_images(images: list[DeviceIndex]) -> DeviceIndex:
    """Concatenate per-shard images along a leading shard axis.

    All shards must share (V, B) and are padded to the max block count.
    ``num_docs`` of the stacked image is the TOTAL collection size (the sum
    over shards — a collection statistic, not a per-shard capacity; the
    per-shard docid capacity is the ``num_docs`` argument of
    :func:`make_sharded_query_step`, and per-shard rank offsets come from
    :func:`shard_doc_offsets`, so shards of unequal size globalize
    correctly).
    """
    nb = max(int(im.blocks.shape[0]) for im in images)

    def padb(x):
        return torch.cat([x, x.new_zeros((nb - x.shape[0], x.shape[1]))])

    return DeviceIndex(
        blocks=torch.cat([padb(im.blocks) for im in images]),
        **{f: torch.cat([getattr(im, f) for im in images]) for f in _META},
        num_docs=sum(im.num_docs for im in images), F=images[0].F)


def shard_doc_offsets(images: list[DeviceIndex]) -> torch.Tensor:
    """Per-shard global-docid offsets (int32): shard i's local docid d maps
    to ``offsets[i] + d``.  Built from each shard's OWN ``num_docs`` (an
    exclusive prefix sum), so shards of different sizes pack the global
    docid space contiguously — a uniform ``rank * max(num_docs)`` stride
    would leave holes and disagree with any host-side mapping that
    concatenates the shard collections."""
    off = [0]
    for im in images[:-1]:
        off.append(off[-1] + int(im.num_docs))
    return torch.tensor(off, dtype=torch.int32)


def stacked_shard(stacked: DeviceIndex, offsets: torch.Tensor,
                  shard: int) -> tuple[DeviceIndex, int]:
    """Shard ``shard``'s image and offset out of :func:`stack_images` —
    the slice the reference's ``P(("pod", "data"))`` hands that shard, its
    slots local to its own (padded) block array."""
    S = len(offsets)
    nb = stacked.blocks.shape[0] // S
    V = stacked.term_slot.shape[0] // S
    ends = offsets.tolist()[1:] + [stacked.num_docs]
    off = int(offsets[shard])
    return DeviceIndex(
        blocks=stacked.blocks[shard * nb:(shard + 1) * nb],
        **{f: getattr(stacked, f)[shard * V:(shard + 1) * V] for f in _META},
        num_docs=ends[shard] - off, F=stacked.F), off


def doc_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that partition the documents, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def _all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *t.shape): ``t`` from every rank of ``group``, by group rank."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


class ShardedQueryStep:
    """The query step one rank of ``mesh`` runs (the reference's mapped
    ``shard_map`` function).  Build it with :func:`make_sharded_query_step`.

    ``step(image, offset, qterms, qmask)`` takes this rank's own shard
    image (slots local to its own block array), its global-docid offset
    and the whole replicated query batch, of which it answers its
    ``"model"`` slice of ``Q / model`` rows (``P("model", None)``):

      * ranked modes (``ranked``, ``ranked_sparse``): ``query_step`` on the
        shard, docids globalized as ``offset + local`` where > 0, the (Q_l,
        k) top-k all-gathered over the document axes and re-selected: the
        shards' lists concatenate shard-major and a stable sort keeps the
        lower index first among equal scores, so the order is score
        descending, then global docid ascending.  The reference gathers
        over "pod" then "data", which on a multi-pod mesh concatenates
        data-major and breaks cross-shard ties in the order of that
        concatenation; the port gathers data first and keeps the global
        docid order on every mesh.  Returns ``(docids (Q_l, k) int32,
        scores (Q_l, k) float32)``, the same on every shard of a model
        slice.
      * ``conjunctive``: returns ``(matches (Q_l, num_docs) bool, counts
        (Q_l,))``: this shard's own hit bitmap, whose column j is its
        LOCAL docid j + 1 (not offset-mapped: the reference's
        ``P("model", doc_axes)`` output tiles the shards' bitmaps, so the
        whole answer's column ``s * num_docs + j`` is shard s's docid
        j + 1), and the counts summed over the document axes.

    :meth:`local` and :meth:`fuse` are the two halves of a call (the rank's
    own work, then the collectives), for timing; :meth:`assemble` gathers
    the whole batch's answer.  Collectives run on tensors of the mesh's
    device type: CUDA tensors for NCCL; for gloo the (Q_l, k) results and
    counts are copied to the host before a collective and back after it,
    while the decode and scoring stay on the image's device.
    """

    def __init__(self, mesh, *, k: int, max_blocks: int, num_docs: int,
                 F: int, decode_fn, mode: str):
        if "model" not in mesh.mesh_dim_names:
            raise ValueError("the mesh needs a 'model' axis")
        self.mesh = mesh
        self.k, self.max_blocks, self.num_docs, self.F = (k, max_blocks,
                                                          num_docs, F)
        self.decode_fn, self.mode = decode_fn, mode
        self.axes = doc_axes(mesh)
        self.num_shards = int(np.prod([_axis_size(mesh, a)
                                       for a in self.axes]))
        self.shard = 0
        for a in self.axes:           # P(("pod", "data")): pod-major
            self.shard = (self.shard * _axis_size(mesh, a)
                          + mesh.get_local_rank(a))
        self.model_size = _axis_size(mesh, "model")
        self.model = mesh.get_local_rank("model")
        self.comm = torch.device(mesh.device_type)

    def local(self, image: DeviceIndex, offset: int, qterms: torch.Tensor,
              qmask: torch.Tensor):
        """This rank's model slice answered on its own shard, docids
        globalized (ranked) or its local bitmap and counts
        (conjunctive)."""
        Q = qterms.shape[0]
        if Q % self.model_size:
            raise ValueError(f"a batch of {Q} queries does not split over "
                             f"{self.model_size} model ranks")
        ql = Q // self.model_size
        rows = slice(self.model * ql, (self.model + 1) * ql)
        img = DeviceIndex(image.blocks, image.term_slot, image.term_nblk,
                          image.term_skip, image.term_nx, image.term_ft,
                          num_docs=self.num_docs, F=self.F)
        out = query_step(img, qterms[rows], qmask[rows], k=self.k,
                         mode=self.mode, max_blocks=self.max_blocks,
                         decode_fn=self.decode_fn)
        if self.mode == "conjunctive":
            return out
        d, s = out
        return torch.where(d > 0, d + int(offset), torch.zeros_like(d)), s

    def fuse(self, out):
        """The collectives: counts summed (conjunctive), or the per-shard
        top-k gathered and re-selected (ranked)."""
        a, b = out
        dev = a.device
        if self.mode == "conjunctive":
            total = b.to(self.comm, copy=True)
            for ax in self.axes:
                dist.all_reduce(total, group=self.mesh.get_group(ax))
            return a, total.to(dev)
        gd, gs = a.to(self.comm), b.to(self.comm)
        for ax in reversed(self.axes):    # data, then pod: shard-major
            g = self.mesh.get_group(ax)
            gd, gs = _all_gather(gd, g), _all_gather(gs, g)
        ql, kk = a.shape
        gd = gd.reshape(-1, ql, kk).transpose(0, 1).reshape(ql, -1).to(dev)
        gs = gs.reshape(-1, ql, kk).transpose(0, 1).reshape(ql, -1).to(dev)
        top_s, pos = _top_k(gs, kk)
        return torch.gather(gd, 1, pos), top_s

    def __call__(self, image: DeviceIndex, offset: int,
                 qterms: torch.Tensor, qmask: torch.Tensor):
        return self.fuse(self.local(image, offset, qterms, qmask))

    def assemble(self, out, dst: int | None = None):
        """The whole batch's answer from every rank's :meth:`__call__`
        output: ``(docids, scores)`` (Q, k), or ``(matches (Q, S *
        num_docs), counts (Q,))`` in the reference's tiled layout.  Every
        rank of the mesh (which spans the process group) must call it; it
        returns the answer on every rank, or on rank ``dst`` only (None
        elsewhere)."""
        a, b = out
        dev = a.device
        is_bool = a.dtype == torch.bool
        ga = _all_gather((a.view(torch.uint8) if is_bool else a)
                         .to(self.comm))
        gb = _all_gather(b.to(self.comm))
        if dst is not None and dist.get_rank() != dst:
            return None
        if is_bool:
            ga = ga.view(torch.bool)
        ranks = self.mesh.mesh.reshape(self.num_shards, self.model_size)
        first = ranks[0].tolist()         # shard 0's rank of each slice
        if self.mode == "conjunctive":
            rows = [torch.cat([ga[r] for r in ranks[:, m].tolist()], dim=1)
                    for m in range(self.model_size)]
            return (torch.cat(rows).to(dev),
                    torch.cat([gb[r] for r in first]).to(dev))
        return (torch.cat([ga[r] for r in first]).to(dev),
                torch.cat([gb[r] for r in first]).to(dev))


def make_sharded_query_step(mesh, *, k: int = 10, max_blocks: int = 64,
                            num_docs: int = 1 << 20, F: int = 4,
                            decode_fn=None, mode: str = "ranked"
                            ) -> ShardedQueryStep:
    """The sharded query step for this rank of ``mesh`` (a
    ``DeviceMesh`` with a "model" axis and a "data" axis, and optionally a
    leading "pod" axis): see :class:`ShardedQueryStep`.

    ``num_docs`` is both the per-shard docid CAPACITY (accumulators are
    sized by it; every shard's local docids must fit) and the N the scorer
    weights idf with.  For exact global ranked statistics, rebase each
    shard's ``term_ft`` to the collection-wide document frequencies via
    :func:`~repro_torch.core.device_index.with_global_stats` — KEEPING each
    image's shard-local ``num_docs`` (``shard_doc_offsets`` prefix-sums it)
    — and pass the collection total as THIS function's ``num_docs``.
    Shard-local ``term_ft`` gives the standard document-partitioned idf
    approximation instead, not a merge-exact score.  ``decode_fn`` None
    takes the ``dvbyte_decode`` op (its CUDA kernel for an image on the
    card).
    """
    return ShardedQueryStep(mesh, k=k, max_blocks=max_blocks,
                            num_docs=num_docs, F=F, decode_fn=decode_fn,
                            mode=mode)


def sharded_query_plain(images: list[DeviceIndex], offsets, qterms, qmask,
                        *, k: int = 10, max_blocks: int = 64,
                        num_docs: int = 1 << 20, F: int = 4,
                        decode_fn=None, mode: str = "ranked"):
    """The sharded query step computed in one process: ``query_step`` on
    every shard in turn, then the same merge (ranked) or the tiled bitmap
    and summed counts (conjunctive) — what
    :meth:`ShardedQueryStep.assemble` returns for the same images, offsets
    and batch.  For tests and checks; the mesh path never calls it."""
    outs = []
    for im, off in zip(images, [int(o) for o in offsets]):
        img = DeviceIndex(im.blocks, im.term_slot, im.term_nblk,
                          im.term_skip, im.term_nx, im.term_ft,
                          num_docs=num_docs, F=F)
        a, b = query_step(img, qterms, qmask, k=k, mode=mode,
                          max_blocks=max_blocks, decode_fn=decode_fn)
        if mode != "conjunctive":
            a = torch.where(a > 0, a + off, torch.zeros_like(a))
        outs.append((a, b))
    if mode == "conjunctive":
        return (torch.cat([m for m, _ in outs], dim=1),
                sum(c for _, c in outs))
    gd = torch.cat([d for d, _ in outs], dim=1)
    top_s, pos = _top_k(torch.cat([s for _, s in outs], dim=1),
                        outs[0][0].shape[1])
    return torch.gather(gd, 1, pos), top_s


def sharded_input_specs(mesh, *, shard_blocks: int, B: int = 64,
                        vocab: int = 1 << 17, qbatch: int = 256,
                        qterms: int = 8, num_docs: int = 1 << 20):
    """Meta-tensor stand-ins of the stacked inputs (the reference's
    ``ShapeDtypeStruct`` s): blocks, the five per-term arrays, the offsets,
    the query terms and mask."""
    nshards = int(np.prod([_axis_size(mesh, a) for a in doc_axes(mesh)]))

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    per_term = meta((nshards * vocab,), torch.int32)
    return (meta((nshards * shard_blocks, B), torch.uint8),
            per_term, per_term, per_term, per_term, per_term,
            meta((nshards,), torch.int32),
            meta((qbatch, qterms), torch.int32),
            meta((qbatch, qterms), torch.bool))


# --------------------------------------------------------------------------
# host-level shard fan-out through the unified engine
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class _FleetCounts:
    """Fleet-wide ingest counters, published as ONE immutable snapshot so a
    pool-thread reader (ranked scoring mid-fan-out) always sees a mutually
    consistent (version, N, total_tokens) triple — three separate counter
    fields could be observed mid-update between stores."""

    version: int        # bumps per ingested/deleted document (cache key)
    num_docs: int       # docid HORIZON (includes tombstoned — round-robin
    #                     assignment arithmetic must never renumber)
    total_tokens: int   # LIVE token total (decremented at delete)
    deleted_docs: int = 0   # tombstoned fleet-wide (live N = num_docs - this)


class ShardedEngine:
    """Document-partitioned fan-out of per-shard query engines — a
    first-class Engine: exact, parallel, and freeze-coordinated.

    Documents are assigned round-robin; each shard runs a full
    ``repro_torch.engine.Engine`` (its planner may independently pick host,
    device, kernel, or tiered execution, and its device image refreshes
    incrementally — each shard owns a
    :class:`~repro_torch.engine.device_backend.ResidentImageManager`, so its
    frozen block array uploads once per shard freeze and batched fan-out
    queries reuse the per-shard resident images across flushes).  Queries
    fan out to every shard — on a thread pool, so fan-out wall-clock is
    the max over shards, not the sum — and results fuse:

      * boolean modes (conjunctive / phrase / proximity) — per-shard docid
        lists are globalized and concatenated (docid spaces are disjoint,
        no dedup needed);
      * ranked modes — per-shard top-k lists merge under the canonical tie
        order (higher score, then lower global docid).

    **Docid arithmetic** — round-robin assignment is pure arithmetic, no
    per-document maps: global docid ``g`` lives on shard ``(g-1) % S`` as
    local docid ``(g-1) // S + 1``; local ``l`` on shard ``s`` globalizes
    to ``(l-1)*S + s + 1``.  Globalization is one vectorized affine map and
    the engine carries O(1) routing state regardless of collection size.
    The map is strictly monotone per shard, so per-shard canonical tie
    order IS global canonical tie order — which is what makes the top-k
    merge exact at tied boundaries.

    **Exact global ranked statistics** — the fan-out maintains the
    collection-wide document frequencies, N, and total token count at
    ingest and hands every shard a :class:`~repro_torch.core.query.
    CollectionStats` provider (the same rebasing seam the device
    frozen+delta path uses).  Shards therefore weight postings with exactly
    the numbers a single-engine oracle over the full stream would use, and
    the merged top-k is byte-identical to that oracle (same doubles, same
    canonical tie order) — no shard-local IDF approximation remains.

    **Coordinated freezes** — per-shard static-tier lifecycles register
    with one :class:`~repro_torch.core.lifecycle.FreezeCoordinator`; at most
    ``max_in_flight`` background encodes run fleet-wide, and refused
    shards retry on any later fleet ingest (every queued shard is pumped
    per ingest — see the coordinator docstring) or via
    :meth:`drain_freezes`.

    **Serving integration** — ``version`` (bumps per ingested document) and
    ``lifecycle.epoch`` (composite tier epoch, bumps on any shard's swap)
    give ``serve.QueryService`` the same cache-key components a single
    engine exposes, so result caching and invalidation work unchanged.
    """

    def __init__(self, num_shards: int = 2, engine_factory=None,
                 max_in_flight: int = 1, parallel: bool = True,
                 **engine_kwargs):
        from ..engine import Engine
        from .lifecycle import FreezeCoordinator
        if engine_factory is None:
            def engine_factory():
                return Engine(**engine_kwargs)
        self.engines = [engine_factory() for _ in range(num_shards)]
        self.num_shards = len(self.engines)
        self._counts = _FleetCounts(0, 0, 0)            # published
        # term -> global DOCUMENT frequency
        self._ft: dict[bytes, int] = {}                 # gil_shared
        # per-shard global-f_t arrays aligned to each shard's term ids
        # (keyed by the identity of the engine's append-only vocab list),
        # value-updated incrementally at ingest and suffix-extended at read
        # time — a device-image refresh never re-walks the vocabulary
        self._gft_cache: dict[int, np.ndarray] = {}   # gil_shared
        # every shard scores with the fleet's collection-wide statistics
        for e in self.engines:
            e.stats_provider = self.collection_stats
        # fleet freeze scheduling: one coordinator owns every shard lifecycle
        self.coordinator = FreezeCoordinator(max_in_flight=max_in_flight)
        for e in self.engines:
            if getattr(e, "lifecycle", None) is not None:
                self.coordinator.register(e.lifecycle)
        self._pool = None
        if parallel and self.num_shards > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_shards,
                thread_name_prefix="shard-fanout")

    def close(self) -> None:
        """Release the fan-out thread pool and join in-flight freezes.
        Idempotent; the engine degrades to serial fan-out afterwards —
        transient fleets (benchmarks, resize/rebuild cycles) should close
        rather than leak ``num_shards`` worker threads until exit."""
        for e in self.engines:
            if getattr(e, "lifecycle", None) is not None:
                e.lifecycle.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "ShardedEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # collection statistics (the exactness seam)
    # ------------------------------------------------------------------

    def collection_stats(self):
        """Fleet-wide (N, avg doclen, f_t) — what every ranked scorer and
        device-image refresh rebases with.  ``avg`` is total tokens over N,
        which equals the oracle's ``doclens[1:N+1].mean()`` bit-for-bit
        (integer sums below 2**53 are exact in float64)."""
        from .query import CollectionStats
        c = self._counts
        live = c.num_docs - c.deleted_docs
        return CollectionStats(
            num_docs=live,
            avg_doclen=c.total_tokens / live if live else 0.0,
            ft=self._ft,
            fts_cache=self._gft_cache)

    @property
    def version(self) -> int:
        """Bumps per ingested document (serving cache-key component)."""
        return self._counts.version

    @property
    def num_docs(self) -> int:
        return self._counts.num_docs

    @property
    def deleted_docs(self) -> int:
        return self._counts.deleted_docs

    @property
    def num_postings(self) -> int:
        return sum(e.index.num_postings for e in self.engines)

    @property
    def lifecycle(self):
        """The fleet coordinator: exposes the composite ``epoch`` the
        serving cache keys on (duck-compatible with a single engine's
        ``FreezeManager`` for that purpose)."""
        return self.coordinator

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def add_document(self, terms) -> int:
        """Ingest one document (single front-door thread — queries and
        ingest are serialized by the caller, the same one-writer model as
        ``Engine``/``QueryService``; the fan-out pool is only ever busy
        INSIDE ``execute_many``, never concurrently with an ingest)."""
        c = self._counts
        g = c.num_docs + 1
        shard = (g - 1) % self.num_shards
        # global stats BEFORE the shard ingest, so the maybe_freeze hooks
        # that fire inside it already see statistics covering this doc
        tbs = [t.encode() if isinstance(t, str) else t for t in terms]
        # resolve each shard's materialized aligned-f_t array once per doc
        # (most fleets have none until a device query materializes them)
        live = [(e._tid, arr) for e in self.engines
                if (arr := self._gft_cache.get(id(e.vocab))) is not None]
        for tb in dict.fromkeys(tbs):
            df = self._ft.get(tb, 0) + 1
            self._ft[tb] = df
            # keep the materialized per-shard aligned f_t arrays current
            # (terms a shard interns later are picked up by the suffix
            # extension in CollectionStats.fts_for)
            for tid_map, arr in live:
                tid = tid_map.get(tb)
                if tid is not None and tid < len(arr):
                    arr[tid] = df
        self._counts = _FleetCounts(c.version + 1, g,
                                    c.total_tokens + len(terms),
                                    c.deleted_docs)
        local = self.engines[shard].add_document(terms)
        assert local == (g - 1) // self.num_shards + 1
        # a global ingest changes every shard's scoring state (N, f_t, avg
        # all moved): bump the non-owner versions too so their device
        # images re-rebase statistics on the next refresh
        for s, e in enumerate(self.engines):
            if s != shard:
                e.version += 1
        # pump deferred freezes fleet-wide: the fleet shares ONE writer
        # thread (this method), so a shard whose encode-slot request was
        # refused may retry on ANY ingest — not only its own — which keeps
        # the coordinator's FIFO live even if routing ever skews away from
        # the queue head
        if self.coordinator.pending:
            for s, e in enumerate(self.engines):
                if s != shard and getattr(e, "lifecycle", None) is not None:
                    e.lifecycle.maybe_freeze()
        return g

    @property
    def word_level(self) -> bool:
        return self.engines[0].index.word_level

    def route_batch(self, prepared):
        """Assign global docids round-robin and update the fleet-wide
        statistics for a whole batch of
        :class:`~repro_torch.core.prepare.PreparedDoc` records — WITHOUT
        touching any shard engine.  Returns ``(gids, per_shard, extra_bumps)``:

          * ``gids`` — the global docids, in submission order;
          * ``per_shard[s]`` — the sub-batch shard ``s`` owns, in local
            docid order (round-robin arithmetic: global ``g`` lands on
            shard ``(g-1) % S`` as local ``(g-1)//S + 1``);
          * ``extra_bumps[s]`` — the number of batch documents shard ``s``
            does NOT own.  A global ingest changes every shard's scoring
            state (N, f_t, avgdl all move), so each shard's version must
            advance by the FULL batch size: its own ingest bumps it by
            ``len(per_shard[s])``, and whoever applies the sub-batch adds
            ``extra_bumps[s]`` on top.  Splitting it this way keeps each
            shard engine's ``version`` written by exactly one thread in
            the pipelined path (its writer), never the router.

        This is the router half of the pipelined write path
        (``serve.ingest_pipeline``): it runs on the submitting thread —
        fleet counters and the global df map stay single-writer — while
        per-shard writer threads apply the returned sub-batches.  Global
        statistics are published BEFORE any shard ingest (one
        ``_FleetCounts`` store), so freeze hooks firing inside a shard's
        apply already see statistics covering the whole batch — the same
        order ``add_document`` uses.
        """
        c = self._counts
        S = self.num_shards
        base = c.num_docs
        gids = list(range(base + 1, base + len(prepared) + 1))
        per_shard: list[list] = [[] for _ in range(S)]
        df_delta: dict[bytes, int] = {}
        tokens = 0
        for i, p in enumerate(prepared):
            per_shard[(base + i) % S].append(p)
            tokens += p.doclen
            for tb in p.uniq:
                df_delta[tb] = df_delta.get(tb, 0) + 1
        live = [(e._tid, arr) for e in self.engines
                if (arr := self._gft_cache.get(id(e.vocab))) is not None]
        for tb, dd in df_delta.items():
            df = self._ft.get(tb, 0) + dd
            self._ft[tb] = df
            for tid_map, arr in live:
                tid = tid_map.get(tb)
                if tid is not None and tid < len(arr):
                    arr[tid] = df
        self._counts = _FleetCounts(c.version + len(prepared),
                                    base + len(prepared),
                                    c.total_tokens + tokens,
                                    c.deleted_docs)
        extra = [len(prepared) - len(per_shard[s]) for s in range(S)]
        return gids, per_shard, extra

    def add_documents(self, docs) -> list[int]:
        """Batched fleet ingest (synchronous: same single front-door
        thread model as ``add_document``; the pipelined variant lives in
        ``serve.ingest_pipeline``).  Answer-identical to a per-document
        loop — same global docids, same fleet statistics, same per-shard
        chains."""
        from .prepare import prepare_batch
        prepared = prepare_batch(docs, self.word_level)
        gids, per_shard, extra = self.route_batch(prepared)
        for s, e in enumerate(self.engines):
            if per_shard[s]:
                e.add_documents(per_shard[s])
            if extra[s]:
                e.version += extra[s]
        # pump deferred freezes fleet-wide (see add_document): every queued
        # shard may retry on any ingest
        if self.coordinator.pending:
            for e in self.engines:
                if getattr(e, "lifecycle", None) is not None:
                    e.lifecycle.maybe_freeze()
        return gids

    def delete_document(self, docid: int) -> None:
        """Tombstone one document fleet-wide (same single-writer model as
        ``add_document``).  The global docid routes to its owner shard by
        the round-robin arithmetic — no per-document map — and the owner's
        returned ``(tid, occurrences)`` pairs mirror the document-frequency
        decrements into the fleet's global ``_ft`` (and every materialized
        per-shard aligned f_t array), so every shard immediately scores
        with statistics of a collection that never held the document."""
        c = self._counts
        if not 1 <= docid <= c.num_docs:
            raise ValueError(f"docid {docid} out of range 1..{c.num_docs}")
        shard = (docid - 1) % self.num_shards
        local = (docid - 1) // self.num_shards + 1
        eng = self.engines[shard]
        doclen = eng._doclens[local]
        entry = eng.delete_document(local)  # raises on double delete
        live = [(e._tid, arr) for e in self.engines
                if (arr := self._gft_cache.get(id(e.vocab))) is not None]
        for tid, _occ in entry:
            tb = eng.vocab[tid]
            df = self._ft.get(tb, 0) - 1
            self._ft[tb] = df
            for tid_map, arr in live:
                t = tid_map.get(tb)
                if t is not None and t < len(arr):
                    arr[t] = df
        # horizon stays put (docid arithmetic is append-only); live token
        # total and the tombstone count move — published as ONE snapshot
        self._counts = _FleetCounts(c.version + 1, c.num_docs,
                                    c.total_tokens - doclen,
                                    c.deleted_docs + 1)
        # a delete changes every shard's scoring state (N, f_t, avg): bump
        # the non-owner versions so their device images re-rebase
        for s, e in enumerate(self.engines):
            if s != shard:
                e.version += 1

    def update_document(self, docid: int, terms) -> int:
        """Atomic-from-the-caller's-view revision: tombstone ``docid`` and
        ingest ``terms`` as a NEW document (new global docid, returned) —
        the same delete+add semantics as ``Engine.update_document``."""
        self.delete_document(docid)
        return self.add_document(terms)

    def collate_now(self) -> None:
        for e in self.engines:
            e.collate_now()

    def drain_freezes(self) -> None:
        """Run every due-or-deferred freeze to completion (tests, shutdown,
        bulk-load tails).  No ingest may run concurrently — this pumps the
        writer-thread side of deferred freezes that would otherwise wait
        for the next document.  Bails out (rather than spinning) if an
        epoch fails to advance — a crashed encode thread must not wedge
        shutdown."""
        mgrs = [e.lifecycle for e in self.engines
                if getattr(e, "lifecycle", None) is not None]
        while True:
            for m in mgrs:
                m.wait()
            before = [m.epoch for m in mgrs]
            if not any([m.maybe_freeze() for m in mgrs]):
                break
            for m in mgrs:
                m.wait()
            if [m.epoch for m in mgrs] == before:
                break
        for m in mgrs:
            m.wait()

    # ------------------------------------------------------------------
    # query fan-out
    # ------------------------------------------------------------------

    def execute(self, query):
        return self.execute_many([query])[0]

    def _globalize(self, shard: int, docids) -> np.ndarray:
        """Vectorized round-robin globalization: (l-1)*S + shard + 1."""
        local = np.asarray(docids, dtype=np.int64)
        return (local - 1) * self.num_shards + shard + 1

    def execute_many(self, queries):
        """Fan a batch out to every shard engine (in parallel) and fuse per
        query.  Each shard result's docids are globalized arithmetically;
        the fused ``backend`` reports the SET of backends that actually
        served the shards (e.g. ``"host+tiered"``)."""
        from ..engine.types import QueryResult
        if self._pool is not None:
            per_shard = list(self._pool.map(
                lambda e: e.execute_many(queries), self.engines))
        else:
            per_shard = [e.execute_many(queries) for e in self.engines]
        out = []
        for qi, q in enumerate(queries):
            shard_res = [per_shard[s][qi] for s in range(self.num_shards)]
            backend = "+".join(sorted({r.backend for r in shard_res}))
            reason = f"sharded fan-out x{self.num_shards}"
            gids = np.concatenate([self._globalize(s, r.docids)
                                   for s, r in enumerate(shard_res)])
            if q.mode in ("conjunctive", "phrase", "proximity"):
                out.append(QueryResult(np.sort(gids), None, backend, reason))
            else:
                scores = np.concatenate([r.scores for r in shard_res])
                # canonical ranked tie order across shards: higher score
                # first, then lower GLOBAL docid (not shard arrival order)
                order = np.lexsort((gids, -scores))[:q.k]
                out.append(QueryResult(gids[order], scores[order],
                                       backend, reason))
        return out

    # ------------------------------------------------------------------
    # persistence (core/persist.py)
    # ------------------------------------------------------------------

    def snapshot(self, root: str, *, keep: int = 3,
                 quiesce: bool = False) -> str:
        """Persist the whole fleet under ``root`` — per-shard engine state
        plus the fleet counters and global term statistics, all published
        by ONE atomic rename (shards can never restore torn against each
        other).  Writer thread only.  ``quiesce=True`` joins in-flight
        shard encodes first so every shard's newest tier is captured."""
        from . import persist
        if quiesce:
            for e in self.engines:
                if getattr(e, "lifecycle", None) is not None:
                    e.lifecycle.quiesce()
        return persist.save_sharded(self, root, keep=keep)

    @classmethod
    def restore(cls, path_or_root: str, *, parallel: bool = True,
                max_in_flight: int | None = None,
                **engine_kwargs) -> "ShardedEngine":
        """Rebuild a fleet from a snapshot dir (or the newest under a
        root); per-shard ``engine_kwargs`` forward runtime knobs."""
        from . import persist
        return persist.restore_sharded(path_or_root, parallel=parallel,
                                       max_in_flight=max_in_flight,
                                       **engine_kwargs)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def stats(self):
        """One composite :class:`~repro_torch.engine.types.EngineStats` for
        the fleet (summed counters, merged backend histogram, composite tier
        epoch).  Per-shard detail remains available as
        ``[e.stats() for e in engine.engines]``."""
        from ..engine.types import EngineStats
        agg = EngineStats()
        for e in self.engines:
            s = e.stats()
            agg.deleted_docs += s.deleted_docs
            agg.tombstones_compacted += s.tombstones_compacted
            agg.num_postings += s.num_postings
            agg.num_words += s.num_words
            agg.queries += s.queries
            agg.query_batches += s.query_batches
            agg.query_time_s += s.query_time_s
            agg.ingest_docs += s.ingest_docs
            agg.ingest_batches += s.ingest_batches
            agg.ingest_time_s += s.ingest_time_s
            agg.collations += s.collations
            agg.delta_refreshes += s.delta_refreshes
            agg.delta_compactions += s.delta_compactions
            agg.resident_uploads += s.resident_uploads
            agg.freezes += s.freezes
            for k, v in s.by_backend.items():
                agg.by_backend[k] = agg.by_backend.get(k, 0) + v
        agg.num_docs = self.num_docs
        agg.vocab_size = len(self._ft)
        agg.tier_epoch = self.coordinator.epoch
        agg.num_shards = self.num_shards
        return agg


__all__ = ["ShardedEngine"]
