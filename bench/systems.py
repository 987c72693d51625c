"""The systems a run can drive: the program under test, or the control.

Both take the same calls from the window's loop: ``load`` and ``freeze``
at set-up, ``serve`` to open the service, then ``ingest``, ``delete`` and
``answer`` (one batch of queries, one ``(docids, scores, backend)`` per
query).  :class:`Program` is the PyTorch and CUDA port, the only code of
the benchmark that imports it; :class:`Control` is the plain reference put
in the program's place, computed in a lower precision.
"""

from __future__ import annotations

import dataclasses

import torch

from .reference.index import Collection, View


class Program:
    """``repro_torch``'s ``Engine`` (one shard) or ``ShardedEngine`` behind
    a ``QueryService``, on ``device``."""

    def __init__(self, cfg: dict, names: list[str], device: str):
        from repro_torch.core.sharded_index import ShardedEngine
        from repro_torch.engine import Engine
        from repro_torch.kernels import build
        #: whether this run builds the kernel (a checkout's first run)
        self.compiles = (device.startswith("cuda") and
                         not build.library_path("fused_query").exists())
        kw = dict(cfg["engine"], device=device)
        shards = int(cfg["shards"])
        self.sharded = shards > 1
        self.engine = (ShardedEngine(num_shards=shards, **kw)
                       if self.sharded else Engine(**kw))
        self.cfg = cfg
        self.names = names
        self.svc = None
        self.ndocs = 0

    def _strings(self, docs):
        names = self.names
        return [[names[i] for i in d.tolist()] for d in docs]

    def _expect(self, dids, n: int) -> None:
        want = list(range(self.ndocs + 1, self.ndocs + n + 1))
        if list(dids) != want:
            raise RuntimeError("the program assigned docids out of order")
        self.ndocs += n

    def load(self, docs, chunk: int) -> None:
        """Bulk load at set-up, before the service opens."""
        for i in range(0, len(docs), chunk):
            part = docs[i:i + chunk]
            self._expect(self.engine.add_documents(self._strings(part)),
                         len(part))

    def freeze(self) -> None:
        self.engine.collate_now()

    def serve(self, mix: dict) -> None:
        from repro_torch.serve import QueryService
        s = mix["service"]
        self.svc = QueryService(self.engine, max_batch=int(s["max_batch"]),
                                cache_size=int(s["cache_size"]),
                                pipelined=bool(self.cfg["pipelined"]))

    def queries(self, pool) -> list:
        from repro_torch.engine import Query
        names = self.names
        return [Query(terms=tuple(names[t] for t in ts), mode=m, k=pool.k)
                for ts, m in zip(pool.terms, pool.modes)]

    def ingest(self, docs) -> None:
        self._expect(self.svc.ingest_batch(self._strings(docs)), len(docs))

    def delete(self, docid: int) -> None:
        self.svc.delete(docid)

    def answer(self, queries: list) -> list:
        tickets = [self.svc.submit(q) for q in queries]
        self.svc.flush()
        out = []
        for t in tickets:
            r = t.result
            out.append(None if r is None else (r.docids, r.scores, r.backend))
        return out

    def engines(self) -> list:
        return list(self.engine.engines) if self.sharded else [self.engine]

    def footprint(self) -> dict:
        """Bytes and postings at the window's end: the host dynamic
        indexes' ``total_bytes()`` (vocabulary hash included) and every
        distinct device storage the resident (frozen, delta) images hold."""
        host = image = postings = 0
        seen: set[int] = set()
        for e in self.engines():
            host += e.index.total_bytes()
            postings += e.index.num_postings
            for img in e.resident.images:
                if img is None:
                    continue
                for f in dataclasses.fields(img):
                    t = getattr(img, f.name)
                    if isinstance(t, torch.Tensor):
                        st = t.untyped_storage()
                        if st.data_ptr() not in seen:
                            seen.add(st.data_ptr())
                            image += st.nbytes()
        return {"host_bytes": host, "image_bytes": image,
                "postings": postings}

    def counters(self) -> dict:
        """Program counters summed over the shards."""
        out = {"delta_refreshes": 0, "batches_served": 0,
               "resident_uploads": 0, "delta_compactions": 0}
        for e in self.engines():
            s = e.stats()
            out["delta_refreshes"] += s.delta_refreshes
            out["resident_uploads"] += s.resident_uploads
            out["delta_compactions"] += s.delta_compactions
            out["batches_served"] += e.resident.batches_served
        return out

    def close(self) -> None:
        if self.svc is not None:
            self.svc.close()
            self.svc = None
        if self.sharded:
            self.engine.close()
        self.engine = None


class Control:
    """The reference in the program's place: each batch answered by
    :class:`~bench.reference.index.View` in ``dtype``, from every document
    ingested and every delete made before it."""

    def __init__(self, cfg: dict, tr, dtype=torch.bfloat16):
        self.scoring = cfg["scoring"]
        self.universe = int(cfg["collection"]["universe"])
        self.tr = tr
        self.coll = None
        self.dtype = dtype
        self.horizon = 0
        self.dead: list[int] = []

    def _collection(self) -> Collection:
        """Every document offered so far (the window draws its arrivals
        as it needs them)."""
        docs = self.tr.resident + self.tr.arrivals.docs
        if self.coll is None or self.coll.num_docs < len(docs):
            self.coll = Collection(docs, self.universe)
        return self.coll

    def load(self, docs, chunk: int) -> None:
        self.horizon += len(docs)

    def freeze(self) -> None:
        pass

    def serve(self, mix: dict) -> None:
        pass

    def queries(self, pool) -> list:
        return [(ts, m, pool.k) for ts, m in zip(pool.terms, pool.modes)]

    def ingest(self, docs) -> None:
        self.horizon += len(docs)

    def delete(self, docid: int) -> None:
        self.dead.append(docid)

    def answer(self, queries: list) -> list:
        view = View(self._collection(), self.horizon, self.dead)
        out = []
        for ts, mode, k in queries:
            if mode == "conjunctive":
                out.append((view.conjunctive(ts), None, "control"))
            else:
                d, s = view.top_k(ts, mode, k, self.scoring, self.dtype)
                out.append((d, s, "control"))
        return out

    def footprint(self) -> dict:
        return {}

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        pass

