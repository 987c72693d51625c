"""Unified query engine quickstart on the PyTorch/CUDA port: one API over
three backends (``examples/engine_quickstart.py`` on the port).

    PYTHONPATH=src python examples/engine_quickstart_torch.py               # the card
    PYTHONPATH=src python examples/engine_quickstart_torch.py --device cpu

Demonstrates the engine lifecycle end to end:

  1. ingest through the Engine (doclens/vocab/f_t tracked for you);
  2. query mid-stream on every backend — host cursors, the device images
     (the fused kernel on the card), and the kernel backend — and watch
     the planner route;
  3. collate once (the freeze), keep ingesting, and query the device
     backend again: the frozen image plus the incremental delta answer
     for documents the device has never been collated over;
  4. serve an interleaved ingest/query stream through QueryService.

On the CPU (``--device cpu``) the device and kernel backends run the
kernels' plain versions.  The counts depend only on the corpus, so they
equal the JAX example's at the same ``--docs``.
"""

import argparse

import numpy as np

from repro_torch.core.collate import collation_stats
from repro_torch.data.corpus import CorpusSpec, SyntheticCorpus
from repro_torch.engine import Engine, Query
from repro_torch.serve import QueryService

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--docs", type=int, default=1200,
                help="documents in the stream (the JAX example's 1,200); "
                     "the freeze comes after 7/12 of them")
ap.add_argument("--device", default=None,
                help="torch device (default: the card; 'cpu' runs the "
                     "plain versions)")
args = ap.parse_args()

corpus = SyntheticCorpus(CorpusSpec(n_docs=args.docs, words_per_doc=120,
                                    universe=2 * args.docs, seed=4))
docs = list(corpus.doc_terms())
freeze_at = args.docs * 7 // 12

# (pass auto_collate_delta_frac=0.5 to bound the delta by re-freezing
#  automatically; left off here so step 3 shows a single explicit freeze)
eng = Engine(B=64, growth="const", device=args.device)
for d in docs[:freeze_at]:
    eng.add_document(d)

sample = [t for t in docs[0][:4]]
print(f"ingested {eng.index.num_docs} docs; probe terms: {sample[:2]}")

# -- 2: same query, every backend -----------------------------------------
q = Query(terms=tuple(sample[:2]), mode="ranked_tfidf", k=5)
for backend in ("host", "device", "kernel"):
    r = eng.execute(Query(terms=q.terms, mode=q.mode, k=q.k,
                          backend=backend))
    print(f"  {backend:7s} top-5 docs {r.docids.tolist()} "
          f"scores {np.round(r.scores, 3).tolist()}")

auto = eng.execute_many([q] * 8)[0]
print(f"planner routed a batch of 8 to: {auto.backend} ({auto.reason})")

# -- 3: freeze once, keep ingesting, device stays current -----------------
eng.collate_now()
print(f"\ncollated (freeze): frag now "
      f"{collation_stats(eng.index)['frag_ratio']:.3f}")
for d in docs[freeze_at:]:
    eng.add_document(d)
r = eng.execute(Query(terms=q.terms, mode="conjunctive", backend="device"))
post_freeze = int((r.docids > freeze_at).sum())
print(f"device conjunctive sees {len(r.docids)} docs, {post_freeze} of them "
      f"ingested after the freeze — no re-collation "
      f"(collations={eng.stats().collations}, "
      f"delta_refreshes={eng.stats().delta_refreshes})")

# -- 4: serving loop -------------------------------------------------------
svc = QueryService(eng, max_batch=8)
ops = []
for i, d in enumerate(SyntheticCorpus(CorpusSpec(
        n_docs=200, words_per_doc=120, universe=2 * args.docs,
        seed=5)).doc_terms()):
    ops.append(("doc", d))
    if i % 3 == 0:
        ops.append(("query", Query(terms=tuple(sample[:2]),
                                   mode="bm25", k=3)))
tickets = svc.run_stream(ops)
print(f"\nserved {len(tickets)} queries interleaved with 200 ingests: "
      f"{svc.latency_summary()}")
print(f"final stats: {eng.stats()}")
