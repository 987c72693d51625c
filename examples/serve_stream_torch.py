"""End-to-end serving driver on the PyTorch/CUDA port (the paper's
operational mode, Figure 2; ``examples/serve_stream.py`` on the port).

    PYTHONPATH=src python examples/serve_stream_torch.py [--docs 4000]
    PYTHONPATH=src python examples/serve_stream_torch.py --device cpu

A mixed operation stream: documents are ingested continuously; conjunctive
and ranked queries arrive interleaved and must see every previously-ingested
document (immediate access).  When the dynamic shard reaches its memory
budget it is collated, frozen to a static shard, and a fresh dynamic shard
takes over — queries then fan out to both and results fuse, exactly the
lifecycle of §3.1.  Reports ingest/query latency and shard sizes.

At each rollover, and at the end for the dynamic shard, the collated
shard is also uploaded as a device image (the card by default) and one
conjunctive query of the stream's terms is answered there and held
against the host.  The counts depend only on the
corpus, so they equal the JAX example's at the same ``--docs``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.collate import collate
from repro_torch.core.device_index import build_device_image, query_step
from repro_torch.core.index import DynamicIndex
from repro_torch.core.query import conjunctive_query, ranked_disjunctive_taat
from repro_torch.core.static_index import StaticIndex
from repro_torch.data.corpus import CorpusSpec, SyntheticCorpus


def device_check(shard: DynamicIndex, terms: list[str], device) -> str:
    """One conjunctive query over ``shard`` (collated) on a device image,
    held against the host's answer."""
    img = build_device_image(shard, [t.encode() for t in terms],
                             device=device)
    n = len(terms)
    matches, _ = query_step(img, torch.arange(n)[None, :],
                            torch.ones((1, n), dtype=torch.bool),
                            mode="conjunctive",
                            max_blocks=max(1, int(img.term_nblk.max())))
    got = (torch.nonzero(matches[0]).flatten().cpu() + 1).tolist()
    if got != conjunctive_query(shard, terms).tolist():
        raise AssertionError(f"device conjunctive {terms}: {got[:10]}")
    return (f"device image {img.blocks.shape[0]} blocks on {img.device}, "
            f"{len(got)} hits for {terms} == host")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=4000)
    ap.add_argument("--shard-budget-mb", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the rollover's device image "
                         "(default: the card)")
    args = ap.parse_args()

    corpus = SyntheticCorpus(CorpusSpec(n_docs=args.docs, words_per_doc=150,
                                        universe=max(3000, args.docs), seed=2))
    rng = np.random.default_rng(0)

    static_shards: list[tuple[StaticIndex, int]] = []  # (shard, doc offset)
    dynamic = DynamicIndex(B=64)
    doc_base = 0
    seen_terms: list[str] = []
    i_lat, q_lat = [], []
    n_queries = 0

    def run_query(terms, ranked):
        """Fan out to the dynamic shard + all static shards; fuse."""
        results = []
        t0 = time.perf_counter()
        if ranked:
            d, s = ranked_disjunctive_taat(dynamic, terms, k=10)
            results.extend(zip(s.tolist(), (d + doc_base).tolist()))
            for shard, base in static_shards:
                N = shard.num_postings  # IDF base differs per shard: ok
                acc = {}
                for t in terms:
                    dd, ff = shard.postings(t)
                    for di, fi in zip(dd, ff):
                        w = np.log1p(fi)
                        acc[di + base] = acc.get(di + base, 0.0) + w
                results.extend((v, k) for k, v in acc.items())
            results.sort(reverse=True)
            out = results[:10]
        else:
            hits = list((conjunctive_query(dynamic, terms)
                         + doc_base).tolist())
            for shard, base in static_shards:
                sets = [set((shard.postings(t)[0] + base).tolist())
                        for t in terms]
                if sets:
                    hits.extend(sorted(set.intersection(*sets)))
            out = hits
        q_lat.append(time.perf_counter() - t0)
        return out

    for n, doc in enumerate(corpus.doc_terms(), start=1):
        t0 = time.perf_counter()
        dynamic.add_document(doc)
        i_lat.append(time.perf_counter() - t0)
        if n <= 40:
            seen_terms.extend(doc[:4])
        if n % 9 == 0 and seen_terms:
            terms = list(rng.choice(seen_terms, size=2, replace=False))
            run_query(terms, ranked=(n % 18 == 0))
            n_queries += 1
        # shard rollover at the memory budget (Figure 2's lifecycle)
        if dynamic.total_bytes() > args.shard_budget_mb * 2**20:
            dynamic = collate(dynamic)  # locality for the freeze pass
            frozen = StaticIndex.freeze(dynamic, "bp128")
            static_shards.append((frozen, doc_base))
            doc_base += dynamic.num_docs
            print(f"[rollover] froze shard {len(static_shards)}: "
                  f"{frozen.num_postings} postings at "
                  f"{frozen.bytes_per_posting():.2f} B/p "
                  f"(dynamic was {dynamic.bytes_per_posting():.2f}); "
                  + device_check(dynamic, seen_terms[:2], args.device))
            dynamic = DynamicIndex(B=64)

    print(f"[end] dynamic shard of {dynamic.num_docs} docs: "
          + device_check(collate(dynamic), seen_terms[:2], args.device))
    print(f"\n{args.docs} docs through {len(static_shards)} static shards + "
          f"1 dynamic shard; {n_queries} queries interleaved")
    print(f"ingest: mean {np.mean(i_lat)*1e6:.1f} us/doc")
    print(f"query : mean {np.mean(q_lat)*1e3:.2f} ms  "
          f"p95 {np.percentile(q_lat, 95)*1e3:.2f} ms")


if __name__ == "__main__":
    main()
