"""Quickstart on the PyTorch/CUDA port: the paper's object lifecycle
(``examples/quickstart.py`` on the port).

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds an immediate-access dynamic index over a synthetic docstream,
queries it while ingesting, collates it (§5.5), uploads the collated index
as a device image and answers a conjunctive query there (the
``dvbyte_decode`` kernel on the card, its plain version on the CPU),
freezes it to a static compressed index (§3.1), and prints the size story
(Tables 8/9/13).  The counts depend only on the corpus, so they equal the
JAX example's at the same ``--docs``.

This walks the paper's raw structures; for the planner-driven multi-backend
query path (host / device / kernel, incremental device-image refresh) see
examples/engine_quickstart_torch.py.
"""

import argparse

import torch

from repro_torch.core.collate import collate
from repro_torch.core.device_index import build_device_image, query_step
from repro_torch.core.index import DynamicIndex
from repro_torch.core.query import conjunctive_query, ranked_disjunctive_taat
from repro_torch.core.static_index import StaticIndex
from repro_torch.data.corpus import CorpusSpec, SyntheticCorpus

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--docs", type=int, default=2000,
                help="documents in the stream (the JAX example's 2,000)")
ap.add_argument("--device", default=None,
                help="torch device of the device image (default: the card)")
args = ap.parse_args()

# universe scales with the collection so postings/term matches real corpora
corpus = SyntheticCorpus(CorpusSpec(n_docs=args.docs, words_per_doc=200,
                                    universe=2 * args.docs, seed=1))

idx = DynamicIndex(B=64, growth="const")          # the paper's §3 structure
tri = DynamicIndex(B=64, growth="triangle")       # the paper's §5.4 lists

sample_terms = []
for i, doc in enumerate(corpus.doc_terms()):
    idx.add_document(doc)
    tri.add_document(doc)
    if i < 5:
        sample_terms.extend(doc[:3])
    if i == args.docs // 2 - 1:  # immediate access: query mid-stream
        hits = conjunctive_query(idx, sample_terms[:2])
        print(f"[mid-stream] docs matching {sample_terms[:2]}: {len(hits)}")

print(f"\ningested {idx.num_docs} docs, {idx.num_postings} postings")
print(f"Const    index: {idx.bytes_per_posting():.3f} bytes/posting")
print(f"Triangle index: {tri.bytes_per_posting():.3f} bytes/posting")

top_d, top_s = ranked_disjunctive_taat(idx, sample_terms[:3], k=5)
print(f"top-5 for {sample_terms[:3]}: docs {top_d.tolist()}")

col = collate(idx)                                # §5.5
host_hits = conjunctive_query(col, sample_terms[:2])
assert (host_hits == conjunctive_query(idx, sample_terms[:2])).all()
print(f"collated: chains now contiguous "
      f"(same {col.bytes_per_posting():.3f} B/posting)")

img = build_device_image(col, [t.encode() for t in sample_terms[:2]],
                         device=args.device)
matches, _ = query_step(img, torch.tensor([[0, 1]]),
                        torch.tensor([[True, True]]), mode="conjunctive",
                        max_blocks=int(img.term_nblk.max()))
dev_hits = torch.nonzero(matches[0]).flatten().cpu() + 1
assert dev_hits.tolist() == host_hits.tolist()
print(f"device image: {img.blocks.shape[0]} blocks on {img.device}; "
      f"conjunctive hits {len(dev_hits)} == host: verified")

frozen = StaticIndex.freeze(idx, "interp")        # §3.1 static conversion
print(f"static (interpolative): {frozen.bytes_per_posting():.3f} B/posting")
d1, _ = idx.postings(sample_terms[0])
d2, _ = frozen.postings(sample_terms[0])
assert (d1 == d2).all()
print("static == dynamic postings: verified")
