"""Hybrid retrieval on the PyTorch/CUDA port: the paper's index as candidate
generator for the two-tower model (``examples/hybrid_retrieval.py`` on the
port).

    PYTHONPATH=src python examples/hybrid_retrieval_torch.py               # the card
    PYTHONPATH=src python examples/hybrid_retrieval_torch.py --device cpu

Stage 1 (lexical): conjunctive Boolean over the immediate-access dynamic
index produces a candidate set for the query terms.
Stage 2 (dense):  the two-tower model embeds the query profile and scores
the candidates with the retrieval_dot op (the CUDA kernel on the card, its
plain version on the CPU).
Documents keep arriving between queries — stage 1 always sees them.

The candidate counts depend only on the corpus and the index, so they equal
the JAX example's; the weights are a seeded random init drawn by torch, so
the dense top 5 differ from it.
"""

import argparse

import numpy as np
import torch

from repro_torch.core.index import DynamicIndex
from repro_torch.core.query import conjunctive_query
from repro_torch.data.corpus import CorpusSpec, SyntheticCorpus
from repro_torch.kernels.retrieval_dot.ops import candidate_scores
from repro_torch.models.recsys import TwoTower, TwoTowerConfig

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card; 'cpu' runs the "
                     "plain versions)")
device = ap.parse_args().device

# --- corpus + lexical index ------------------------------------------------
corpus = SyntheticCorpus(CorpusSpec(n_docs=1500, words_per_doc=120,
                                    universe=3_000, seed=3))
idx = DynamicIndex(B=64)
docs = []
for doc in corpus.doc_terms():
    idx.add_document(doc)
    docs.append(doc)

# --- dense side: tiny two-tower with per-document item embeddings ----------
# (docids added after this point pass n_items: the lookup clamps them to the
# last row, as the JAX example's gather does)
cfg = TwoTowerConfig(n_users_vocab=4096, n_items=len(docs) + 1,
                     embed_dim=32, tower_mlp=(64, 32), n_user_feats=4)
model = TwoTower(cfg, device=device)
dev = model.device

with torch.inference_mode():
    # a user profile (hashed feature ids)
    user = {"user_feats": torch.tensor([[11, 99, 1033, 7]], device=dev),
            "user_mask": torch.ones((1, 4), device=dev)}
    u = model.user_embedding(user)                           # (1, 32)

    query_terms = [docs[10][0], docs[10][1]]
    for round_ in range(3):
        # stage 1: lexical candidates (immediate access — includes docs
        # ingested since the previous round)
        cand_docs = conjunctive_query(idx, query_terms)
        if len(cand_docs) == 0:
            print("no lexical candidates")
            break
        # stage 2: dense scoring of candidates
        cand_emb = model.item_embedding(
            torch.from_numpy(np.asarray(cand_docs, np.int64)).to(dev))
        scores = candidate_scores(u, cand_emb)[0]
        order = torch.sort(scores, descending=True,
                           stable=True).indices[:5].cpu().numpy()
        print(f"[round {round_}] {len(cand_docs)} lexical candidates for "
              f"{query_terms}; top-5 dense: "
              f"{np.asarray(cand_docs)[order].tolist()}")
        # documents keep arriving between queries
        newdoc = [query_terms[0], query_terms[1], "freshdoc"] + docs[round_]
        idx.add_document(newdoc)
        docs.append(newdoc)

print(f"hybrid retrieval on {dev}: lexical recall + dense precision, one "
      f"live index")
