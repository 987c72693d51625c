"""Serving entry point: immediate-access index ingest+query service (the paper's
workload) or LM decode with the Triangle-paged KV cache.

    python -m repro_torch.launch.serve --mode index [--docs N --queries Q]
    python -m repro_torch.launch.serve --mode lm [--steps N] [--device cpu]

``--mode index``: streams synthetic documents into a host
:class:`~repro_torch.core.index.DynamicIndex` while serving conjunctive +
ranked queries between ingest batches — the paper's interleaved operation
stream (§4.5/§4.6), reporting ingest and query latencies.  It runs on the
host, as the JAX package's does, and prints its two ``[serve-index]``
lines.

``--mode lm``: batched greedy token-by-token decode of the reduced
llama3.2-3b (``launch/train.py`` ``reduced_lm``) with the paged KV cache's
control plane (``serve/kv_cache.py``, Triangle page growth) beside a dense
(L, B, S, KV*d_head) cache, as the reference keeps it.  It runs on the card
unless ``--device`` says otherwise, and raises where there is none.

Ported from the JAX package's ``src/repro/launch/serve.py``; both functions
also return what they printed and computed, for callers and tests.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def serve_index(n_docs: int, n_queries: int) -> dict:
    """The reference's interleaved stream; returns its two printed lines
    (``lines``) and each query's terms and answer (``queries``,
    ``answers``: a conjunctive query's docids, a ranked query's (docids,
    scores))."""
    from ..core.index import DynamicIndex
    from ..core.query import conjunctive_query, ranked_disjunctive_taat
    from ..data.corpus import CorpusSpec, SyntheticCorpus

    corpus = SyntheticCorpus(CorpusSpec(n_docs=n_docs, words_per_doc=120,
                                        universe=50_000))
    idx = DynamicIndex(B=64, growth="const")
    rng = np.random.default_rng(0)
    seen_terms: list[str] = []
    q_lat, i_lat = [], []
    queries, answers = [], []
    qi = 0
    for d, doc in enumerate(corpus.doc_terms()):
        t0 = time.perf_counter()
        idx.add_document(doc)
        i_lat.append(time.perf_counter() - t0)
        if d < 50:
            seen_terms.extend(doc[:5])
        # interleave queries with ingest (immediate access)
        if d % 10 == 9 and seen_terms:
            terms = list(rng.choice(seen_terms,
                                    size=min(3, len(seen_terms))))
            t0 = time.perf_counter()
            if qi % 2 == 0:
                ans = conjunctive_query(idx, terms)
            else:
                ans = ranked_disjunctive_taat(idx, terms, k=10)
            q_lat.append(time.perf_counter() - t0)
            queries.append(terms)
            answers.append(ans)
            qi += 1
            if qi >= n_queries:
                break
    lines = [
        f"[serve-index] docs={idx.num_docs} postings={idx.num_postings} "
        f"bytes/posting={idx.bytes_per_posting():.3f}",
        f"[serve-index] ingest mean {np.mean(i_lat)*1e6:.1f}us/doc; "
        f"query mean {np.mean(q_lat)*1e3:.2f}ms "
        f"p95 {np.percentile(q_lat, 95)*1e3:.2f}ms over {qi} queries"]
    for line in lines:
        print(line)
    return {"lines": lines, "queries": queries, "answers": answers}


def serve_lm(steps: int = 32, *, cfg=None, model=None,
             device=None) -> dict:
    """Greedy decode of B = 2 sequences from token 0 for ``steps`` steps
    against an S = 128-position cache, with
    ``PagedKVCache(n_pages=256, page_tokens=16, policy="triangle")``
    claiming a token per sequence a step, as the reference does.

    The model is ``model`` (an :class:`~repro_torch.models.lm.LM`), or one
    of ``cfg`` (default: the reduced llama3.2-3b) drawn on ``device``
    (None means the card) from a generator seeded with 0.  Each
    step ends in a synchronize on a CUDA device, so ``step_s`` holds what
    each step took on the host's clock.  Returns the greedy ``tokens`` (B,
    steps), ``step_s``, the page ``overhead`` per sequence, the ``pool``,
    ``dropped`` (tokens an MoE dropped at capacity, summed over the steps
    and layers; None for a dense model), ``finite`` (every step's logits
    finite) and the printed ``line``.  ``steps`` must not exceed S (the
    reference's cache write would clamp at the last position)."""
    from ..configs import get_arch
    from ..core.device_index import resolve_device
    from ..models.lm import LM
    from ..serve import PagedKVCache
    from .train import reduced_lm

    if model is None:
        device = resolve_device(device)
        if cfg is None:
            cfg = reduced_lm(get_arch("llama3.2-3b").cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        model = LM(cfg, device=device, generator=gen)
    cfg, device = model.cfg, model.device
    B, S = 2, 128
    if steps > S:
        raise ValueError(f"{steps} steps do not fit a cache of {S}")
    pool = PagedKVCache(n_pages=256, page_tokens=16, policy="triangle")
    for b in range(B):
        pool.add_sequence(b)
    cache = model.new_cache(B, S)
    tok = torch.zeros(B, dtype=torch.int64, device=device)
    drops = [] if cfg.moe else None
    finite = torch.ones((), dtype=torch.bool, device=device)
    tokens, step_s = [], []
    t0 = time.perf_counter()
    for pos in range(steps):
        ts = time.perf_counter()
        for b in range(B):
            pool.append_tokens(b, 1)
        logits, cache = model.decode(cache, tok, pos, drops=drops)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)
        finite &= torch.isfinite(logits).all()
        tokens.append(tok)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - ts)
    dt = time.perf_counter() - t0
    ovh = [pool.overhead_tokens(b) for b in range(B)]
    line = (f"[serve-lm] {steps} decode steps x {B} seqs in {dt:.2f}s "
            f"({dt/steps*1e3:.1f} ms/step); page overhead/seq {ovh} tokens")
    print(line)
    return {"tokens": torch.stack(tokens, 1).cpu().numpy(),
            "step_s": step_s, "overhead": ovh, "pool": pool,
            "dropped": (None if drops is None
                        else int(torch.stack(drops).sum())),
            "finite": bool(finite), "line": line}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["index", "lm"], default="index")
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="--mode lm: the torch device (default the card)")
    args = ap.parse_args()
    if args.mode == "index":
        serve_index(args.docs, args.queries)
    else:
        serve_lm(args.steps, device=args.device)


if __name__ == "__main__":
    main()
