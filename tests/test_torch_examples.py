"""The port's three index examples against the JAX package's host core.

``examples/quickstart_torch.py``, ``examples/engine_quickstart_torch.py``
and ``examples/serve_stream_torch.py`` run with ``--device cpu`` at small
``--docs`` in subprocesses with timeouts; the counts they print
(documents, postings, hits per query, bytes per posting, top docids) are
held against the reference's host core (``repro.core``) on the same
stream.  The JAX examples themselves are not run.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.collate import collate
from repro.core.index import DynamicIndex
from repro.core.query import conjunctive_query, ranked_disjunctive_taat
from repro.core.static_index import StaticIndex
from repro.data.corpus import CorpusSpec, SyntheticCorpus

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def run_example(name: str, *args: str) -> str:
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], capture_output=True, text=True, timeout=TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def grab(pattern: str, text: str) -> tuple:
    m = re.search(pattern, text)
    assert m, f"{pattern!r} not in:\n{text}"
    return m.groups()


@pytest.mark.parametrize("docs", [400])
def test_quickstart_torch_prints_the_reference_counts(docs):
    out = run_example("quickstart_torch.py", "--docs", str(docs))
    corpus = SyntheticCorpus(CorpusSpec(n_docs=docs, words_per_doc=200,
                                        universe=2 * docs, seed=1))
    idx = DynamicIndex(B=64, growth="const")
    tri = DynamicIndex(B=64, growth="triangle")
    sample = []
    for i, doc in enumerate(corpus.doc_terms()):
        idx.add_document(doc)
        tri.add_document(doc)
        if i < 5:
            sample.extend(doc[:3])
        if i == docs // 2 - 1:
            mid = len(conjunctive_query(idx, sample[:2]))
    assert int(grab(r"\[mid-stream\] docs matching .*: (\d+)", out)[0]) \
        == mid
    assert grab(r"ingested (\d+) docs, (\d+) postings", out) == (
        str(idx.num_docs), str(idx.num_postings))
    assert grab(r"Const +index: ([\d.]+)", out)[0] \
        == f"{idx.bytes_per_posting():.3f}"
    assert grab(r"Triangle index: ([\d.]+)", out)[0] \
        == f"{tri.bytes_per_posting():.3f}"
    top, _ = ranked_disjunctive_taat(idx, sample[:3], k=5)
    assert grab(r"top-5 for .*: docs (\[.*\])", out)[0] == str(top.tolist())
    col = collate(idx)
    assert grab(r"collated: .*same ([\d.]+) B", out)[0] \
        == f"{col.bytes_per_posting():.3f}"
    assert int(grab(r"conjunctive hits (\d+) == host", out)[0]) == len(
        conjunctive_query(col, sample[:2]))
    frozen = StaticIndex.freeze(idx, "interp")
    assert grab(r"static \(interpolative\): ([\d.]+)", out)[0] \
        == f"{frozen.bytes_per_posting():.3f}"


@pytest.mark.parametrize("docs", [240])
def test_engine_quickstart_torch_prints_the_reference_counts(docs):
    out = run_example("engine_quickstart_torch.py", "--docs", str(docs))
    corpus = SyntheticCorpus(CorpusSpec(n_docs=docs, words_per_doc=120,
                                        universe=2 * docs, seed=4))
    stream = list(corpus.doc_terms())
    freeze_at = docs * 7 // 12
    idx = DynamicIndex(B=64, growth="const")
    for d in stream[:freeze_at]:
        idx.add_document(d)
    probe = stream[0][:2]
    assert int(grab(r"ingested (\d+) docs", out)[0]) == freeze_at
    top, _ = ranked_disjunctive_taat(idx, probe, k=5)
    for backend in ("host", "device", "kernel"):
        assert grab(rf"{backend} +top-5 docs (\[.*?\])", out)[0] \
            == str(top.tolist())
    for d in stream[freeze_at:]:
        idx.add_document(d)
    hits = conjunctive_query(idx, probe)
    assert grab(r"device conjunctive sees (\d+) docs, (\d+) of them", out) \
        == (str(len(hits)), str(int((hits > freeze_at).sum())))
    assert int(grab(r"served (\d+) queries interleaved with 200", out)[0]) \
        == len(range(0, 200, 3))
    assert int(grab(r"EngineStats\(num_docs=(\d+)", out)[0]) == docs + 200


@pytest.mark.parametrize("docs,budget_mb", [(800, 0.2)])
def test_serve_stream_torch_prints_the_reference_counts(docs, budget_mb):
    out = run_example("serve_stream_torch.py", "--docs", str(docs),
                      "--shard-budget-mb", str(budget_mb))
    corpus = SyntheticCorpus(CorpusSpec(n_docs=docs, words_per_doc=150,
                                        universe=max(3000, docs), seed=2))
    dynamic = DynamicIndex(B=64)
    seen, shards, n_queries = [], [], 0
    for n, doc in enumerate(corpus.doc_terms(), start=1):
        dynamic.add_document(doc)
        if n <= 40:
            seen.extend(doc[:4])
        n_queries += n % 9 == 0
        if dynamic.total_bytes() > budget_mb * 2**20:
            dynamic = collate(dynamic)
            frozen = StaticIndex.freeze(dynamic, "bp128")
            shards.append((frozen.num_postings,
                           f"{frozen.bytes_per_posting():.2f}",
                           f"{dynamic.bytes_per_posting():.2f}",
                           len(conjunctive_query(dynamic, seen[:2]))))
            dynamic = DynamicIndex(B=64)
    got = re.findall(r"\[rollover\] froze shard \d+: (\d+) postings at "
                     r"([\d.]+) B/p \(dynamic was ([\d.]+)\); device image "
                     r"\d+ blocks on cpu, (\d+) hits", out)
    assert len(shards) >= 2
    assert [(int(p), a, b, int(h)) for p, a, b, h in got] == shards
    assert grab(r"\[end\] dynamic shard of (\d+) docs: .* (\d+) hits", out) \
        == (str(dynamic.num_docs),
            str(len(conjunctive_query(dynamic, seen[:2]))))
    assert grab(r"(\d+) docs through (\d+) static shards \+ 1 dynamic "
                r"shard; (\d+) queries", out) == (
        str(docs), str(len(shards)), str(n_queries))
    assert np.isfinite(float(grab(r"query : mean ([\d.]+) ms", out)[0]))
