"""The port's host core (``repro_torch.core``) against the JAX package's.

The same document stream goes through both packages' dynamic indexes; the
block store bytes, block counts, hash arrays and every decoded chain must be
equal, and so must the collated bytes.  Two import guards prove the port
stands alone: importing every ``repro_torch`` module leaves ``jax`` (and
``repro``) out of ``sys.modules``, and no port source imports either.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.collate import collate as jax_collate
from repro.core.index import DynamicIndex as JaxIndex
from repro_torch.core.collate import collate as port_collate
from repro_torch.core.index import DynamicIndex as PortIndex

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _stream(seed: int = 5, n: int = 240, V: int = 90):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(V)]
    probs = 1.0 / np.arange(1, V + 1) ** 1.07
    probs /= probs.sum()
    return [[vocab[i] for i in rng.choice(V, size=int(rng.integers(1, 40)),
                                          p=probs)] for _ in range(n)]


def _ingest(index, docs, batched: bool):
    if batched:
        for i in range(0, len(docs), 32):
            index.add_documents(docs[i:i + 32])
    else:
        for d in docs:
            index.add_document(d)
    return index


def _assert_same_index(a, b):
    B = a.store.B
    assert a.store.nblocks == b.store.nblocks
    nb = a.store.nblocks * B
    assert a.store.I[:nb].tobytes() == b.store.I[:nb].tobytes()
    assert np.array_equal(a.hash, b.hash)
    assert (a.num_docs, a.num_postings, a.num_words, a.vocab_size) == \
        (b.num_docs, b.num_postings, b.num_words, b.vocab_size)
    terms = sorted(t for t, _ in a.terms())
    assert terms == sorted(t for t, _ in b.terms())
    for t in terms:
        da, fa = a.postings(t)
        db, fb = b.postings(t)
        assert da.tolist() == db.tolist() and fa.tolist() == fb.tolist(), t


@pytest.mark.parametrize("batched", [False, True],
                         ids=["add_document", "add_documents"])
def test_same_stream_same_store(batched):
    docs = _stream()
    jax_idx = _ingest(JaxIndex(B=64, growth="const"), docs, batched)
    port_idx = _ingest(PortIndex(B=64, growth="const"), docs, batched)
    _assert_same_index(jax_idx, port_idx)


def test_collate_same_bytes():
    docs = _stream(seed=9)
    jax_idx = jax_collate(_ingest(JaxIndex(B=64, growth="const"), docs,
                                  False))
    port_idx = port_collate(_ingest(PortIndex(B=64, growth="const"), docs,
                                    False))
    _assert_same_index(jax_idx, port_idx)


def _port_modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(_port_modules())
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 20


_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:[.\s,]|$)",
                        re.M)


@pytest.mark.parametrize("path", sorted(p.relative_to(PORT).as_posix()
                                        for p in PORT.rglob("*.py")))
def test_port_source_imports_neither_jax_nor_repro(path):
    src = (PORT / path).read_text()
    assert not _FORBIDDEN.findall(src)
