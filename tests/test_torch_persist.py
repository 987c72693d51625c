"""The port's engine snapshots (``repro_torch.core.persist``) against the
JAX package's.

The format is the reference's, file for file: the same stream snapshotted
by both packages writes the same manifest and the same artifact CRCs, a
snapshot written by either package restores in the other, and in both
directions the restored engine answers every mode with the docids and
score bits of the engine that was never restarted.  The crash points,
retention and corruption checks behave as the reference's.  A restored
port engine rebuilds its append-only per-term counts from the restored
chains and its device images from the restored index, so after deletes
its device answers equal its host answers (the regression for the
reference's fault C1 across a restore).  Fleet snapshots
(``ShardedEngine.snapshot``/``restore``) write the same manifest and files
in both packages, cross between them both ways, and restore to the answers
of the fleet that was never restarted, on the host path and, with
``device="cpu"``, on the device path.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst

from repro.core import persist as jax_persist
from repro.core.lifecycle import FreezePolicy as JaxPolicy
from repro.core.sharded_index import ShardedEngine as JaxFleet
from repro.engine import Engine as JaxEngine
from repro.engine import Query as JaxQuery
from repro_torch.core import persist
from repro_torch.core.lifecycle import FreezePolicy
from repro_torch.core.sharded_index import ShardedEngine
from repro_torch.engine import Engine, Query

VOCAB = [f"w{i}" for i in range(120)]
PROPERTY = settings(derandomize=True, database=None, max_examples=10,
                    deadline=None)


def make_docs(n, seed=5):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    probs /= probs.sum()
    return [[VOCAB[i] for i in rng.choice(len(VOCAB),
                                          size=int(rng.integers(4, 30)),
                                          p=probs)] for _ in range(n)]


def probes(word_level):
    qs = [("conjunctive", ("w0",), None), ("conjunctive", ("w0", "w2"), None),
          ("ranked_tfidf", ("w1", "w3"), None), ("bm25", ("w0", "w4"), None),
          ("bm25", ("w5", "w1", "w9"), None)]
    if word_level:
        qs += [("phrase", ("w0", "w1"), None),
               ("proximity", ("w0", "w2"), 6),
               ("bm25_prox", ("w1", "w2"), None)]
    return qs


def results_of(eng, word_level, backend=None):
    """Raw bytes of every probe's docids and scores: tobytes() equality
    pins dtype, order and tie-breaking."""
    q_cls = JaxQuery if isinstance(eng, JaxEngine) else Query
    out = []
    for mode, terms, window in probes(word_level):
        r = eng.execute(q_cls(terms=terms, mode=mode, k=15, window=window,
                              backend=backend))
        out.append((r.docids.tobytes(),
                    None if r.scores is None else r.scores.tobytes()))
    return out


def port_engine(word_level=False, codec="bp128", n_docs=90, tier=True,
                deletes=(), **kw):
    policy = FreezePolicy(codec=codec, background=False) if tier else None
    eng = Engine(B=64, word_level=word_level, tier_policy=policy,
                 device="cpu", **kw)
    _feed(eng, n_docs, deletes)
    return eng


def jax_engine(word_level=False, codec="bp128", n_docs=90, deletes=()):
    eng = JaxEngine(B=64, word_level=word_level,
                    tier_policy=JaxPolicy(codec=codec, background=False))
    _feed(eng, n_docs, deletes)
    return eng


def _feed(eng, n_docs, deletes):
    docs = make_docs(n_docs)
    half = n_docs // 2
    eng.add_documents(docs[:half])
    if eng.lifecycle is not None:
        eng.lifecycle.freeze(blocking=True)
    for d in docs[half:]:
        eng.add_document(d)
    for d in deletes:
        eng.delete_document(d)


GRID = [(w, c) for w in (False, True) for c in ("bp128", "interp")]
GRID_IDS = [f"{'word' if w else 'doc'}-{c}" for w, c in GRID]


# --------------------------------------------------------------------------
# round trips, within the port and across the packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("word_level,codec", GRID, ids=GRID_IDS)
def test_round_trip_all_modes(tmp_path, word_level, codec):
    eng = port_engine(word_level, codec, deletes=(7, 60))
    eng.snapshot(str(tmp_path))
    restored = Engine.restore(str(tmp_path), device="cpu")
    assert restored.index.num_docs == eng.index.num_docs
    assert restored.lifecycle.epoch == eng.lifecycle.epoch == 1
    assert restored._appended_fts == eng._appended_fts
    assert restored._fts == eng._fts
    assert results_of(eng, word_level) == results_of(restored, word_level)
    for e in (eng, restored):               # live, not a read-only replica
        e.add_document(["w0", "w99", "w0"])
    assert results_of(eng, word_level) == results_of(restored, word_level)


@pytest.mark.parametrize("word_level,codec", GRID, ids=GRID_IDS)
def test_same_stream_same_snapshot_files(tmp_path, word_level, codec):
    """Both packages write the same manifest and the same artifacts."""
    snaps = []
    for name, eng in (("jax", jax_engine(word_level, codec, deletes=(3,))),
                      ("port", port_engine(word_level, codec, deletes=(3,)))):
        snaps.append(eng.snapshot(str(tmp_path / name)))
    mans = [json.load(open(os.path.join(s, persist.MANIFEST)))
            for s in snaps]
    for man in mans:            # the encode's wall time, the one clock
        assert man["tier"].pop("encode_s") > 0
    assert mans[0] == mans[1]
    assert sorted(os.listdir(snaps[0])) == sorted(os.listdir(snaps[1]))
    for f in os.listdir(snaps[0]):
        if f == persist.MANIFEST:
            continue
        with open(os.path.join(snaps[0], f), "rb") as a, \
                open(os.path.join(snaps[1], f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("word_level,codec", GRID, ids=GRID_IDS)
def test_port_snapshot_restores_in_the_reference(tmp_path, word_level,
                                                 codec):
    port = port_engine(word_level, codec, deletes=(11,))
    ref = jax_engine(word_level, codec, deletes=(11,))
    port.snapshot(str(tmp_path))
    restored = JaxEngine.restore(str(tmp_path))
    assert restored.lifecycle.epoch == 1
    want = results_of(ref, word_level, "host")
    assert results_of(restored, word_level, "host") == want
    assert results_of(restored, word_level, "tiered") == want
    assert results_of(port, word_level, "tiered") == want


@pytest.mark.parametrize("word_level,codec", GRID, ids=GRID_IDS)
def test_reference_snapshot_restores_in_the_port(tmp_path, word_level,
                                                 codec):
    ref = jax_engine(word_level, codec, deletes=(11,))
    port = port_engine(word_level, codec, deletes=(11,))
    ref.snapshot(str(tmp_path))
    restored = Engine.restore(str(tmp_path), device="cpu")
    assert restored.lifecycle.epoch == 1
    want = results_of(port, word_level, "host")
    assert results_of(ref, word_level, "host") == want
    for backend in ("host", "tiered"):
        assert results_of(restored, word_level, backend) == want
    if not word_level:
        assert results_of(restored, False, "device") == \
            results_of(port, False, "device")


def test_round_trip_untiered_engine(tmp_path):
    eng = port_engine(tier=False)
    eng.snapshot(str(tmp_path))
    restored = Engine.restore(str(tmp_path), device="cpu")
    assert restored.lifecycle is None
    assert results_of(eng, False) == results_of(restored, False)


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    """Like the constructor, a restore without ``device`` puts the device
    images on the card, and raises where there is no CUDA device."""
    port_engine(n_docs=20).snapshot(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine.restore(str(tmp_path))


def test_restore_engine_kwargs_forward(tmp_path):
    port_engine().snapshot(str(tmp_path))
    restored = Engine.restore(str(tmp_path), device="cpu",
                              force_backend="host")
    r = restored.execute(Query(terms=("w0", "w1"), mode="bm25"))
    assert r.backend == "host"


def test_snapshot_mid_freeze_storm(tmp_path):
    eng = Engine(B=64, word_level=True, device="cpu",
                 tier_policy=FreezePolicy(every_docs=12, background=True))
    snaps = []
    for i, d in enumerate(make_docs(100)):
        eng.add_document(d)
        if i in (40, 99):
            snaps.append(eng.snapshot(str(tmp_path), keep=10))
    eng.lifecycle.wait()
    restored = Engine.restore(snaps[-1], device="cpu")
    assert restored.index.num_docs == eng.index.num_docs
    assert results_of(eng, True) == results_of(restored, True)
    assert Engine.restore(snaps[0], device="cpu").index.num_docs == 41


def test_quiesce_snapshot(tmp_path):
    eng = Engine(device="cpu",
                 tier_policy=FreezePolicy(every_docs=20, background=True))
    for d in make_docs(70):
        eng.add_document(d)
    eng.snapshot(str(tmp_path), quiesce=True)
    restored = Engine.restore(str(tmp_path), device="cpu")
    assert restored.lifecycle.epoch == eng.lifecycle.epoch
    assert results_of(eng, False) == results_of(restored, False)


# --------------------------------------------------------------------------
# the restored device path (C1 across a restore)
# --------------------------------------------------------------------------


def test_restored_device_path_after_deletes_equals_host(tmp_path):
    """Deletes, a snapshot, a restore, then an ingest of the deleted
    documents' terms: the restored engine's delta must ship the new
    postings of terms whose live f_t the deletes lowered, so its device
    answers equal its host answers and the never-restarted engine's."""
    eng = Engine(B=64, growth="const", device="cpu",
                 tier_policy=FreezePolicy(background=False))
    docs = make_docs(80, seed=9)
    eng.add_documents(docs[:40])
    eng.lifecycle.freeze(blocking=True)
    eng.add_documents(docs[40:])
    dead = [2, 5, 41, 47, 60]
    for d in dead:
        eng.delete_document(d)
    eng.snapshot(str(tmp_path))
    restored = Engine.restore(str(tmp_path), device="cpu")
    # the persisted live f_t lag the store's by the deletes; the restored
    # append-only counts are the store's, as the original engine's are
    assert restored._appended_fts == eng._appended_fts != restored._fts
    assert restored.resident.epoch == 1 and restored.resident.delta_blocks == 0
    # the deleted documents again: each of their terms gains exactly the
    # postings its deletes took from its live f_t, so live counts would
    # call it unchanged since the restore
    again = [docs[d - 1] for d in dead]
    for e in (eng, restored):
        e.add_documents(again)
    assert restored.resident.delta_blocks == 0   # refreshed lazily
    queries = [Query(terms=(t,), mode=m, k=20)
               for t in {t for d in dead for t in docs[d - 1]}
               for m in ("conjunctive", "ranked_tfidf", "bm25")]
    for q in queries:
        dev = restored.execute(Query(terms=q.terms, mode=q.mode, k=q.k,
                                     backend="device"))
        host = restored.execute(Query(terms=q.terms, mode=q.mode, k=q.k,
                                      backend="host"))
        orig = eng.execute(Query(terms=q.terms, mode=q.mode, k=q.k,
                                 backend="device"))
        assert dev.docids.tolist() == host.docids.tolist(), q
        assert dev.docids.tolist() == orig.docids.tolist(), q
        if q.mode != "conjunctive":
            np.testing.assert_allclose(dev.scores, host.scores, rtol=1e-5)
            assert dev.scores.tobytes() == orig.scores.tobytes(), q
    assert restored.resident.delta_blocks > 0


# --------------------------------------------------------------------------
# fleet snapshots (ShardedEngine), within the port and across the packages
# --------------------------------------------------------------------------


def fleet_results(fleet, word_level, backend=None):
    """:func:`results_of` for a fleet of either package."""
    q_cls = JaxQuery if isinstance(fleet, JaxFleet) else Query
    out = []
    for mode, terms, window in probes(word_level):
        r = fleet.execute(q_cls(terms=terms, mode=mode, k=15, window=window,
                                backend=backend))
        out.append((r.docids.tobytes(),
                    None if r.scores is None else r.scores.tobytes()))
    return out


def _feed_fleet(fleet, word_level, n_docs=80):
    """Half the stream batched, a blocking freeze of every shard, the rest
    one by one, then deletes on both sides of the freeze."""
    docs = make_docs(n_docs)
    half = n_docs // 2
    fleet.add_documents(docs[:half])
    for e in fleet.engines:
        e.lifecycle.freeze(blocking=True)
    for d in docs[half:]:
        fleet.add_document(d)
    for g in (3, 8, half + 5):
        fleet.delete_document(g)
    return fleet


def port_fleet(word_level=False, **kw):
    return _feed_fleet(ShardedEngine(
        num_shards=3, B=64, word_level=word_level, device="cpu",
        tier_policy=FreezePolicy(every_docs=10 ** 6, background=False),
        **kw), word_level)


def jax_fleet(word_level=False):
    return _feed_fleet(JaxFleet(
        num_shards=3, B=64, word_level=word_level,
        tier_policy=JaxPolicy(every_docs=10 ** 6, background=False)),
        word_level)


def test_sharded_round_trip(tmp_path):
    """The reference's fleet round trip on the port."""
    fleet = ShardedEngine(num_shards=3, B=64, device="cpu",
                          tier_policy=FreezePolicy(every_docs=25,
                                                   background=False))
    for d in make_docs(80):
        fleet.add_document(d)
    fleet.snapshot(str(tmp_path))
    restored = ShardedEngine.restore(str(tmp_path), device="cpu")
    try:
        assert restored.num_shards == fleet.num_shards
        assert restored._ft == fleet._ft
        c0, c1 = fleet._counts, restored._counts
        assert (c0.version, c0.num_docs, c0.total_tokens) == \
            (c1.version, c1.num_docs, c1.total_tokens)
        assert fleet_results(fleet, False) == fleet_results(restored, False)
        restored.add_document(["w0", "w1"])
        fleet.add_document(["w0", "w1"])
        assert fleet_results(fleet, False) == fleet_results(restored, False)
    finally:
        restored.close()
        fleet.close()


def _walk(snap):
    return sorted(os.path.relpath(os.path.join(d, f), snap)
                  for d, _, fs in os.walk(snap) for f in fs)


@pytest.mark.parametrize("word_level", [False, True], ids=["doc", "word"])
def test_fleet_same_stream_same_snapshot_files(tmp_path, word_level):
    """Both packages' fleets write the same manifest (every shard's
    fragment and the fleet counters) and the same artifacts."""
    snaps = [jax_fleet(word_level).snapshot(str(tmp_path / "jax")),
             port_fleet(word_level).snapshot(str(tmp_path / "port"))]
    mans = [json.load(open(os.path.join(s, persist.MANIFEST)))
            for s in snaps]
    for man in mans:            # the encodes' wall times, the one clock
        for frag in man["shards"]:
            assert frag["tier"].pop("encode_s") > 0
    assert mans[0] == mans[1]
    assert mans[0]["kind"] == "sharded" and mans[0]["num_shards"] == 3
    assert _walk(snaps[0]) == _walk(snaps[1])
    for f in _walk(snaps[0]):
        if os.path.basename(f) == persist.MANIFEST:
            continue
        with open(os.path.join(snaps[0], f), "rb") as a, \
                open(os.path.join(snaps[1], f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("word_level", [False, True], ids=["doc", "word"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_snapshot_restores_across_packages(tmp_path, writer,
                                                 word_level):
    """A fleet snapshot written by either package restores in the other
    (and in its own), and every restored fleet answers as the fleet that
    was never restarted, on the host and the tiered backends; the restored
    fleets keep merging exactly after one more document."""
    port, ref = port_fleet(word_level), jax_fleet(word_level)
    (port if writer == "port" else ref).snapshot(str(tmp_path))
    restored = {
        "port": ShardedEngine.restore(str(tmp_path), device="cpu"),
        "jax": JaxFleet.restore(str(tmp_path))}
    try:
        for backend in ("host", "tiered"):
            want = fleet_results(ref, word_level, backend)
            assert fleet_results(port, word_level, backend) == want
            for r in restored.values():
                assert fleet_results(r, word_level, backend) == want
        for f in (port, ref, *restored.values()):
            f.add_document(["w0", "w99", "w0"])
        want = fleet_results(ref, word_level, "host")
        for r in restored.values():
            assert fleet_results(r, word_level, "host") == want
            assert r.coordinator.epoch == 3
    finally:
        for f in (port, ref, *restored.values()):
            f.close()


def test_restored_fleet_device_path_equals_host(tmp_path):
    """A Const fleet on ``device="cpu"``: deletes after the freeze, a
    snapshot, a restore, then the deleted documents' terms again.  The
    restored fleet's device answers equal its host answers and the
    never-restarted fleet's device answers bit for bit."""
    fleet = port_fleet(delta_compact_frac=None)
    fleet.snapshot(str(tmp_path))
    restored = ShardedEngine.restore(str(tmp_path), device="cpu",
                                     delta_compact_frac=None)
    try:
        for e, o in zip(restored.engines, fleet.engines):
            assert e._appended_fts == o._appended_fts
            assert e.resident.epoch == 1 and e.resident.delta_blocks == 0
        docs = make_docs(80)
        again = [docs[g - 1] for g in (3, 8, 45)]
        for f in (fleet, restored):
            f.add_documents(again)
        for mode, terms, _ in probes(False):
            q = Query(terms=terms, mode=mode, k=15, backend="device")
            dev = restored.execute(q)
            orig = fleet.execute(q)
            host = restored.execute(Query(terms=terms, mode=mode, k=15,
                                          backend="host"))
            assert dev.backend == "device"
            assert dev.docids.tobytes() == orig.docids.tobytes(), q
            assert dev.docids.tolist() == host.docids.tolist(), q
            if mode != "conjunctive":
                assert dev.scores.tobytes() == orig.scores.tobytes(), q
                np.testing.assert_allclose(dev.scores, host.scores,
                                           rtol=1e-5)
        assert any(e.resident.delta_blocks > 0 for e in restored.engines)
    finally:
        restored.close()
        fleet.close()


# --------------------------------------------------------------------------
# crash points, retention, corruption: as the reference's
# --------------------------------------------------------------------------


def snap_dirs(root):
    return [d for d in os.listdir(root) if d.startswith(persist.SNAP_PREFIX)]


def tmp_dirs(root):
    return [d for d in os.listdir(root) if d.startswith(persist.TMP_PREFIX)]


def test_crash_points_are_the_references():
    assert persist.CRASH_POINTS == jax_persist.CRASH_POINTS
    assert persist.FORMAT_VERSION == jax_persist.FORMAT_VERSION == 1


@pytest.mark.parametrize("label", persist.CRASH_POINTS)
def test_crash_leaves_previous_snapshot_intact(tmp_path, monkeypatch, label):
    root = str(tmp_path)
    eng = port_engine(n_docs=40)
    first = eng.snapshot(root)
    eng.add_document(["w7", "w8", "w9"])
    monkeypatch.setattr(persist, "_CRASH_AT", label)
    with pytest.raises(persist.SnapshotCrash):
        eng.snapshot(root)
    monkeypatch.setattr(persist, "_CRASH_AT", None)
    assert persist.list_snapshots(root) == [first]
    assert persist.latest_snapshot(root) == first
    assert len(snap_dirs(root)) == 1 and len(tmp_dirs(root)) == 1
    # both packages fall back to the last complete manifest
    assert Engine.restore(root, device="cpu").index.num_docs == 40
    assert JaxEngine.restore(root).index.num_docs == 40
    second = eng.snapshot(root)
    assert tmp_dirs(root) == []
    assert persist.list_snapshots(root) == [first, second]
    assert Engine.restore(root, device="cpu").index.num_docs == 41


def test_crash_on_first_snapshot_leaves_nothing_restorable(tmp_path,
                                                           monkeypatch):
    root = str(tmp_path)
    eng = port_engine(n_docs=10)
    monkeypatch.setattr(persist, "_CRASH_AT", "manifest")
    with pytest.raises(persist.SnapshotCrash):
        eng.snapshot(root)
    monkeypatch.setattr(persist, "_CRASH_AT", None)
    assert persist.latest_snapshot(root) is None
    with pytest.raises(FileNotFoundError):
        Engine.restore(root, device="cpu")


def test_torn_snapshot_without_manifest_is_invisible(tmp_path):
    root = str(tmp_path)
    good = port_engine(n_docs=10).snapshot(root)
    torn = os.path.join(root, persist.SNAP_PREFIX + "9999999999")
    os.makedirs(torn)
    assert persist.list_snapshots(root) == [good]
    with pytest.raises(FileNotFoundError):
        Engine.restore(torn, device="cpu")


@pytest.mark.parametrize("artifact", ["blockstore", "fts", "tier_words"])
def test_corrupt_artifact_detected(tmp_path, artifact):
    snap = port_engine(n_docs=20).snapshot(str(tmp_path))
    target = os.path.join(snap, artifact + ".npy")
    raw = bytearray(open(target, "rb").read())
    raw[-1] ^= 0xFF
    with open(target, "wb") as f:
        f.write(raw)
    with pytest.raises(persist.SnapshotCorrupt):
        Engine.restore(str(tmp_path), device="cpu")


def test_wrong_kind_or_format_refused(tmp_path):
    snap = port_engine(n_docs=10).snapshot(str(tmp_path))
    path = os.path.join(snap, persist.MANIFEST)
    man = json.load(open(path))
    for key, value in (("kind", "sharded"), ("format", 2)):
        bad = dict(man, **{key: value})
        with open(path, "w") as f:
            json.dump(bad, f)
        with pytest.raises(persist.SnapshotCorrupt):
            Engine.restore(snap, device="cpu")


def test_sweep_tmp_counts_and_removes(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, persist.TMP_PREFIX + "0000000007"))
    os.makedirs(os.path.join(root, persist.TMP_PREFIX + "0000000008"))
    assert persist.sweep_tmp(root) == 2
    assert tmp_dirs(root) == []


def test_retention_keeps_newest(tmp_path):
    root = str(tmp_path)
    eng = port_engine(n_docs=5, tier=False)
    for i in range(5):
        eng.add_document(["w1", f"w{i + 2}"])
        eng.snapshot(root, keep=2)
    snaps = persist.list_snapshots(root)
    assert len(snaps) == 2
    assert Engine.restore(root, device="cpu").index.num_docs == 10
    assert os.path.basename(snaps[-1]) == persist.SNAP_PREFIX + "0000000005"


# --------------------------------------------------------------------------
# a fresh process, and derandomized streams
# --------------------------------------------------------------------------

_CHILD = r"""
import json, sys
from repro_torch.engine import Engine, Query
eng = Engine.restore(sys.argv[1], device="cpu")
out = []
for mode, terms, window in json.loads(sys.argv[2]):
    r = eng.execute(Query(terms=tuple(terms), mode=mode, k=15,
                          window=window))
    out.append([r.docids.tobytes().hex(),
                None if r.scores is None else r.scores.tobytes().hex()])
print(json.dumps(out))
print("jax" in sys.modules, "repro" in sys.modules)
"""


def test_fresh_process_restore_differential(tmp_path):
    """Snapshot here, restore in a new interpreter that imports no jax,
    compare the hex of the result bytes."""
    eng = Engine(B=64, word_level=True, device="cpu",
                 tier_policy=FreezePolicy(every_docs=15, background=True))
    for d in make_docs(60):
        eng.add_document(d)
    eng.snapshot(str(tmp_path))
    eng.lifecycle.wait()
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path),
         json.dumps(probes(True))],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "False False"
    expect = [[d.hex(), None if s is None else s.hex()]
              for d, s in results_of(eng, True)]
    assert json.loads(lines[-2]) == expect


doc_stream = hst.lists(
    hst.lists(hst.integers(0, 39), min_size=1, max_size=25),
    min_size=0, max_size=60)


@pytest.mark.parametrize("word_level,codec", GRID, ids=GRID_IDS)
@PROPERTY
@given(stream=doc_stream, dead=hst.lists(hst.integers(1, 60), max_size=4))
def test_snapshot_restore_property(tmp_path_factory, word_level, codec,
                                   stream, dead):
    """Any stream with deletes, any codec, either granularity: the port's
    snapshot restores in both packages to the never-restarted answers."""
    root = str(tmp_path_factory.mktemp("snap"))
    eng = Engine(word_level=word_level, device="cpu",
                 tier_policy=FreezePolicy(codec=codec, every_docs=16,
                                          background=False))
    for doc in stream:
        eng.add_document([VOCAB[i] for i in doc])
    for d in sorted(set(dead)):
        if d <= eng.index.num_docs:
            eng.delete_document(d)
    eng.snapshot(root)
    want = results_of(eng, word_level, "host")
    port = Engine.restore(root, device="cpu")
    ref = JaxEngine.restore(root)
    assert port.lifecycle.epoch == ref.lifecycle.epoch == eng.lifecycle.epoch
    for backend in ("host", "tiered"):
        assert results_of(port, word_level, backend) == want
        assert results_of(ref, word_level, backend) == want
    # the manifest is a fixed point across packages
    again = port.snapshot(str(tmp_path_factory.mktemp("again")))
    assert json.load(open(os.path.join(again, persist.MANIFEST))) == \
        json.load(open(os.path.join(persist.latest_snapshot(root),
                                    persist.MANIFEST)))
