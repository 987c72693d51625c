"""Engine snapshot/restore: crash-atomic persistence of the serving engine.

An :class:`~repro_torch.engine.Engine` (or a whole
:class:`~repro_torch.core.sharded_index.ShardedEngine` fleet) can be
snapshotted to disk and restored in a fresh process answering every query
mode byte-identically (docids, score doubles, tie order) to the
never-restarted original.  The
format is the JAX package's (``FORMAT_VERSION`` 1, file for file), so a
snapshot written by either package restores in the other.  What is
persisted is exactly the state of record:

  * the blockstore extents (``I[:nblocks*B]``) + the vocabulary hash array —
    the paper's whole dynamic index is these two flat arrays;
  * the term-id map, per-term ``f_t`` counters, and document lengths — the
    BM25 ``CollectionStats`` state the paper keeps outside the core index;
  * the published static tier, if any: the encoded :class:`StaticIndex`
    streams (via ``StaticIndex.to_arrays``) plus its docid horizon and
    epoch, so a restored engine resumes the tiered lifecycle mid-epoch;
  * engine configuration (B, growth policy, F, word_level, freeze policy)
    so restore rebuilds an identically-shaped engine without caller input.

Everything else is derived at restore: the forward index, live
word-level document frequencies and the deleted-token total from the
chains and tombstones; the append-only per-term posting counts
(``Engine._appended_fts``) from the restored chains' head f_t, never from
the persisted live f_t, which deletes decrement; and, on a device-capable
engine, the frozen device image and delta baseline, captured from the
restored index on ``Engine.device`` so that the delta starts empty.

Durability follows the write-temp-then-atomic-rename discipline: every
artifact is staged into a ``.tmp-<seq>`` directory, ``manifest.json``
(with a CRC per artifact) is written LAST, and the staging directory is
published with one ``os.rename`` — atomic on POSIX — so readers can never
observe a torn snapshot: either the rename happened and the manifest
(hence every artifact it checksums) is complete, or the directory is still
``.tmp-`` and is ignored (and swept at the next snapshot).
Retention keeps the newest ``keep`` snapshots.

Concurrency: snapshots run on the engine's single writer thread, so all
dynamic state is stable for the duration; the only concurrently-mutated
field is the lifecycle's published ``tier``, which is read exactly ONCE
(one reference load of an immutable :class:`StaticTier`).  A snapshot taken
mid-background-freeze therefore captures the previous tier plus the full
dynamic image — still byte-identical to serve from, because the tiered
backend merges to the same results at ANY horizon.  Callers who want the
newest tier in the snapshot use ``FreezeManager.quiesce()`` first.

Fault injection (tests): set ``_CRASH_AT`` to one of :data:`CRASH_POINTS`
and the persist path raises :class:`SnapshotCrash` at that point,
simulating a process kill between artifact writes.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import asdict

import numpy as np

from .collate import collate, is_collated
from .extensible import make_policy
from .index import DynamicIndex
from .lifecycle import FreezePolicy, StaticTier
from .static_index import StaticIndex

FORMAT_VERSION = 1
SNAP_PREFIX = "snap-"
TMP_PREFIX = ".tmp-"
MANIFEST = "manifest.json"

#: Injection points, in write order: "staged" fires right after the staging
#: dir is created; "blockstore" / "term_map" / "tier" after those artifact
#: groups are flushed; "manifest" after manifest.json is written but BEFORE
#: the atomic rename — the worst case, a byte-complete yet unpublished
#: snapshot.
CRASH_POINTS = ("staged", "blockstore", "term_map", "tier", "manifest")

_CRASH_AT: str | None = None  # tests monkeypatch this


class SnapshotCrash(RuntimeError):
    """Raised by the fault-injection hook to simulate a mid-persist kill."""


class SnapshotCorrupt(RuntimeError):
    """A published snapshot failed CRC or structural validation."""


def _crash(label: str) -> None:
    if _CRASH_AT == label:
        raise SnapshotCrash(f"injected crash at {label!r}")


# --------------------------------------------------------------------------
# checksummed artifact IO
# --------------------------------------------------------------------------


def _save_array(d: str, name: str, arr: np.ndarray, crcs: dict) -> None:
    path = os.path.join(d, name + ".npy")
    np.save(path, arr, allow_pickle=False)
    with open(path, "rb") as f:
        crcs[name] = zlib.crc32(f.read())


def _load_array(d: str, name: str, crcs: dict) -> np.ndarray:
    path = os.path.join(d, name + ".npy")
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError as e:
        raise SnapshotCorrupt(f"missing artifact {name!r} in {d}") from e
    if zlib.crc32(raw) != crcs.get(name):
        raise SnapshotCorrupt(f"CRC mismatch for artifact {name!r} in {d}")
    return np.load(path, allow_pickle=False)


def _blob(items: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """(byte blob, exclusive-prefix offsets) of a list of byte strings."""
    off = np.zeros(len(items) + 1, np.int64)
    np.cumsum(np.asarray([len(t) for t in items], np.int64), out=off[1:])
    return np.frombuffer(b"".join(items), np.uint8).copy(), off


def _unblob(blob: np.ndarray, off: np.ndarray) -> list[bytes]:
    raw = blob.tobytes()
    return [raw[int(off[i]):int(off[i + 1])] for i in range(len(off) - 1)]


# --------------------------------------------------------------------------
# one engine's state <-> one directory
# --------------------------------------------------------------------------


def _write_engine_state(eng, d: str) -> dict:
    """Write one engine's full state into ``d``; returns its manifest
    fragment (config + counters + artifact CRCs)."""
    idx = eng.index
    store = idx.store
    crcs: dict[str, int] = {}
    _save_array(d, "blockstore", store.I[:store.nblocks * store.B], crcs)
    _crash("blockstore")
    _save_array(d, "hash", idx.hash, crcs)
    vocab_blob, vocab_off = _blob(eng.vocab)
    _save_array(d, "vocab_blob", vocab_blob, crcs)
    _save_array(d, "vocab_off", vocab_off, crcs)
    _save_array(d, "fts", np.asarray(eng._fts, np.int64), crcs)
    _save_array(d, "doclens", np.asarray(eng._doclens, np.int64), crcs)
    # tombstoned docids: the chains still hold the dead postings, so the
    # mask must survive the restart byte-for-byte (forward index + live
    # df/avgdl are derived from chains+tombstones at restore)
    _save_array(d, "tombstones",
                np.asarray(sorted(idx.tombstones), np.int64), crcs)
    _crash("term_map")
    # ONE load of the published tier reference: immutable payload, so the
    # snapshot is internally consistent even mid-background-freeze
    tier = eng.static_tier()
    tier_meta = None
    if tier is not None:
        meta, arrays = tier.index.to_arrays()
        for name, arr in arrays.items():
            _save_array(d, "tier_" + name, arr, crcs)
        tier_meta = dict(meta)
        tier_meta.update(tier_num_docs=tier.num_docs,
                         tier_num_postings=tier.num_postings,
                         tier_epoch=tier.epoch, encode_s=tier.encode_s,
                         tier_compacted=tier.compacted)
    _crash("tier")
    return {
        "engine": {
            "B": store.B,
            "growth": store.policy.name,
            "growth_k": getattr(store.policy, "k", None),
            "F": store.F,
            "word_level": store.word_level,
            "nblocks": store.nblocks,
            "version": eng.version,
            "vocab_size": idx.vocab_size,
            "num_docs": idx.num_docs,
            "num_postings": idx.num_postings,
            "num_words": idx.num_words,
        },
        "lifecycle": (asdict(eng.lifecycle.policy)
                      if eng.lifecycle is not None else None),
        "tier": tier_meta,
        "files": crcs,
    }


def _restore_engine_dir(d: str, frag: dict, engine_kwargs: dict):
    """Rebuild one Engine from a directory + its manifest fragment.

    ``engine_kwargs`` forwards runtime knobs (device, planner,
    force_backend, decode_fn, ...); the persisted configuration wins for
    index shape and freeze policy."""
    from ..engine import Engine

    cfg = frag["engine"]
    crcs = frag["files"]
    kwargs = dict(engine_kwargs)
    kwargs.pop("tier_policy", None)  # persisted policy wins
    eng = Engine(B=int(cfg["B"]), growth=cfg["growth"], F=int(cfg["F"]),
                 word_level=bool(cfg["word_level"]), **kwargs)
    policy = make_policy(cfg["growth"], int(cfg["B"]),
                         cfg.get("growth_k") or 1.1)
    idx = DynamicIndex(B=int(cfg["B"]), growth=policy, F=int(cfg["F"]),
                       word_level=bool(cfg["word_level"]))
    store = idx.store
    blocks = _load_array(d, "blockstore", crcs)
    nblocks = int(cfg["nblocks"])
    if len(blocks) != nblocks * store.B:
        raise SnapshotCorrupt(
            f"blockstore length {len(blocks)} != nblocks*B "
            f"({nblocks}*{store.B}) in {d}")
    store.I = np.ascontiguousarray(blocks, np.uint8)
    store.nblocks = nblocks
    idx.hash = np.ascontiguousarray(_load_array(d, "hash", crcs), np.uint32)
    idx.vocab_size = int(cfg["vocab_size"])
    idx.num_docs = int(cfg["num_docs"])
    idx.num_postings = int(cfg["num_postings"])
    idx.num_words = int(cfg["num_words"])
    eng.index = idx
    vocab = _unblob(_load_array(d, "vocab_blob", crcs),
                    _load_array(d, "vocab_off", crcs))
    eng.vocab = vocab
    eng._tid = {tb: i for i, tb in enumerate(vocab)}
    eng._fts = [int(x) for x in _load_array(d, "fts", crcs)]
    eng._doclens = [int(x) for x in _load_array(d, "doclens", crcs)]
    if "tombstones" in crcs:    # absent in pre-deletion snapshots
        idx.tombstones = {int(x) for x in _load_array(d, "tombstones", crcs)}
    # forward index, live document frequencies and the deleted-token total
    # are derived state: rebuild from the restored chains + tombstones
    eng._rebuild_forward()
    # the append-only counts are the store's head f_t, as an adopted index
    # registers them: the persisted live f_t lags them by the deletes
    eng._appended_fts = [0] * len(vocab)
    for tb, h_ptr in idx.terms():
        eng._appended_fts[eng._tid[tb]] = store.get_ft(h_ptr * store.B)
    eng.version = int(cfg["version"])
    if eng.device_capable:
        # the frozen image must be collated; the live index keeps the
        # restored layout (a later snapshot writes the same blocks)
        eng.resident.freeze(idx if is_collated(idx) else collate(idx))
    if frag["lifecycle"] is not None:
        eng.enable_tiering(FreezePolicy(**frag["lifecycle"]))
        tm = frag["tier"]
        if tm is not None:
            static = StaticIndex.from_arrays(
                tm, {name[len("tier_"):]: _load_array(d, name, crcs)
                     for name in crcs if name.startswith("tier_")})
            eng.lifecycle.tier = StaticTier(
                index=static, num_docs=int(tm["tier_num_docs"]),
                num_postings=int(tm["tier_num_postings"]),
                epoch=int(tm["tier_epoch"]), encode_s=tm["encode_s"],
                compacted=int(tm.get("tier_compacted", 0)))
    return eng


# --------------------------------------------------------------------------
# snapshot directory management: stage -> manifest -> atomic rename -> gc
# --------------------------------------------------------------------------


def _seq_of(name: str) -> int:
    return int(name[len(SNAP_PREFIX):])


def list_snapshots(root: str) -> list[str]:
    """Complete (manifest-bearing) snapshot dirs under ``root``, oldest
    first.  A ``snap-`` dir without a manifest cannot exist after an atomic
    publish, but is defensively excluded anyway."""
    if not os.path.isdir(root):
        return []
    out = [n for n in os.listdir(root)
           if n.startswith(SNAP_PREFIX)
           and os.path.exists(os.path.join(root, n, MANIFEST))]
    return [os.path.join(root, n) for n in sorted(out, key=_seq_of)]


def latest_snapshot(root: str) -> str | None:
    """Path of the newest complete snapshot under ``root``, or None."""
    snaps = list_snapshots(root)
    return snaps[-1] if snaps else None


def sweep_tmp(root: str) -> int:
    """Remove orphaned ``.tmp-`` staging dirs (crashed snapshots); returns
    the number swept.  Runs automatically at the start of every snapshot."""
    swept = 0
    if not os.path.isdir(root):
        return swept
    for n in os.listdir(root):
        if n.startswith(TMP_PREFIX):
            shutil.rmtree(os.path.join(root, n), ignore_errors=True)
            swept += 1
    return swept


def _next_seq(root: str) -> int:
    seqs = [_seq_of(n) for n in os.listdir(root)
            if n.startswith(SNAP_PREFIX)]
    return (max(seqs) + 1) if seqs else 1


def _gc(root: str, keep: int) -> None:
    snaps = list_snapshots(root)
    for p in snaps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def _publish(root: str, keep: int, write_payload) -> str:
    """The atomic-publish skeleton shared by engine and fleet snapshots:
    sweep orphans, stage everything under ``.tmp-<seq>``, write the
    manifest LAST, then one ``os.rename``."""
    os.makedirs(root, exist_ok=True)
    sweep_tmp(root)
    seq = _next_seq(root)
    tmp = os.path.join(root, f"{TMP_PREFIX}{seq:010d}")
    os.makedirs(tmp)
    _crash("staged")
    manifest = write_payload(tmp)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, sort_keys=True, indent=1)
    _crash("manifest")
    final = os.path.join(root, f"{SNAP_PREFIX}{seq:010d}")
    os.rename(tmp, final)
    _gc(root, keep)
    return final


def _resolve(path_or_root: str) -> str:
    """Accept either a snapshot dir or a root full of them."""
    if os.path.exists(os.path.join(path_or_root, MANIFEST)):
        return path_or_root
    snap = latest_snapshot(path_or_root)
    if snap is None:
        raise FileNotFoundError(
            f"no complete snapshot under {path_or_root!r}")
    return snap


def _read_manifest(snap: str, kind: str) -> dict:
    with open(os.path.join(snap, MANIFEST)) as f:
        man = json.load(f)
    if man.get("format") != FORMAT_VERSION:
        raise SnapshotCorrupt(
            f"unsupported snapshot format {man.get('format')!r} in {snap}")
    if man.get("kind") != kind:
        raise SnapshotCorrupt(
            f"snapshot {snap} is kind={man.get('kind')!r}, expected {kind!r}")
    return man


# --------------------------------------------------------------------------
# public API: single engine
# --------------------------------------------------------------------------


def save_engine(engine, root: str, *, keep: int = 3) -> str:
    """Snapshot ``engine`` under ``root``; returns the published snapshot
    dir.  Runs on the writer thread (the single-writer model all ingest
    follows); safe while a background freeze encode is in flight."""
    def payload(tmp: str) -> dict:
        frag = _write_engine_state(engine, tmp)
        return {"format": FORMAT_VERSION, "kind": "engine", **frag}

    return _publish(root, keep, payload)


def restore_engine(path_or_root: str, **engine_kwargs):
    """Rebuild an Engine from a snapshot dir (or the newest snapshot under
    a root).  ``engine_kwargs`` forwards runtime knobs (planner,
    force_backend, device, decode_fn, ...) — index shape and freeze
    policy always come from the manifest."""
    snap = _resolve(path_or_root)
    man = _read_manifest(snap, "engine")
    return _restore_engine_dir(snap, man, engine_kwargs)


# --------------------------------------------------------------------------
# public API: sharded fleet
# --------------------------------------------------------------------------


def save_sharded(sharded, root: str, *, keep: int = 3) -> str:
    """Snapshot a :class:`~repro_torch.core.sharded_index.ShardedEngine`:
    one sub-directory per shard (each the same layout as a single-engine
    snapshot) plus the fleet state — the published ``_FleetCounts`` triple
    and the fleet-wide term document frequencies — all under ONE atomic
    rename, so the fleet can never be restored torn across shards."""
    counts = sharded._counts  # one load of the published snapshot

    def payload(tmp: str) -> dict:
        shards = []
        for s, eng in enumerate(sharded.engines):
            sd = os.path.join(tmp, f"shard-{s}")
            os.makedirs(sd)
            shards.append(_write_engine_state(eng, sd))
        terms = sorted(sharded._ft)
        ft_blob, ft_off = _blob(terms)
        crcs: dict[str, int] = {}
        _save_array(tmp, "ft_blob", ft_blob, crcs)
        _save_array(tmp, "ft_off", ft_off, crcs)
        _save_array(tmp, "ft_df",
                    np.asarray([sharded._ft[t] for t in terms], np.int64),
                    crcs)
        return {
            "format": FORMAT_VERSION, "kind": "sharded",
            "num_shards": sharded.num_shards,
            "max_in_flight": sharded.coordinator.max_in_flight,
            "counts": {"version": counts.version,
                       "num_docs": counts.num_docs,
                       "total_tokens": counts.total_tokens,
                       "deleted_docs": counts.deleted_docs},
            "shards": shards,
            "files": crcs,
        }

    return _publish(root, keep, payload)


def restore_sharded(path_or_root: str, *, parallel: bool = True,
                    max_in_flight: int | None = None, **engine_kwargs):
    """Rebuild a ShardedEngine fleet from a snapshot.  Shard engines are
    restored in shard order through the normal ``engine_factory`` seam, so
    the fleet wiring (stats provider, freeze coordinator registration,
    fan-out pool) is exactly the constructor's."""
    from .sharded_index import ShardedEngine, _FleetCounts

    snap = _resolve(path_or_root)
    man = _read_manifest(snap, "sharded")
    num_shards = int(man["num_shards"])
    shard_iter = iter(range(num_shards))

    def factory():
        s = next(shard_iter)
        return _restore_engine_dir(os.path.join(snap, f"shard-{s}"),
                                   man["shards"][s], engine_kwargs)

    fleet = ShardedEngine(
        num_shards=num_shards, engine_factory=factory,
        max_in_flight=(max_in_flight if max_in_flight is not None
                       else int(man["max_in_flight"])),
        parallel=parallel)
    c = man["counts"]
    fleet._counts = _FleetCounts(int(c["version"]), int(c["num_docs"]),
                                 int(c["total_tokens"]),
                                 int(c.get("deleted_docs", 0)))
    crcs = man["files"]
    terms = _unblob(_load_array(snap, "ft_blob", crcs),
                    _load_array(snap, "ft_off", crcs))
    df = _load_array(snap, "ft_df", crcs)
    fleet._ft = {t: int(df[i]) for i, t in enumerate(terms)}
    return fleet


__all__ = ["CRASH_POINTS", "SnapshotCrash", "SnapshotCorrupt",
           "save_engine", "restore_engine", "save_sharded",
           "restore_sharded", "list_snapshots", "latest_snapshot",
           "sweep_tmp", "FORMAT_VERSION"]
