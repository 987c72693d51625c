#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py                  # the WSJ1-like stream, full scale
    python3 chip_smoke.py --docs 20000     # a cut stream (faster)

Phases, each printing its own lines; the first failed check exits non-zero:

  1. the card (``nvidia-smi`` name and power limit) and the build of every
     CUDA kernel from the sources in this checkout;
  2. every kernel against its plain PyTorch version on the same CUDA
     tensors, on a small engine (seeded Zipf stream, a freeze mid-stream, a
     delta, deletes): conjunctive bitmaps equal, ranked docids equal,
     scores within rtol 1e-6, and a second launch bit-identical to the
     first;
  3. the main path at realistic size: the WSJ1-like stream (paper Table 5)
     through ``Engine(B=64, growth="const", delta_compact_frac=None)`` on
     the card with ``add_documents`` in batches of 256, ``collate_now()``
     at 90 %, the last 10 % as the delta with a few hundred deletes on the
     way, then ``N_BATCHES`` batches of 32 queries per fused mode through
     ``QueryService(max_batch=32)``.  Every answer is held against the
     host backend (docids exact up to swaps among near-equal scores: the
     host scores in float64); the kernel's launch count must rise by one
     per (mode, k) group.  Then the kernel is held against its plain
     version at the main path's shapes and both are timed over ``REPS``
     launches.

     Delta compaction is off so that every launch reads both images, the
     frozen 90 % and a delta of 10 % of the stream: that two-part launch
     is the immediate-access path this script exists to drive.  With the
     engine's default (``delta_compact_frac=0.25``) a delta this large
     re-collates the whole index at the first refresh and leaves the delta
     empty; the ``[device]`` line prints the projection that decides it;
  4. one JSON line listing each kernel with its launches, parity error,
     times and bound; the card again; and as the last line
     ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Kernels build into ``src/repro_torch/kernels/_build``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MODES = ("conjunctive", "ranked_tfidf", "bm25")
K = 10
N_BATCHES = 2                  # query batches of 32 per mode on the main path
REPS = 20                      # timed launches per mode
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
PARITY_RTOL = 1e-6
HOST_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------


def ranking_agrees(d_got, s_got, d_ref, s_ref, rtol: float) -> bool:
    """Same length, scores within ``rtol``, and the same docids except for
    order swaps inside runs of scores equal to ``rtol`` (the last run may
    also hold different members of a tie that runs past the cut).  For
    answers scored in different precisions; a kernel and its plain version
    are held to :func:`compare_outputs` instead."""
    if len(d_got) != len(d_ref):
        return False
    if not np.allclose(s_got, s_ref, rtol=rtol, atol=0):
        return False
    n, i = len(d_ref), 0
    while i < n:
        j = i + 1
        while j < n and abs(s_ref[j] - s_ref[i]) <= rtol * abs(s_ref[i]):
            j += 1
        if j < n and set(d_got[i:j].tolist()) != set(d_ref[i:j].tolist()):
            return False
        i = j
    return True


def compare_outputs(mode, got, ref, rtol: float) -> float:
    """Kernel output vs plain output of one launch: bitmaps equal, or
    docids equal (both select in (score desc, docid asc) order) and scores
    within ``rtol``.  Returns the largest absolute score difference (0 for
    the conjunctive bitmap)."""
    if mode == "conjunctive":
        if not bool((got == ref).all()):
            fail(f"{mode}: kernel bitmap differs from the plain version")
        return 0.0
    gd, gs = (t.cpu().numpy() for t in got)
    rd, rs = (t.cpu().numpy() for t in ref)
    for row in range(gd.shape[0]):
        if not (np.array_equal(gd[row], rd[row])
                and np.allclose(gs[row], rs[row], rtol=rtol, atol=0)):
            fail(f"{mode}: kernel row {row} differs from the plain version: "
                 f"{gd[row].tolist()} {gs[row].tolist()} vs "
                 f"{rd[row].tolist()} {rs[row].tolist()}")
    return float(np.abs(gs - rs).max())


def bit_identical(a, b) -> bool:
    import torch
    if isinstance(a, tuple):
        return all(bit_identical(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


# --------------------------------------------------------------------------
# kernel vs plain version on one batch
# --------------------------------------------------------------------------


def prepared_batch(eng, queries, mode):
    """The fused op's inputs for one (mode, K) group, as the main path
    builds them (``pack_queries`` + ``prepare``)."""
    from repro_torch.engine.device_backend import pack_queries
    from repro_torch.kernels.fused_query.ops import prepare
    res = eng.resident
    res.refresh()
    live, qt, qm, caps = pack_queries(eng, res, queries, mode)
    if not live:
        fail(f"{mode}: no query of the batch reached the device")
    return prepare(res.images, qt, qm, mode=mode, max_blocks=caps,
                   doclens=res._doclens if mode == "bm25" else None,
                   n_stat=res._n_stat, avg_stat=res._avg_stat,
                   alive=res._alive)


def kernel_vs_plain(args, mode) -> float:
    import torch
    from repro_torch.kernels.fused_query.kernel import fused_query_kernel
    from repro_torch.kernels.fused_query.ref import fused_tile
    first = fused_query_kernel(mode=mode, k=K, **args)
    second = fused_query_kernel(mode=mode, k=K, **args)
    plain = fused_tile(mode=mode, k=K, **args)
    torch.cuda.synchronize()
    if not bit_identical(first, second):
        fail(f"{mode}: a second kernel launch is not bit-identical")
    return compare_outputs(mode, first, plain, PARITY_RTOL)


def launch_bound(args, mode) -> tuple[float, str, float]:
    """Least time the card could take for one launch: the larger of the
    bytes it must move over 3.35 TB/s and its float operations over
    67 TFLOP/s.  Bytes: the packed blocks and per-slot metadata of the
    occupied slots, nterms, doclens (bm25), the liveness words, one write
    and one read of the (Q, cap+1) 4-byte accumulator, and the outputs.
    Operations: the weights of the postings these slots decode.

    Returns ``(bound_ms, bound_by, io_ms)``; ``io_ms`` is the same bound
    without the accumulator's traffic (inputs read once, outputs written
    once), which is the card's limit when the accumulator stays in L2."""
    from repro_torch.kernels.fused_query.ref import _part_postings
    Q = args["nterms"].shape[0]
    cap = args["cap"]
    acc_bytes = 2 * Q * (cap + 1) * 4
    nbytes = Q * 4
    postings = 0
    for part in args["parts"]:
        gat = part[0]
        used = int((part[2] > 0).sum())
        nbytes += used * (gat.shape[2] + 6 * 4)
        postings += int(_part_postings(part, args["F"])[2].sum())
    if mode == "bm25":
        nbytes += args["doclens"].numel() * 4
    if args["alive"] is not None:
        nbytes += args["alive"].numel() * 4
    kk = min(K, cap + 1)
    nbytes += Q * (cap + 1) if mode == "conjunctive" else Q * kk * 8
    flops = postings * {"conjunctive": 1, "ranked_tfidf": 3, "bm25": 7}[mode]
    t_io = nbytes / HBM_BYTES_PER_S * 1e3
    t_bytes = (nbytes + acc_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", max(t_io, t_ops)
    return t_ops, "operations", max(t_io, t_ops)


def cuda_ms(fn, reps: int, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# --------------------------------------------------------------------------
# phase 2: a small engine with a freeze, a delta and deletes
# --------------------------------------------------------------------------


def zipf_queries(rng, names, probs, eng, n, mode):
    """``n`` queries of 1–4 terms drawn by Zipf rank among ``names``,
    keeping only terms the engine has seen."""
    out = []
    from repro_torch.engine import Query
    while len(out) < n:
        nt = int(rng.integers(1, 5))
        ranks = rng.choice(len(names), size=nt, p=probs)
        terms = tuple(dict.fromkeys(names[r] for r in ranks.tolist()))
        if all(eng.term_id(t) is not None for t in terms):
            out.append(Query(terms=terms, mode=mode, k=K))
    return out


def small_parity() -> float:
    from repro_torch.engine import Engine
    rng = np.random.default_rng(7)
    V = 300
    names = [f"t{i}" for i in range(V)]
    probs = 1.0 / np.arange(1, V + 1) ** 1.07
    probs /= probs.sum()
    docs = [[names[i] for i in rng.choice(V, size=int(rng.integers(4, 80)),
                                          p=probs)] for _ in range(900)]
    eng = Engine(B=64, growth="const", delta_compact_frac=None)
    for i in range(0, 600, 128):
        eng.add_documents(docs[i:min(i + 128, 600)])
    eng.collate_now()
    for i, d in enumerate(docs[600:]):
        eng.add_document(d)
        if i % 12 == 0:                      # 25 deletes across both images
            victim = int(rng.integers(1, eng.index.num_docs + 1))
            if victim not in eng.index.tombstones:
                eng.delete_document(victim)
    err = 0.0
    for mode in MODES:
        qs = zipf_queries(rng, names, probs, eng, 32, mode)
        e = kernel_vs_plain(prepared_batch(eng, qs, mode), mode)
        say(f"[parity] {mode}: kernel == plain version on a 900-doc engine "
            f"(freeze at 600, {len(eng.index.tombstones)} deletes), "
            f"rerun bit-identical, max |score diff| {e:.3g}")
        err = max(err, e)
    return err


# --------------------------------------------------------------------------
# phase 3: the main path at realistic size
# --------------------------------------------------------------------------


def main_path(n_docs: int) -> dict:
    import inspect

    import torch
    from repro_torch.data.corpus import WSJ1_LIKE, SyntheticCorpus, term_table
    from repro_torch.engine import Engine, Query
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    from repro_torch.kernels.fused_query.kernel import fused_query_kernel
    from repro_torch.kernels.fused_query.ref import fused_tile
    from repro_torch.serve import QueryService

    spec = WSJ1_LIKE.scaled(n_docs)
    corpus = SyntheticCorpus(spec)
    names = term_table(spec.universe)
    name_len = np.fromiter((len(s) for s in names), np.int64,
                           count=len(names))
    fq_kernel.launches = 0              # counts from here are the path's
    eng = Engine(B=64, growth="const", delta_compact_frac=None)
    svc = QueryService(eng, max_batch=32, cache_size=0)
    freeze_at = int(n_docs * 0.9)
    rng = np.random.default_rng(2024)
    text_bytes = 0
    dead: set[int] = set()
    batch: list[list[str]] = []
    t_gen = time.perf_counter()
    collate_s = None

    def flush_docs():
        svc.ingest_batch(batch)
        batch.clear()

    for ids in corpus.doc_term_ids():
        batch.append([names[i] for i in ids.tolist()])
        text_bytes += int(name_len[ids].sum()) + len(ids)
        done = eng.index.num_docs + len(batch)
        if len(batch) == 256 or done == freeze_at or done == n_docs:
            flush_docs()
            if eng.index.num_docs == freeze_at:
                t0 = time.perf_counter()
                eng.collate_now()
                torch.cuda.synchronize()
                collate_s = time.perf_counter() - t0
            elif eng.index.num_docs > freeze_at:
                for _ in range(8):          # tombstone on the way
                    d = int(rng.integers(1, eng.index.num_docs + 1))
                    if d not in dead:
                        dead.add(d)
                        svc.delete(d)
    wall_s = time.perf_counter() - t_gen
    st = eng.stats()
    ingest_s = st.ingest_time_s
    say(f"[ingest] {st.num_docs} docs, {st.num_words} words, "
        f"{st.num_postings} postings, {st.vocab_size} terms, "
        f"{text_bytes} text bytes in {ingest_s:.3f} s of add_documents "
        f"({wall_s:.3f} s with generation): "
        f"{st.num_docs / ingest_s:.1f} docs/s, "
        f"{text_bytes / ingest_s * 60 / 1e9:.4f} GB/min")
    say(f"[index] {eng.index.bytes_per_posting():.4f} bytes/posting "
        f"(host dynamic index incl. hash); collate_now at {freeze_at} docs "
        f"{collate_s:.3f} s")
    # what the default compaction policy would do with this delta
    params = inspect.signature(Engine).parameters
    frac = params["delta_compact_frac"].default
    floor = params["delta_compact_min_blocks"].default
    projected = eng.resident._projected_delta_blocks(
        np.asarray(eng._appended_fts, dtype=np.int64))
    store_blocks = eng.index.store.nblocks
    would = projected > floor and projected > frac * store_blocks
    say(f"[compaction] off; projected delta {projected} blocks of a "
        f"{store_blocks}-block store ({projected / store_blocks:.4f}); the "
        f"default policy (frac {frac}, floor {floor} blocks) would "
        f"{'re-collate and empty the delta' if would else 'keep the delta'}")
    t0 = time.perf_counter()
    eng.resident.refresh()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    frozen, delta = eng.resident.images
    img_bytes = sum(t.numel() * t.element_size() for t in (
        frozen.blocks, frozen.term_slot, frozen.term_nblk, frozen.term_skip,
        frozen.term_nx, frozen.term_ft))
    say(f"[device] frozen image {img_bytes} bytes on {frozen.device} "
        f"({frozen.blocks.shape[0]} blocks, "
        f"{img_bytes / max(1, eng.resident._baseline.ft.sum()):.4f} "
        f"bytes/posting); delta {eng.resident.delta_blocks} blocks; "
        f"{len(eng.index.tombstones)} deletes; refresh {refresh_s:.3f} s; "
        f"docid capacity {frozen.num_docs}")

    # ---- serve: batches of 32 queries through the service ------------
    probs = 1.0 / np.arange(1, spec.universe + 1) ** spec.zipf_s
    probs /= probs.sum()
    groups = []
    for b in range(N_BATCHES):
        for mode in MODES:
            groups.append(zipf_queries(rng, names, probs, eng, 32, mode))
    served_before = eng.resident.batches_served
    tickets = []
    t0 = time.perf_counter()
    for qs in groups:
        tickets += [svc.submit(q) for q in qs]     # 32 fill a batch: flush
    svc.flush()
    serve_s = time.perf_counter() - t0
    launches = fq_kernel.launches
    if launches != len(groups):
        fail(f"kernel launches on the main path: {launches}, expected one "
             f"per (mode, k) group = {len(groups)}")
    if eng.resident.batches_served - served_before != len(groups):
        fail("the device backend served a different number of batches")
    if any(t.result.backend != "device" for t in tickets):
        fail("a main-path query was not routed to the device backend")
    say(f"[serve] {len(tickets)} queries in {len(groups)} batches of 32 "
        f"({serve_s:.3f} s); fused_query kernel launches {launches}")

    # ---- every answer against the host backend -----------------------
    t0 = time.perf_counter()
    host = eng.execute_many([Query(terms=t.query.terms, mode=t.query.mode,
                                   k=t.query.k, backend="host")
                             for t in tickets])
    for t, h in zip(tickets, host):
        r = t.result
        if t.query.mode == "conjunctive":
            if r.docids.tolist() != h.docids.tolist():
                fail(f"conjunctive {t.query.terms}: device {r.docids[:20]} "
                     f"host {h.docids[:20]}")
        elif not ranking_agrees(r.docids, r.scores, h.docids, h.scores,
                                HOST_RTOL):
            fail(f"{t.query.mode} {t.query.terms}: device "
                 f"{r.docids.tolist()} {r.scores.tolist()} host "
                 f"{h.docids.tolist()} {h.scores.tolist()}")
    say(f"[check] all {len(tickets)} answers agree with the host backend "
        f"(conjunctive exact, ranked rtol {HOST_RTOL}) in "
        f"{time.perf_counter() - t0:.3f} s")

    # ---- kernel vs plain at the main path's shapes, and times ---------
    err, ms, plain_ms, bound, io_bound, e2e = 0.0, {}, {}, {}, {}, {}
    bound_by = "bytes"
    for qs, mode in zip(groups[:3], MODES):
        args = prepared_batch(eng, qs, mode)
        err = max(err, kernel_vs_plain(args, mode))
        ms[mode] = cuda_ms(lambda: fused_query_kernel(mode=mode, k=K, **args),
                           REPS)
        plain_ms[mode] = cuda_ms(lambda: fused_tile(mode=mode, k=K, **args),
                                 REPS // 4, warm=1)
        bound[mode], by, io_bound[mode] = launch_bound(args, mode)
        if by != "bytes":
            bound_by = by
        times = []
        for _ in range(REPS + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.execute_many(qs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[mode] = float(np.median(times[2:]))
        parts = args["parts"]
        say(f"[time] {mode}: Q={args['nterms'].shape[0]} "
            f"PB={[p[0].shape[1] for p in parts]} cap={args['cap']}: "
            f"kernel {ms[mode]:.4f} ms (median of {REPS}), plain version "
            f"{plain_ms[mode]:.4f} ms (median of {REPS // 4}), bound "
            f"{bound[mode]:.4f} ms ({io_bound[mode]:.4f} ms without the "
            f"accumulator's traffic); engine batch end to end "
            f"{e2e[mode]:.4f} ms (median of {REPS})")
    mean = lambda d: float(np.mean([d[m] for m in MODES]))   # noqa: E731
    return {"launches": launches, "max_abs_err": err, "ms": mean(ms),
            "plain_ms": mean(plain_ms), "bound_ms": mean(bound),
            "bound_io_ms": mean(io_bound), "bound_by": bound_by}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=98_732,
                    help="documents in the WSJ1-like stream")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch is missing: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    say(f"[card] {card_line()}")
    t0 = time.perf_counter()
    build.build_all()
    say(f"[build] kernels built in {time.perf_counter() - t0:.3f} s")
    for line in build.build_log("fused_query").splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")
    small_err = small_parity()
    row = main_path(args.docs)
    if "jax" in sys.modules:
        fail("jax was imported")
    kernels = [{
        "name": "fused_query", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_query/csrc/fused_query.cu",
        "replaces": "src/repro/kernels/fused_query/kernel.py:60",
        "launches": row["launches"],
        "max_abs_err": max(small_err, row["max_abs_err"]),
        "parity": f"kernel == plain version (rtol {PARITY_RTOL}), "
                  "rerun bit-identical",
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "bound_io_ms": row["bound_io_ms"],
        "library_ms": None,
    }]
    say(json.dumps({"kernels": kernels}))
    say(f"[card] {card_line()}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
