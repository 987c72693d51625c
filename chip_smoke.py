#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py                  # Const path cut, Path A full
    python3 chip_smoke.py --docs 98732     # the Const path at full scale too

Phases, each printing its own lines; the first failed check exits non-zero:

  1. the card (``nvidia-smi`` name and power limit) and the build of every
     CUDA kernel from the sources in this checkout (one ``nvcc`` per
     source, all started together);
  2. every kernel against its plain PyTorch version on the same CUDA
     tensors at small sizes, a second launch bit-identical to the first:
     ``fused_query`` on a small engine (seeded Zipf stream, a freeze
     mid-stream, a delta, deletes; conjunctive bitmaps equal, ranked
     docids equal, scores within rtol 1e-6); ``intersect`` (empty lists,
     disjoint ranges, PAD entries, lengths that are not multiples of 32),
     ``topk_score`` (an empty input, docid 0 present, one and several
     segments) and ``dvbyte_decode`` (the small engine's gathered chain
     blocks: escapes at F = 4, heads with start > H, tails with end < B,
     empty blocks), all exactly;
  3. the Const main path: the first ``--docs`` documents (default
     ``CONST_DOCS``, the cut that keeps the whole run under about 900 s of
     its 1,200 s limit; 98,732 is the full stream) of the WSJ1-like stream
     (paper Table 5)
     through ``Engine(B=64, growth="const", delta_compact_frac=None)`` on
     the card with ``add_documents`` in batches of 256,
     ``collate_now()`` at 90 %, the last 10 % as the delta with a few
     hundred deletes on the way, then ``N_BATCHES`` batches of 32 queries
     per fused mode through ``QueryService(max_batch=32)``.  Every answer
     is held against the host backend (docids exact up to swaps among
     near-equal scores: the host scores in float64); the fused kernel's
     launch count must rise by one per (mode, k) group.  Then the kernel is
     held against its plain version at the main path's shapes and both are
     timed over ``REPS`` launches.

     Inside it, Path B, the split decode path: after the first post-freeze
     batch (the delta is non-empty) and before the first delete, one batch
     of 32 queries per mode through ``DeviceBackend(use_fused=False)`` —
     one ``query_step`` per image, each decoding with the ``dvbyte_decode``
     kernel (6 launches) — held against the host backend; then the decode
     kernel is timed at the frozen image's shapes.

     Delta compaction is off so that every launch reads both images, the
     frozen 90 % and a delta of 10 % of the stream: that two-part launch
     is the immediate-access path this script exists to drive.  With the
     engine's default (``delta_compact_frac=0.25``) a delta this large
     re-collates the whole index at the first refresh and leaves the delta
     empty; the ``[compaction]`` line prints the projection that decides it;
  4. Path A, the variable-growth kernel backend at full scale: the whole
     WSJ1-like stream into ``Engine(B=64, growth="triangle")`` (paper §5.4,
     no device image) through ``QueryService(max_batch=32, cache_size=0)``
     in batches of 256, 8 deletes per batch in the last 10 %, its bytes per
     posting beside the Const path's at the Const path's document count
     (the same stream prefix), and two query
     rounds (at 90 %, before any delete, and at the end) of one batch of 32
     queries per mode, unforced (the planner's kernel/host split is
     printed) and then forced to ``backend="kernel"``.  Every answer is held
     against the host backend, the ``intersect`` and ``topk_score`` launch
     counts must equal the expected ones, and each kernel is timed at the
     round's largest shapes beside its plain version, its bound and the one
     PyTorch call that computes the same function;
  5. one JSON line listing each kernel with its launches, parity error,
     times and bound; the card again; and as the last line
     ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Kernels build into ``src/repro_torch/kernels/_build``.
"""

from __future__ import annotations

import argparse
import gc
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
TRIANGLE_DOCS = 98_732         # Path A's stream: WSJ1-like, full scale
CONST_DOCS = 79_872            # the Const path's stream, cut (full: 98,732):
                               # 312 batches of 256, so Path A's engine
                               # passes the same count at a batch boundary
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
PARITY_RTOL = 1e-6
HOST_RTOL = 1e-5
#: kernel -> the TPU kernel it replaces (file:line of the function that
#: reaches pl.pallas_call in the JAX package)
REPLACES = {
    "fused_query": "src/repro/kernels/fused_query/kernel.py:60",
    "intersect": "src/repro/kernels/intersect/kernel.py:45",
    "topk_score": "src/repro/kernels/topk_score/kernel.py:48",
    "dvbyte_decode": "src/repro/kernels/dvbyte_decode/kernel.py:144",
}


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


def small_engine():
    """A 900-document Const engine: freeze at 600, a delta, 25 deletes."""
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
    return eng, rng, names, probs


def small_parity(eng, rng, names, probs) -> float:
    err = 0.0
    for mode in MODES:
        qs = zipf_queries(rng, names, probs, eng, 32, mode)
        e = kernel_vs_plain(prepared_batch(eng, qs, mode), mode)
        say(f"[parity] {mode}: kernel == plain version on a 900-doc engine "
            f"(freeze at 600, {len(eng.index.tombstones)} deletes), "
            f"rerun bit-identical, max |score diff| {e:.3g}")
        err = max(err, e)
    return err


def exact_and_repeatable(name, first, second, plain) -> float:
    """A kernel's two launches and its plain version, output by output:
    bit-identical, or fail.  Returns the largest absolute difference (0)."""
    import torch
    if not bit_identical(first, second):
        fail(f"{name}: a second kernel launch is not bit-identical")
    outs = first if isinstance(first, tuple) else (first,)
    refs = plain if isinstance(plain, tuple) else (plain,)
    err = 0.0
    for o, r in zip(outs, refs):
        if o.shape != r.shape or not bit_identical(o, r.to(o.dtype)):
            fail(f"{name}: kernel differs from the plain version")
        if o.numel():
            err = max(err, float((o.double() - r.double()).abs().max()))
    torch.cuda.synchronize()
    return err


def term_kernel_parity(eng, rng, names, probs) -> dict:
    """Phase 2 for the term path's per-op kernels, at small sizes and edge
    cases; returns name -> largest absolute difference."""
    import torch
    from repro_torch.core.blockstore import H
    from repro_torch.core.device_index import decode_blocks, gather_chains
    from repro_torch.engine.device_backend import pack_queries
    from repro_torch.kernels.dvbyte_decode.kernel import dvbyte_decode_kernel
    from repro_torch.kernels.intersect.kernel import intersect_kernel
    from repro_torch.kernels.intersect.ref import PAD, intersect_ref
    from repro_torch.kernels.topk_score.kernel import score_kernel
    from repro_torch.kernels.topk_score.ref import score_ref
    dev = eng.device
    g = np.random.default_rng(11)

    def srt(n, lo, hi):
        return torch.from_numpy(np.unique(g.integers(lo, hi, n)).astype(
            np.int32)).to(dev)

    pad = torch.full((40,), PAD, dtype=torch.int32, device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    cases = {
        "empty a": (none, srt(50, 1, 100)),
        "empty b": (srt(50, 1, 100), none),
        "disjoint": (srt(300, 1, 1000), srt(300, 2000, 3000)),
        "PAD entries": (torch.cat([srt(200, 1, 900), pad]),
                        torch.cat([srt(400, 1, 900), pad[:25]])),
        "lengths 33 and 61": (srt(100, 1, 300)[:33], srt(200, 1, 300)[:61]),
        "overlap 5k/9k": (srt(5000, 1, 40000), srt(9000, 1, 40000)),
    }
    errs = {"intersect": 0.0}
    for a, b in cases.values():
        errs["intersect"] = max(errs["intersect"], exact_and_repeatable(
            "intersect", intersect_kernel(a, b), intersect_kernel(a, b),
            intersect_ref(a, b)))
    say(f"[parity] intersect: kernel == plain version, rerun bit-identical, "
        f"on {', '.join(cases)}")

    def segments(n_docs, nseg, with_zero=False):
        ds, ws, off = [], [], [0]
        for _ in range(nseg):
            n = int(g.integers(1, max(2, n_docs // 2)))
            d = np.sort(g.choice(np.arange(1, n_docs), size=n, replace=False))
            if with_zero:
                d = np.concatenate([[0], d[:-1]])
            ds.append(d.astype(np.int32))
            ws.append((g.random(n) * 5).astype(np.float32))
            off.append(off[-1] + n)
        return (torch.from_numpy(np.concatenate(ds)).to(dev),
                torch.from_numpy(np.concatenate(ws)).to(dev), off)

    tcases = {
        "an empty input": (none, torch.zeros(0, device=dev), [0, 0], 300),
        "docid 0 present": (*segments(777, 1, with_zero=True), 777),
        "one segment": (*segments(5000, 1), 5000),
        "four segments over 98,733 docids": (*segments(98_733, 4), 98_733),
    }
    errs["topk_score"] = 0.0
    for d, w, off, n in tcases.values():
        ot = torch.tensor(off, dtype=torch.int32, device=dev)
        errs["topk_score"] = max(errs["topk_score"], exact_and_repeatable(
            "topk_score", score_kernel(d, w, n, ot), score_kernel(d, w, n, ot),
            score_ref(d, w, n)))
    say(f"[parity] topk_score: kernel == plain version bit for bit, rerun "
        f"bit-identical, on {', '.join(tcases)}")

    res = eng.resident
    res.refresh()
    qs = zipf_queries(rng, names, probs, eng, 32, "ranked_tfidf")
    _live, qt, qm, _caps = pack_queries(eng, res, qs, "ranked_tfidf")
    errs["dvbyte_decode"] = 0.0
    F = eng.index.F
    for img, mb, label in zip(res.images, res.max_blocks,
                              ("frozen", "delta")):
        blocks, start, end = gather_chains(img, qt, qm, mb)
        # and four rows with end < start
        blocks = torch.cat([blocks, blocks[:4]])
        start = torch.cat([start, torch.full((4,), 10, dtype=torch.int32,
                                             device=dev)])
        end = torch.cat([end, torch.full((4,), 5, dtype=torch.int32,
                                         device=dev)])
        plain = decode_blocks(blocks, start, end, F)
        heads = int((start > H).sum())
        tails = int(((end > 0) & (end < blocks.shape[1])).sum())
        empty = int((end <= start).sum())
        escapes = int((plain[1][plain[2]] >= F).sum())
        if not (heads and tails and empty and escapes):
            fail(f"dvbyte_decode: the {label} blocks miss an edge case "
                 f"(heads {heads}, tails {tails}, empty {empty}, escapes "
                 f"{escapes})")
        errs["dvbyte_decode"] = max(errs["dvbyte_decode"],
                                    exact_and_repeatable(
            "dvbyte_decode", dvbyte_decode_kernel(blocks, start, end, F),
            dvbyte_decode_kernel(blocks, start, end, F), plain))
        say(f"[parity] dvbyte_decode: kernel == plain version, rerun "
            f"bit-identical, on {blocks.shape[0]} {label} blocks (F={F}: "
            f"{escapes} escapes, {heads} heads with start > H, {tails} tails "
            f"with end < B, {empty} empty)")
    return errs


# --------------------------------------------------------------------------
# phase 3: the Const main path, with Path B inside it
# --------------------------------------------------------------------------


def check_against_host(eng, results, queries, label: str,
                       host: dict | None = None) -> None:
    """Every answer against the host backend's: conjunctive exactly,
    ranked with the near-tie rule at rtol ``HOST_RTOL``.  ``host`` keeps
    the host's answers by query for later checks while the index stands
    still; each distinct query runs on the host once."""
    from repro_torch.engine import Query
    host = {} if host is None else host
    asked = [Query(terms=q.terms, mode=q.mode, k=q.k, backend="host")
             for q in queries]
    todo = [q for q in dict.fromkeys(asked) if q not in host]
    host.update(zip(todo, eng.execute_many(todo)))
    for q, r, h in zip(queries, results, (host[a] for a in asked)):
        if q.mode == "conjunctive":
            if r.docids.tolist() != h.docids.tolist():
                fail(f"{label} conjunctive {q.terms}: {r.docids[:20]} host "
                     f"{h.docids[:20]}")
        elif not ranking_agrees(r.docids, r.scores, h.docids, h.scores,
                                HOST_RTOL):
            fail(f"{label} {q.mode} {q.terms}: {r.docids.tolist()} "
                 f"{r.scores.tolist()} host {h.docids.tolist()} "
                 f"{h.scores.tolist()}")


def bound_ms(nbytes: int) -> float:
    """Bytes moved over the card's memory rate, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def split_path(eng, rng, names, probs) -> dict:
    """Path B: one batch of 32 queries per mode through the split decode
    path, then the decode kernel at the frozen image's shapes."""
    import torch
    from repro_torch.core.device_index import decode_blocks, gather_chains
    from repro_torch.engine.device_backend import DeviceBackend, pack_queries
    from repro_torch.kernels.dvbyte_decode import kernel as dv_kernel
    from repro_torch.kernels.dvbyte_decode.kernel import dvbyte_decode_kernel
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    res = eng.resident
    res.refresh()
    if eng.index.tombstones or res.delta_blocks == 0:
        fail("the split path must run with a delta and no deletes")
    groups = [zipf_queries(rng, names, probs, eng, 32, mode)
              for mode in MODES]
    split = DeviceBackend(eng, res, use_fused=False)
    fused_before = fq_kernel.launches
    dv_kernel.launches = 0              # counts from here are Path B's
    t0 = time.perf_counter()
    results = [split.execute_many(qs) for qs in groups]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dv_kernel.launches
    expected = len(MODES) * len(res.images)
    if launches != expected:
        fail(f"dvbyte_decode launches on the split path: {launches}, "
             f"expected one per query_step per image = {expected}")
    if fq_kernel.launches != fused_before:
        fail("the split path launched the fused kernel")
    for qs, rs in zip(groups, results):
        check_against_host(eng, rs, qs, "split path")
    say(f"[split] {sum(map(len, groups))} queries in {len(groups)} batches "
        f"of 32 through DeviceBackend(use_fused=False) ({serve_s:.3f} s), "
        f"delta {res.delta_blocks} blocks, chain caps (frozen, delta) "
        f"{res.max_blocks}; dvbyte_decode launches {launches}; all answers "
        f"agree with the host backend")
    # the decode kernel at the frozen image's shapes: NB = Q * T * cap
    _live, qt, qm, _caps = pack_queries(eng, res, groups[1], MODES[1])
    blocks, start, end = gather_chains(res.images[0], qt, qm,
                                       res.max_blocks[0])
    F = eng.index.F
    err = exact_and_repeatable(
        "dvbyte_decode", dvbyte_decode_kernel(blocks, start, end, F),
        dvbyte_decode_kernel(blocks, start, end, F),
        decode_blocks(blocks, start, end, F))
    ms = cuda_ms(lambda: dvbyte_decode_kernel(blocks, start, end, F), REPS)
    plain_ms = cuda_ms(lambda: decode_blocks(blocks, start, end, F),
                       REPS // 4, warm=1)
    NB, B = blocks.shape
    bound = bound_ms(NB * B + 8 * NB + 9 * NB * B)
    say(f"[time] dvbyte_decode: NB={NB} (Q={qt.shape[0]} T={qt.shape[1]} "
        f"cap={res.max_blocks[0]}) B={B}: kernel {ms:.4f} ms (median of "
        f"{REPS}), plain version {plain_ms:.4f} ms (median of {REPS // 4}), "
        f"bound {bound:.4f} ms ({NB * B + 8 * NB} bytes in, {9 * NB * B} "
        f"out); parity exact, rerun bit-identical")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None}


def main_path(n_docs: int) -> dict:
    import inspect

    import torch
    from repro_torch.data.corpus import WSJ1_LIKE, SyntheticCorpus, term_table
    from repro_torch.engine import Engine
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    from repro_torch.kernels.fused_query.kernel import fused_query_kernel
    from repro_torch.kernels.fused_query.ref import fused_tile
    from repro_torch.serve import QueryService

    spec = WSJ1_LIKE.scaled(n_docs)
    corpus = SyntheticCorpus(spec)
    names = term_table(spec.universe)
    probs = 1.0 / np.arange(1, spec.universe + 1) ** spec.zipf_s
    probs /= probs.sum()
    split = None
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
                if split is None:           # Path B, before any delete
                    split = split_path(eng, rng, names, probs)
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
    check_against_host(eng, [t.result for t in tickets],
                       [t.query for t in tickets], "device")
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
    if split is None:
        fail("the stream ended before the split path ran")
    return {"launches": launches, "max_abs_err": err, "ms": mean(ms),
            "plain_ms": mean(plain_ms), "bound_ms": mean(bound),
            "bound_io_ms": mean(io_bound), "bound_by": bound_by,
            "library_ms": None, "split": split,
            "index": (eng.index.bytes_per_posting(), eng.index.num_docs)}


# --------------------------------------------------------------------------
# phase 4: Path A, the variable-growth kernel backend at full scale
# --------------------------------------------------------------------------


def expected_kernel_launches(eng, queries, backends) -> tuple[int, int]:
    """(intersect, topk_score) launches the kernel backend makes for the
    kernel-served queries among ``queries``: lists − 1 per conjunctive query
    whose terms all have postings (tombstoned ones included), one per ranked
    query with a live posting."""
    ix = ts = 0
    for q, b in zip(queries, backends):
        if b != "kernel":
            continue
        tids = [eng.term_id(t) for t in q.terms]
        if q.mode == "conjunctive":
            if all(t is not None and eng._appended_fts[t] > 0 for t in tids):
                ix += len(tids) - 1
        elif any(t is not None and eng._fts[t] > 0 for t in tids):
            ts += 1
    return ix, ts


def serve_round(eng, svc, groups, label: str) -> dict:
    """One query round: each group of 32 unforced, then forced to the kernel
    backend, through the service; every answer against the host; launch
    counts against the expected ones."""
    import collections

    import torch
    from repro_torch.engine import Query
    from repro_torch.kernels.intersect import kernel as ix_kernel
    from repro_torch.kernels.topk_score import kernel as ts_kernel
    got = {"intersect": 0, "topk_score": 0}
    host: dict = {}                  # the index stands still in a round
    for forced in (None, "kernel"):
        for qs in groups:
            qs = [Query(terms=q.terms, mode=q.mode, k=q.k, backend=forced)
                  for q in qs]
            ix_kernel.launches = ts_kernel.launches = 0
            tickets = [svc.submit(q) for q in qs]    # 32 fill a batch
            svc.flush()
            torch.cuda.synchronize()
            launched = (ix_kernel.launches, ts_kernel.launches)
            got["intersect"] += launched[0]
            got["topk_score"] += launched[1]
            # the service runs each distinct query of a batch once
            once = {t.query: t.result.backend for t in tickets}
            want = expected_kernel_launches(eng, list(once),
                                            list(once.values()))
            if launched != want:
                fail(f"{label} {qs[0].mode} ({forced or 'unforced'}): "
                     f"(intersect, topk_score) launches {launched}, expected "
                     f"{want}")
            check_against_host(eng, [t.result for t in tickets], qs,
                               f"{label} kernel backend", host)
            split = collections.Counter(once.values())
            say(f"[planner] {label} {qs[0].mode} "
                f"{'forced to kernel' if forced else 'unforced'}: "
                f"{len(once)} distinct of 32 → {dict(split)}; launches "
                f"(intersect, topk_score) {launched} as expected; answers "
                f"agree with the host backend")
    return got


def time_round(eng, groups, label: str) -> dict:
    """Per-query kernel-backend time by mode, end to end and its host
    postings decode; then each kernel at the round's largest shapes against
    its plain version, its bound and the one PyTorch call for the same
    function."""
    import torch
    from repro_torch.engine import Query
    from repro_torch.kernels.intersect.kernel import intersect_kernel
    from repro_torch.kernels.intersect.ref import intersect_ref
    from repro_torch.kernels.topk_score.kernel import score_kernel
    from repro_torch.kernels.topk_score.ref import score_ref
    kb = eng.backends["kernel"]
    for qs in groups:
        e2e, dec = [], []
        for q in dict.fromkeys(Query(terms=q.terms, mode=q.mode, k=q.k,
                                     backend="kernel") for q in qs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.execute(q)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for t in q.terms:
                eng.index.postings(t)
            t2 = time.perf_counter()
            e2e.append((t1 - t0) * 1e3)
            dec.append((t2 - t1) * 1e3)
        say(f"[time] {label} kernel backend {qs[0].mode}: per query "
            f"{np.median(e2e):.4f} ms end to end (median of {len(e2e)}), "
            f"host postings decode {np.median(dec):.4f} ms (median; "
            f"{sum(dec) / sum(e2e):.4f} of the summed time)")
    dev = eng.device
    # intersect: the conjunctive query with the longest lists; its shortest
    # list against its longest
    best = None
    for q in groups[0]:
        lists = kb.conjunctive_lists(q)
        if lists is not None and len(lists) > 1 and (
                best is None or len(lists[0]) + len(lists[-1])
                > len(best[0]) + len(best[1])):
            best = (lists[0], lists[-1])
    out = {}
    if best is not None:
        a, b = (torch.from_numpy(x).to(dev) for x in best)
        err = exact_and_repeatable("intersect", intersect_kernel(a, b),
                                   intersect_kernel(a, b),
                                   intersect_ref(a, b))
        ms = cuda_ms(lambda: intersect_kernel(a, b), REPS)
        plain = cuda_ms(lambda: intersect_ref(a, b), REPS)
        lib = cuda_ms(lambda: torch.isin(a, b), REPS)
        bound = bound_ms(4 * a.numel() + 4 * b.numel() + a.numel())
        out["intersect"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=bound, max_abs_err=err)
        say(f"[time] {label} intersect: |a|={a.numel()} |b|={b.numel()}: "
            f"kernel {ms:.4f} ms, plain version {plain:.4f} ms, torch.isin "
            f"{lib:.4f} ms (medians of {REPS}), bound {bound:.6f} ms; parity "
            f"exact, rerun bit-identical")
    # topk_score: the ranked query with the most postings
    best = None
    for qs in groups[1:]:
        for q in qs:
            inp = kb.ranked_postings(q)
            if inp is not None and (best is None
                                    or len(inp[0]) > len(best[0])):
                best = inp
    if best is not None:
        d, w, ot = (torch.from_numpy(x).to(dev) for x in best)
        n = eng.index.num_docs + 1
        err = exact_and_repeatable("topk_score", score_kernel(d, w, n, ot),
                                   score_kernel(d, w, n, ot),
                                   score_ref(d, w, n, best[2]))
        dl = d.long()
        ms = cuda_ms(lambda: score_kernel(d, w, n, ot), REPS)
        plain = cuda_ms(lambda: score_ref(d, w, n, best[2]), REPS)
        lib = cuda_ms(lambda: torch.zeros(n, device=dev).index_add_(0, dl, w),
                      REPS)
        bound = bound_ms(8 * d.numel() + 4 * ot.numel() + 4 * n)
        out["topk_score"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=bound, max_abs_err=err)
        say(f"[time] {label} topk_score: M={d.numel()} postings in "
            f"{ot.numel() - 1} segments, n_docs={n}: kernel {ms:.4f} ms, plain "
            f"version {plain:.4f} ms, index_add_ {lib:.4f} ms (medians of "
            f"{REPS}), bound {bound:.6f} ms; parity exact, rerun "
            f"bit-identical")
    return out


def triangle_path(n_docs: int, const_index: tuple[float, int]) -> dict:
    """Path A: the whole WSJ1-like stream into a Triangle-growth engine on
    the card, two query rounds through the service, unforced and forced to
    the kernel backend.  ``const_index`` is the Const path's (bytes per
    posting, documents), compared at the same document count."""
    import torch
    from repro_torch.data.corpus import WSJ1_LIKE, SyntheticCorpus, term_table
    from repro_torch.engine import Engine
    from repro_torch.serve import QueryService
    spec = WSJ1_LIKE.scaled(n_docs)
    names = term_table(spec.universe)
    probs = 1.0 / np.arange(1, spec.universe + 1) ** spec.zipf_s
    probs /= probs.sum()
    eng = Engine(B=64, growth="triangle")
    if eng.device_capable or not eng.kernel_capable:
        fail("a Triangle engine must route to the kernel backend")
    svc = QueryService(eng, max_batch=32, cache_size=0)
    rng = np.random.default_rng(4048)
    round_at = int(n_docs * 0.9)
    const_bpp, const_docs = const_index
    tri_bpp = None               # Triangle's bytes/posting at const_docs
    launches = {"intersect": 0, "topk_score": 0}
    timed = {}
    dead: set[int] = set()
    batch: list[list[str]] = []
    t_gen = time.perf_counter()

    def query_round(label):
        groups = [zipf_queries(rng, names, probs, eng, 32, mode)
                  for mode in MODES]
        for k, v in serve_round(eng, svc, groups, label).items():
            launches[k] += v
        timed.update(time_round(eng, groups, label))

    for ids in SyntheticCorpus(spec).doc_term_ids():
        batch.append([names[i] for i in ids.tolist()])
        done = eng.index.num_docs + len(batch)
        if len(batch) == 256 or done in (round_at, n_docs, const_docs):
            svc.ingest_batch(batch)
            batch.clear()
            if eng.index.num_docs == const_docs:
                tri_bpp = eng.index.bytes_per_posting()
            if eng.index.num_docs == round_at:
                query_round(f"round 1 ({round_at} docs, no deletes)")
            elif eng.index.num_docs > round_at:
                for _ in range(8):          # tombstone on the way
                    d = int(rng.integers(1, eng.index.num_docs + 1))
                    if d not in dead:
                        dead.add(d)
                        svc.delete(d)
    wall_s = time.perf_counter() - t_gen
    st = eng.stats()
    say(f"[ingest] triangle: {st.num_docs} docs, {st.num_postings} postings "
        f"in {st.ingest_time_s:.3f} s of add_documents ({wall_s:.3f} s with "
        f"generation and round 1): {st.num_docs / st.ingest_time_s:.1f} "
        f"docs/s; {len(dead)} deletes")
    if tri_bpp is None:
        fail(f"Path A's stream never reached the Const path's {const_docs} "
             f"documents")
    say(f"[index] at {const_docs} docs (the same stream prefix): triangle "
        f"{tri_bpp:.4f} bytes/posting vs const {const_bpp:.4f}; triangle "
        f"{eng.index.bytes_per_posting():.4f} at {st.num_docs} docs (host "
        f"dynamic index incl. hash; paper §5.4: Triangle growth keeps "
        f"Θ(√n) space overhead)")
    query_round(f"round 2 ({st.num_docs} docs, {len(dead)} deletes)")
    torch.cuda.synchronize()
    for name in launches:
        if launches[name] == 0 or name not in timed:
            fail(f"Path A never launched {name}")
    return {name: dict(timed[name], launches=launches[name])
            for name in launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=CONST_DOCS,
                    help="documents in the Const path's WSJ1-like stream")
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
    say(f"[build] {len(build.SOURCES)} kernels built in "
        f"{time.perf_counter() - t0:.3f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {name}: {line.strip()}")
    small = small_engine()
    small_err = small_parity(*small)
    term_errs = term_kernel_parity(*small)
    row = main_path(args.docs)
    gc.collect()       # the Const engine's host index goes before Path A's
    tri = triangle_path(TRIANGLE_DOCS, row["index"])
    if "jax" in sys.modules:
        fail("jax was imported")
    exact = "kernel == plain version bit for bit, rerun bit-identical"
    rows = {
        "fused_query": dict(row, max_abs_err=max(small_err,
                                                 row["max_abs_err"]),
                            parity=f"kernel == plain version (rtol "
                                   f"{PARITY_RTOL}), rerun bit-identical"),
        "intersect": dict(tri["intersect"], bound_by="bytes", parity=exact),
        "topk_score": dict(tri["topk_score"], bound_by="bytes",
                           parity=exact),
        "dvbyte_decode": dict(row["split"], parity=exact),
    }
    rows["intersect"]["max_abs_err"] = max(
        rows["intersect"]["max_abs_err"], term_errs["intersect"])
    rows["topk_score"]["max_abs_err"] = max(
        rows["topk_score"]["max_abs_err"], term_errs["topk_score"])
    rows["dvbyte_decode"]["max_abs_err"] = max(
        rows["dvbyte_decode"]["max_abs_err"], term_errs["dvbyte_decode"])
    kernels = []
    for name, r in rows.items():
        entry = {"name": name, "route": "cuda",
                 "source": str(build.SOURCES[name].relative_to(ROOT)),
                 "replaces": REPLACES[name]}
        for key in ("launches", "max_abs_err", "parity", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms"):
            entry[key] = r[key]
        if "bound_io_ms" in r:
            entry["bound_io_ms"] = r["bound_io_ms"]
        kernels.append(entry)
    say(json.dumps({"kernels": kernels}))
    say(f"[card] {card_line()}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
