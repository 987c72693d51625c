#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py                  # Const path and Path A cut
    python3 chip_smoke.py --docs 98732     # the Const path at full scale
    python3 chip_smoke.py --kernels        # phases 1-2 and the kernels at
                                           # the paths' shapes, ~1 min
    python3 chip_smoke.py --fused-only PT  # fused_query alone on the main
                                           # path's batches, saved in PT
    python3 chip_smoke.py --term-ab DIR    # dvbyte_decode and intersect
                                           # against another revision's
    python3 chip_smoke.py --tier-only      # the Const ingest and the tier
                                           # phase alone
    python3 chip_smoke.py --planner-only   # the planner phase alone on
                                           # a small Const engine
    python3 chip_smoke.py --fleet-only     # the fleet phase alone
    python3 chip_smoke.py --sanitize-only  # the sanitized fleet phase
                                           # (4b) alone
    python3 chip_smoke.py --mesh-only      # the mesh phase alone, with
                                           # the ingest its layouts need
    python3 chip_smoke.py --lm-only        # the LM serving path (phase
                                           # 6) alone, ~1 min
    python3 chip_smoke.py --train-only     # the LM training path (phase
                                           # 7) alone, ~2 min
    python3 chip_smoke.py --recsys-only    # the recsys path (phase 7b)
                                           # alone
    python3 chip_smoke.py --gnn-only       # the GNN path (phase 7c) alone
    python3 chip_smoke.py --dryrun-only    # the dry run (phase 8) alone
    python3 chip_smoke.py --dryrun-all     # the dry run over every cell
                                           # and probe (not in the default
                                           # run: the LM train cells trace
                                           # for minutes each)

Phases, each printing its own lines; the first failed check exits non-zero:

  1. the card (``nvidia-smi`` name and power limit) and the build of every
     CUDA kernel from the sources in this checkout (one ``nvcc`` per
     source, all started together);
  2. every kernel against its plain PyTorch version on the same CUDA
     tensors at small sizes, a second launch bit-identical to the first:
     ``fused_query`` on a small engine (seeded Zipf stream, a freeze
     mid-stream, a delta, deletes; conjunctive bitmaps equal, ranked
     docids equal, scores within rtol 1e-6); ``intersect`` (empty lists,
     disjoint ranges, PAD entries, lengths that are not multiples of 32,
     three further lists in one launch),
     ``topk_score`` (an empty input, docid 0 present, one and several
     segments, n_docs at its 512-docid tiles and one off, a segment inside
     one tile, an empty segment, docids past n_docs, 16, 17 and 40
     segments) and ``dvbyte_decode`` (the small engine's gathered chain
     blocks: escapes at F = 4, heads with start > H, tails with end < B,
     empty blocks), all exactly; ``retrieval_dot`` (q in 1, 8, 17; d in 30,
     64, 256; n in 0, 333, 2,048; float32 and bf16 unit rows; n off its
     row blocking, d off its 256-float pass, C's base one row and one float
     along) within ``DENSE_ATOL`` of its plain version; and
     ``tests/test_torch_gpu_kernels.py`` (``fused_query`` at the edges of
     its docid ranges), ``tests/test_torch_gpu_term_kernels.py``
     (``dvbyte_decode`` on chain blocks and constructed rows, ``intersect``
     at its tile and buffer edges with 1-9 further lists) and
     ``tests/test_torch_gpu_dense_kernels.py`` (``topk_score`` at its tile
     edges and up to 40 segments, ``retrieval_dot`` at its blocking edges
     in float32 and bf16), which import no jax, in a ``pytest -m gpu``
     subprocess;
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
     timed, and one engine batch per mode is cut into the engine's own
     steps (``pack_queries``, ``prepare``, the launch, and the copy back
     with the rest of the call), timed inside ``Engine.execute_many``
     (:func:`batch_steps`).

     Inside it, Path B, the split decode path: after the first post-freeze
     batch (the delta is non-empty) and before the first delete, one batch
     of 32 queries per mode through ``DeviceBackend(use_fused=False)`` —
     one ``query_step`` per image, each decoding with the ``dvbyte_decode``
     kernel (6 launches) — held against the host backend; then each mode's
     batch is timed on the host's clock with the device time of its two
     decode launches, and the decode kernel at the frozen image's shapes
     beside its bound (the bounds of every block, the bytes of the
     non-empty ones, the outputs).

     Then the planner phase (:func:`planner_phase`; also alone by
     ``--planner-only``): (a) on the same engine, before any tier, each
     mode's Zipf queries timed on the host's clock through ``device``
     and ``kernel`` at batches of 1, 8 and 32, one warm-up and the median
     of ``CROSSOVER_RUNS``, and through ``host`` once a query, alone (its
     row at a batch the mean of the batch's); ``CrossoverTable.from_rows``
     derives the planner's table from those rows (``[crossover]`` lines:
     the times, the rows, the thresholds); each batch then goes unforced
     under ``PlannerConfig(crossover=table)``, where every query must
     land on the backend the thresholds give, ``fused_query`` must launch
     once per (mode, k) group sent to ``device`` or ``kernel``, and every
     answer must be the host's; the engine's planner is put back.  (b)
     ``Engine(auto_collate_delta_frac=AUTO_FRAC)`` over the first
     ``AUTO_DOCS`` WSJ1-like documents, a freeze at half, then an
     unforced batch of 32 after every ``AUTO_CHUNK`` documents: the
     collations must rise, the delta after each batch must stay within
     the fraction of the store plus one chunk's new blocks and copied
     tails, every answer must be the host's and every batch one launch
     (``[autocollate]`` lines).

     Then the tier phase (:func:`tier_phase`) on the same engine: a
     background freeze (``enable_tiering(FreezePolicy(codec="bp128"))``,
     ``lifecycle.freeze()``: ``collate_now`` and a new frozen device image
     on this thread, the bp128 encode on the lifecycle's) while the first
     batch of 32 of each mode is served through ``fused_query``, the
     encode still running after them; then tier epoch 1, the horizon at
     ``num_docs``, the deletes compacted, the tier's bytes per posting
     beside the dynamic index's; the same batches on the new frozen image
     and, forced, through ``tiered`` (docids and score bits equal to the
     host's); 256 more documents and 8 deletes, the batches over the
     tier-era image and a delta; then ``Engine.snapshot`` to a temporary
     directory and ``Engine.restore`` onto the card, whose fused answers
     must equal the engine's before the snapshot bit for bit.  Every
     answer is held against the host backend, and ``fused_query`` must
     launch once per batch (12).  It prints the encode's wall seconds, a
     batch's ms during the encode against after it, the snapshot's
     seconds and bytes and the restore's seconds to the first answer on
     the card, each with the card's name and power limit.

     Then, on the same engine (frozen image, delta, deletes), the hybrid
     retrieval path: the two-tower model at full width (two 2,000,384 x 256
     float32 tables, towers 1024-512-256) on the card; two rounds of the
     same 32 conjunctive queries through ``Engine.execute_many`` (stage 1,
     the candidates, held against the host backend), each query's
     candidates embedded and scored by the ``retrieval_dot`` kernel against
     a seeded user profile (stage 2, top ``TOP``), with one fresh document
     per query ingested between the rounds, which round 1 must find.  The
     kernel is held against its plain version (``DENSE_ATOL``, reruns
     bit-identical, top ``TOP`` equal up to ties), its launches must equal
     the queries with candidates, and it is timed at the path's largest
     candidate set and at the reference's retrieval_cand shape (1 x
     1,000,448 x 256) beside its plain version and ``torch.mm``.

     Delta compaction is off so that every launch reads both images, the
     frozen 90 % and a delta of 10 % of the stream: that two-part launch
     is the immediate-access path this script exists to drive.  With the
     engine's default (``delta_compact_frac=0.25``) a delta this large
     re-collates the whole index at the first refresh and leaves the delta
     empty; the ``[compaction]`` line prints the projection that decides it;
  4. the fleet phase (:func:`fleet_phase`; also alone by
     ``--fleet-only``): ``ShardedEngine(num_shards=2, B=64,
     growth="const", delta_compact_frac=None)`` on the card behind
     ``QueryService(max_batch=32, pipelined=True)``; the first
     ``FLEET_DOCS`` documents of the WSJ1-like stream through
     ``ingest_batch`` in batches of 256 (the per-shard writer threads
     append, the drain in ``flush`` is the barrier), ``collate_now()`` on
     both shards at the batch boundary nearest 90 % and a batch of 32
     queries per mode right after it, 8 deletes per batch of 256 after
     it, a batch of 32 per mode at the end of the stream, then
     ``run_traffic`` over the service (a seeded schedule of
     ``TRAFFIC_EVENTS`` events: 20 % ingests of the next 256 documents, 1
     % deletes, Zipf queries from 64 distinct ones) and one more batch of
     32 per mode.  Every batch's answers are held against the fleet's
     host backend (conjunctive exactly, ranked with the near-tie rule)
     and each shard's ``fused_query`` launches against one per group
     with a query live on it; the traffic must leave no request
     unanswered and must send batches to the device.  It prints the
     pipelined ingest's docs/s beside the Const path's synchronous rate,
     each shard's refresh after an ingest, an engine batch's ms through
     the fleet beside the single engine's, and the traffic's latency
     percentiles and cache hit rate;
  4b. the sanitized fleet phase (:func:`sanitize_phase`; also alone by
     ``--sanitize-only``): the port's ``Sanitizer`` is enabled first, then
     ``ShardedEngine(num_shards=2, B=64, growth="const",
     delta_compact_frac=None, tier_policy=FreezePolicy(every_docs=1024,
     background=True, codec="bp128"), max_in_flight=1)`` is built on the
     card behind ``QueryService(max_batch=32, pipelined=True)``, so its
     locks are instrumented; every ``guarded_by`` field (the coordinator's
     slot accounting, each shard writer's ``_completed`` and ``_error``)
     is shadowed.  The first ``SANITIZE_DOCS`` WSJ1-like documents go
     through ``ingest_batch`` in batches of 256 (each shard freezes in the
     background at 1,024 and 2,048 of its documents, the writers contending
     for one slot); after every 1,024 documents a batch of 32 queries per
     mode is served and checked as in phase 4, then ``run_traffic`` runs
     ``SANITIZE_EVENTS`` events; then ``drain_freezes()`` and a last batch
     per mode.  The sanitizer must report nothing, ``peak_in_flight`` must
     be 1 with at least one deferred freeze, and the traffic must leave no
     request unanswered.  Then a seeded lock-order inversion (two locks
     from a second sanitizer taken in both orders around ``add_document``
     on a fresh fleet of ``SEEDED_DOCS`` documents) must be reported: the
     detector was live on this machine;
  5. the mesh phase (:func:`mesh_phase`; also alone by ``--mesh-only``):
     the port's device-mesh query step (``make_sharded_query_step``) on
     two ranks, two processes spawned by ``repro_torch.launch.launch`` on
     the one card, gloo collectives on the host (NCCL does not put two
     ranks on one card); each rank loads its image from ``.npy`` files.
     Layout M1, (data 2, model 1): the fleet's two shards, collated,
     imaged on one vocabulary, ``term_ft`` rebased to the summed store
     f_t.  Layout M2, (data 1, model 2): the Const path's frozen image
     (saved at its freeze), replicated, each rank taking 128 of 256
     queries.  Each layout runs query_rank (256 x 8, max_blocks 64, k 10)
     in ``ranked_sparse`` and ``ranked`` and query_conj (256 x 4) in
     ``conjunctive`` (the shapes of ``configs/paper_index.py``), Zipf-drawn,
     held against ``sharded_query_plain`` with the plain decode on the same
     images on the card (bitmaps and counts equal;
     ``ranked_sparse`` docids equal and scores within rtol 1e-6;
     ``ranked``, whose float atomics are not reproducible, within 1e-5
     with near-tie swaps), and a batch of 32 per mode at a max_blocks
     that covers its chains against the core's host oracle over each
     collated shard with the same statistics, globalized and merged;
     each rank's ``dvbyte_decode`` launches must rise by one per step.
     A step per mode and layout is timed (median of ``MESH_REPS``, host
     clock) with the share of its fuse: M1's collectives, M2's host copies
     (its data group is one rank);
  6. the LM serving path (:func:`lm_phase`; also alone by ``--lm-only``),
     which launches none of the five kernels (their counts are set to 0
     before it and must be 0 after): (a) llama3.2-3b and
     granite-moe-3b-a800m at full width and ``LM_SHALLOW`` layers in
     float32 with TF32 off, drawn once on the card and copied to the CPU;
     a prefill of 2 x ``LM_PREFILL`` tokens and ``LM_DECODE`` greedy
     decode steps on both, whose logits and K/V caches must agree within
     ``LM_TOL`` of the CPU's largest |value|, with the greedy tokens and
     the MoE's dropped tokens equal, and for llama prefill(t + 1)'s last
     logits equal to decode after prefill(t) within the same tolerance;
     (b) llama3.2-3b at full width and depth in bf16 (28 layers, 7.22 GB)
     through ``repro_torch.launch.serve.serve_lm`` (B = 2, S = 128,
     ``LM_STEPS`` greedy steps through the Triangle ``PagedKVCache``),
     twice from seed 0 with the same tokens and finite logits, its median
     ms per step beside its bound (the bytes a step must move over 3.35
     TB/s), a profiled window of ``LM_PROFILED`` steps (the card's busy
     time, idle share, kernels per step, no host sync) and the page
     overhead per sequence, Triangle beside Const; (c) the same for
     granite-moe-3b-a800m (32 layers, 7.96 GB, all 48 padded experts at
     capacity 8 a step), which must drop no token at decode;
  7. the LM training path (:func:`train_phase`; also alone by
     ``--train-only``), which launches none of the five kernels either:
     (a) llama3.2-3b and granite-moe-3b-a800m at full width and
     ``TRAIN_SHALLOW`` layers in float32 with TF32 off, drawn once on the
     card and copied to the CPU; one ``make_train_step`` step at B = 2, S
     = 64 on both: the loss and gnorm within ``TRAIN_TOL``, each gradient
     leaf within ``TRAIN_GRAD_TOL`` of its max |g|, an MoE's dropped
     tokens equal, and one AdamW update from the same gradients within
     ``TRAIN_OPT_TOL``; (b) llama3.2-3b at full width and depth in bf16
     (remat, microbatch 2) through ``repro_torch.launch.train.train_lm``
     and the Trainer: ``TRAIN_STEPS`` AdamW steps of 4 x 2,048 tokens
     (train_4k's batch cut to 4 and its sequence of 4,096 halved for the
     run's time) on one batch repeated,
     every loss finite and applied, the last below the first; ms per step
     against the compute bound, tokens/s, peak memory, and one step under
     ``torch.profiler`` (busy ms, idle share, kernels); (c) a resume:
     llama3.2-3b at full width and ``TRAIN_SHALLOW`` layers with bf16
     weights and moments, 6 steps straight against 3 steps with async
     checkpoints and 3 more from a new run on freshly drawn parameters
     that restores the checkpoint: parameters, moments and the resumed
     losses bit-identical; the saves and the restore timed;
  7b. the recsys path (:func:`recsys_phase`; also alone by
     ``--recsys-only``), which launches none of the five kernels either:
     (a) DLRM, SASRec, DIN and the two-tower model at their published
     widths (DLRM 26 fields, embed 128, bottom 13-512-256-128, top
     479-1024-1024-512-256-1; SASRec D 50, 2 blocks, S 50; DIN D 18, L
     100, attention 80-40, MLP 200-80; two-tower D 256, towers
     1024-512-256, 8 user features) with their tables cut to
     ``RECSYS_CUT_ROWS`` rows a field or table, in float32 with TF32 off,
     drawn once on the card and copied to the CPU; a batch of
     ``RECSYS_AB`` through both: the serve output, the loss and gnorm of
     one ``make_train_step`` step within ``RECSYS_TOL`` of the CPU's
     largest |value|, each gradient leaf within ``RECSYS_GRAD_TOL`` of its
     max |g|, and one AdamW update from the same gradients within
     ``RECSYS_OPT_TOL``; (b) each model at full scale through
     ``repro_torch.launch.train.train_recsys`` and the Trainer:
     ``RECSYS_STEPS`` AdamW steps on one ``ModelBatches`` batch of
     train_batch's 65,536 repeated, every loss finite and applied, the
     last below the first, then served at serve_p99 (B = 512) and DLRM
     also at serve_bulk (B = 262,144); each shape's median ms beside its
     compute bound (``RecsysArch.flops`` at the batch run over 67 TFLOP/s
     float32) and its peak memory, and one train step of each under
     ``torch.profiler`` (busy ms, idle share, kernels).  Its cuts, each
     printed: DLRM's fields capped at ``DLRM_ROW_CAP`` rows in (b)
     (Criteo-1TB's 104.5 GB of float32 tables exceed the card), the
     two-tower's train batch ``TWOTOWER_BATCH``, and the tables in (a);
  7c. the GNN path (:func:`gnn_phase`; also alone by ``--gnn-only``),
     which launches none of the five kernels either: (a) SchNet at its
     published widths (3 interactions, d_hidden 64, 300 RBFs, cutoff 10)
     with the regression head over 8 graphs and with the 47-class head, on
     a graph of ``GNN_AB`` nodes and edges, unchunked and in 4 edge
     chunks, float32 with TF32 off, drawn once on the card and copied to
     the CPU: the outputs and loss within ``GNN_TOL`` of the CPU's largest
     |value|, each gradient leaf within ``GNN_GRAD_TOL`` of its max |g|,
     one AdamW update from the same gradients within ``GNN_OPT_TOL``, and
     ``compress_int8``/``ef_compress_tree`` of the same gradients bit for
     bit; (c) molecule (3,840 nodes, 8,192 edges, 128 graphs) and
     full_graph_sm (2,708 nodes, 10,556 edges, 1,433 features, 47
     classes) at their configs, ``GNN_SHAPE_STEPS`` AdamW steps through
     ``repro_torch.launch.train.train_gnn``, finite losses and each step's
     ms; (b) ogb_products at full scale: ``synthetic_power_law`` at
     2,449,029 nodes and degree ``OGB_DEGREE`` (drawn on a thread while
     (a) and (c) run), its first 61,859,140 edges padded to 61,859,328,
     ``GNNArch.cfg_for``'s 16 checkpointed edge chunks, ``GNN_STEPS``
     AdamW steps on the one batch repeated, every loss finite and
     applied; its median ms beside the compute bound (``GNNArch.flops``
     over 67 TFLOP/s float32), the peak memory, the generator's largest
     in-degree and its share, and one step under ``torch.profiler`` (busy
     ms, idle share, the five longest kernels);
  8. the dry run (:func:`dryrun_phase`; also alone by ``--dryrun-only``),
     which launches none of the five kernels either: (a) in processes of
     their own, side by side (a fake process group is process-wide),
     ``python -m repro_torch.launch.dryrun`` traces the llama3.2-3b
     train_4k probe cells (L = 1, 2, the single-pod mesh) and one cell
     each of schnet (molecule), DLRM (train_batch) and paper_index
     (query_rank) on both meshes, on fake worlds of 256 and 512 ranks with
     fake CUDA tensors; one ``[dryrun]`` line a cell gives its per-rank
     argument and temp GB against 80 GB, flops, link bytes and trace
     seconds, and an error record fails; (b) meanwhile, in a process of
     its own (its caching allocator starts empty, as the prediction
     assumes), one cell a family (``DRYRUN_CARD``: the llama3.2-3b probe
     cell at L = 2 with train_4k's batch cut to ``DRYRUN_LM_BATCH``,
     SchNet at minibatch_lg, SASRec at train_batch) is predicted on a
     fake one-rank world (mesh data 1 x model 1), then built on a
     one-rank NCCL world and run on the card:
     the argument bytes allocated must equal the prediction, the growth of
     ``max_memory_allocated`` lie within ``DRYRUN_PEAK_TOL`` of the
     predicted peak, and ``FlopCounterMode``'s count equal the predicted
     flops; a second step is timed by CUDA events.  ``--dryrun-all`` runs
     every cell and probe through the CLI instead of (a) and (b);
  9. Path A, the variable-growth kernel backend: the first
     ``TRIANGLE_DOCS`` documents of the WSJ1-like stream (cut to 4,096
     for the tier, fleet, mesh, LM and planner phases) into ``Engine(B=64,
     growth="triangle")`` (paper §5.4, no device image) through
     ``QueryService(max_batch=32, cache_size=0)`` in batches of 256, its
     bytes per posting beside the Const path's at the same document
     count (the same stream prefix), one query round at 90 % of one batch
     of 32 queries per mode, unforced (the planner's kernel/host split is
     printed) and then forced to ``backend="kernel"``, and at the end 8
     deletes and a second, untimed round the same way (``intersect`` and
     ``topk_score`` with tombstones).  Every answer is held
     against the host backend, the ``intersect`` and ``topk_score`` launch
     counts must equal the expected ones (one ``intersect`` launch per
     kernel-served conjunctive query of two or more terms, all with
     postings), and each kernel is timed at the round's largest shapes
     beside its plain version, its bound and the one PyTorch call that
     computes the same function (``intersect`` also beside an empty kernel
     on its grid, the launch floor); then ``topk_score`` on
     seeded inputs of 9 and 40 segments over the same docids (off the
     path: a ranked query has 1-4 terms);
  10. one JSON line listing each kernel with its launches, parity error,
     times and bound; the card again; and as the last line
     ``{"ok": true, "device": {...}}``.

Kernel times are device times from :func:`device_ms_in_turns`: runs of
``LAUNCHES`` back-to-back launches between two CUDA events, queued behind
a sleep kernel so that the host's enqueue time (a ctypes wrapper takes
0.02-0.04 ms a call) is not in them, in turns with the one PyTorch call
that computes the same function where there is one (kernel, library,
library, kernel); each line gives the host's enqueue time per call apart.
Plain versions and end-to-end lines are timed call by call (``cuda_ms``,
host clock).  ``--kernels`` stops after phase 2 and times the kernels that
have a library call on seeded inputs at the paths' shapes (``topk_score``
also at 9 and 40 segments); it drives no path and prints no result line.
``--tier-only`` builds only ``fused_query``, builds the Const engine as
phase 3 does (without the split path) and runs the tier phase on it.
``--planner-only`` builds only ``fused_query``, builds a Const engine as
phase 3 does (without the split path) of ``PLANNER_DOCS`` documents, or
``--docs``, and runs the planner phase on it.
``--fleet-only`` builds only ``fused_query`` and runs phase 4 alone.
``--sanitize-only`` builds only ``fused_query`` and runs phase 4b alone.
``--mesh-only`` builds only ``dvbyte_decode``, ingests the Const stream
to its freeze and deals the fleet's documents into two host indexes, and
runs phase 5 alone.
``--lm-only`` builds nothing (the LM path launches no hand-written kernel)
and runs phase 6 alone; ``--train-only`` builds nothing and runs phase 7
alone; ``--recsys-only`` builds nothing and runs phase 7b alone;
``--gnn-only`` builds nothing and runs phase 7c alone; ``--dryrun-only``
builds nothing and runs phase 8 alone, ``--dryrun-all`` the whole sweep.
``--fused-only PT`` builds only ``fused_query`` and times it on phase 3's
first prepared batch of 32 queries per mode, read from PT, or first
written there from a Const engine built as phase 3 builds it (a CRC of
the batches is printed in both); run in two checkouts on one PT, it
compares two builds of the kernel on the same inputs.  ``--term-ab DIR``
builds another revision's ``dvbyte_decode.cu`` and ``intersect.cu`` (put
in DIR) beside this checkout's and times both in turns on Path B's decode
input (saved in DIR) and a seeded intersect case at Path A's shape, with
one and three further lists; then checks both.  Neither drives a path or
prints a result line.

Imports nothing of JAX.  Kernels build into ``src/repro_torch/kernels/_build``.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MODES = ("conjunctive", "ranked_tfidf", "bm25")
K = 10
N_BATCHES = 2                  # query batches of 32 per mode on the main path
REPS = 20                      # timed calls of a plain version or a batch
LAUNCHES = 20                  # back-to-back kernel launches per timed run
RUNS = 7                       # timed runs per turn
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
TRIANGLE_DOCS = 4_096          # Path A's stream: WSJ1-like, cut (full:
                               # 98,732) to make room for the tier, fleet,
                               # mesh, LM and planner phases; a batch
                               # boundary of the Const path, which records
                               # its bytes/posting there
FLEET_DOCS = 6_144             # the fleet phase's stream: the first 6,144
                               # WSJ1-like documents, 3,072 a shard (a cut
                               # of 98,732 for time: 32,768 took the run
                               # past its time budget; 24,576 until the
                               # sanitized fleet phase 4b, ~75 s, had to be
                               # paid for, 12,288 until the LM phase, 8,192
                               # until the planner phase)
TRAFFIC_EVENTS = 300           # the fleet phase's traffic schedule (cut
                               # from 1,000 for time, then from 500 for
                               # phase 4b)
SANITIZE_DOCS = 4_096          # phase 4b's stream: the first 4,096 WSJ1-like
                               # documents, 2,048 a shard
SANITIZE_EVERY = 1_024         # phase 4b: a background freeze per 1,024 new
                               # documents of a shard, and a serving round
                               # and traffic after every 1,024 of the stream
SANITIZE_EVENTS = 50           # phase 4b's traffic events after each round
                               # (cut from 100 for the LM phase)
SEEDED_DOCS = 64               # phase 4b's seeded-inversion fleet
CONST_DOCS = 73_728            # the Const path's stream, cut (full: 98,732):
                               # 288 batches of 256, passing
                               # TRIANGLE_DOCS at a batch boundary; it
                               # keeps the full stream's device shapes
                               # (docid capacity 131,072, frozen chain cap
                               # 4,096: ~2,240 blocks at the freeze)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
PARITY_RTOL = 1e-6
HOST_RTOL = 1e-5
DENSE_ATOL = 1e-6              # retrieval_dot vs its plain version on unit
                               # rows: both sum float32 in other orders
TOP = 10                       # the hybrid path's dense top k
#: the jax-free kernel cases, run on the card in phase 2
GPU_TESTS = ("tests/test_torch_gpu_kernels.py",
             "tests/test_torch_gpu_term_kernels.py",
             "tests/test_torch_gpu_dense_kernels.py")
#: kernel -> the TPU kernel it replaces (file:line of the function that
#: reaches pl.pallas_call in the JAX package)
REPLACES = {
    "fused_query": "src/repro/kernels/fused_query/kernel.py:60",
    "intersect": "src/repro/kernels/intersect/kernel.py:45",
    "topk_score": "src/repro/kernels/topk_score/kernel.py:48",
    "dvbyte_decode": "src/repro/kernels/dvbyte_decode/kernel.py:144",
    "retrieval_dot": "src/repro/kernels/retrieval_dot/kernel.py:38",
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


def ranking_agrees(d_got, s_got, d_ref, s_ref, rtol: float,
                   atol: float = 0.0) -> bool:
    """Same length, scores within ``rtol`` (plus ``atol``), and the same
    docids except for order swaps inside runs of scores equal to that
    tolerance (the last run may also hold different members of a tie that
    runs past the cut).  For answers scored in different precisions or
    orders; a fused kernel and its plain version are held to
    :func:`compare_outputs` instead."""
    if len(d_got) != len(d_ref):
        return False
    if not np.allclose(s_got, s_ref, rtol=rtol, atol=atol):
        return False
    n, i = len(d_ref), 0
    while i < n:
        j = i + 1
        while j < n and (abs(s_ref[j] - s_ref[i])
                         <= atol + rtol * abs(s_ref[i])):
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


def launch_bound(args, mode) -> tuple[float, str]:
    """Least time the card could take for one launch: the larger of the
    bytes it must move over 3.35 TB/s and its float operations over
    67 TFLOP/s.  Bytes: each input read once (the packed blocks and
    per-slot metadata of the occupied slots, nterms, doclens for bm25, the
    liveness words) and each output written once.  The (Q, cap+1)
    accumulator is not counted: the kernel keeps it in shared memory.
    Operations: the weights of the postings these slots decode."""
    from repro_torch.kernels.fused_query.ref import _part_postings
    Q = args["nterms"].shape[0]
    cap = args["cap"]
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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def _queued_run(fn, launches: int, sleep_cycles: int):
    """One timed run: ``launches`` calls of ``fn`` enqueued behind a sleep
    kernel, between two CUDA events.  Returns (device ms per call, host ms
    per call to enqueue, whether the card was still asleep when the last
    call was enqueued: then no launch waited for the host)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host = (time.perf_counter() - t0) / launches * 1e3
    queued = not a.query()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches, host, queued


def device_ms_in_turns(kernel, library=None, floor=None) -> dict:
    """Device time per call of ``kernel``, of the ``library`` call that
    computes the same function and of ``floor`` (an empty kernel on the
    kernel's grid), without the host's enqueue time.

    Each run enqueues ``LAUNCHES`` back-to-back calls between two CUDA
    events, behind a sleep kernel long enough that the card starts on them
    only after the last is enqueued (the sleep doubles until it is).  The
    two alternate in turns (kernel, library, library, kernel), ``RUNS``
    runs a turn (with a floor: kernel, library, floor, floor, library,
    kernel); each turn gives its median, each callable the mean of its
    two turns.  The host's enqueue time per call is reported apart.  A
    call that waits for the card itself (its runs cannot be queued) is
    timed in runs all the same, and its time holds the host's; ``waits``
    names it.  Returns ``ms``, ``library_ms`` and ``floor_ms`` (None
    where not given), ``order``, ``turns``, ``waits`` and ``host_ms``
    (label -> median)."""
    import torch
    fns = {"kernel": kernel}
    if library is not None:
        fns["library"] = library
    if floor is not None:
        fns["floor"] = floor
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    order = list(fns) + list(fns)[::-1]
    sleep = 1 << 20
    turns, host, waits = [], {k: [] for k in fns}, set()
    for label in order:
        times = []
        while len(times) < RUNS:
            ms, h, queued = _queued_run(fns[label], LAUNCHES,
                                        0 if label in waits else sleep)
            if not queued and label not in waits:
                if _queued_run(fns[label], 1, 1 << 26)[2]:
                    sleep *= 2
                else:           # it waits for the card: time it as it is
                    waits.add(label)
                continue
            times.append(ms)
            host[label].append(h)
        turns.append(float(np.median(times)))
    dev = {k: float(np.mean([t for lab, t in zip(order, turns) if lab == k]))
           for k in fns}
    return {"ms": dev["kernel"], "library_ms": dev.get("library"),
            "floor_ms": dev.get("floor"), "order": order,
            "turns": turns, "waits": sorted(waits),
            "host_ms": {k: float(np.median(v)) for k, v in host.items()}}


def turns_text(t: dict, library: str = "library") -> str:
    """How ``device_ms_in_turns`` measured ``t``, for a ``[time]`` line."""
    how = (f"device ms per call in runs of {LAUNCHES} back-to-back launches, "
           f"medians of {RUNS} runs a turn")
    for label in t["waits"]:
        name = library if label == "library" else label
        how += (f"; {name} waits for the card within a call, so its runs "
                f"hold the host's time too")
    turns = " / ".join(f"{x:.4f}" for x in t["turns"])
    names = ", ".join({"library": library, "floor": "empty kernel"}.get(
        lab, lab) for lab in t["order"])
    if t["library_ms"] is None:
        return (f"({names}: {turns}; {how}; host ms per call to "
                f"enqueue {t['host_ms']['kernel']:.4f})")
    return (f"in turns ({names}: {turns}; {how}); "
            f"kernel/{library} {t['ms'] / t['library_ms']:.3f}; host ms per "
            f"call to enqueue: kernel {t['host_ms']['kernel']:.4f}, {library} "
            f"{t['host_ms']['library']:.4f}")


def host_ms(fn, reps: int, warm: int = 2) -> float:
    """Median time of ``fn`` over ``reps`` calls on the host's clock, each
    ending in ``torch.cuda.synchronize()``: what a caller waits."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def cuda_ms(fn, reps: int, warm: int = 3) -> float:
    """Median time of ``fn`` over ``reps`` calls, each between two CUDA
    events: the device's time, plus the host's enqueue time where that is
    the longer.  For plain versions and end-to-end lines; kernels are timed
    by :func:`device_ms_in_turns`."""
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


def zipf_queries(rng, names, probs, eng, n, mode, known=None):
    """``n`` queries of 1–4 terms drawn by Zipf rank among ``names``,
    keeping only known terms: by default, terms engine ``eng`` has seen."""
    out = []
    from repro_torch.engine import Query
    if known is None:
        def known(t):
            return eng.term_id(t) is not None
    while len(out) < n:
        nt = int(rng.integers(1, 5))
        ranks = rng.choice(len(names), size=nt, p=probs)
        terms = tuple(dict.fromkeys(names[r] for r in ranks.tolist()))
        if all(known(t) for t in terms):
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


def gpu_tests() -> None:
    """Phase 2: the ``gpu``-marked kernel cases that import no jax, in a
    pytest subprocess; fails the run on a nonzero exit or a skip."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", *GPU_TESTS], cwd=ROOT, capture_output=True,
        text=True, timeout=900)
    lines = out.stdout.strip().splitlines() or [""]
    if out.returncode != 0 or "skipped" in lines[-1]:
        print(out.stdout[-6000:], out.stderr[-2000:], flush=True)
        fail(f"{' '.join(GPU_TESTS)}: pytest exit {out.returncode}: "
             f"{lines[-1]}")
    say(f"[parity] {' '.join(GPU_TESTS)} (fused_query at its range edges, "
        f"R = 1, an empty delta, zeros filling the list, a dead range, ties "
        f"across an edge; dvbyte_decode on an engine's chain blocks and "
        f"constructed rows, NB = 1 and off a warp's 2 and a CTA's 8, "
        f"B < 64, an "
        f"unaligned base; intersect with empty lists, PAD, a below or above "
        f"b, windows across tiles and past the buffer, 1-9 further lists; "
        f"topk_score at its tile edges and up to 40 segments; retrieval_dot "
        f"at its blocking edges, float32 and bf16, integer rows exactly; "
        f"each against its plain version, reruns): {lines[-1]} "
        f"({time.perf_counter() - t0:.1f} s)")


def unit_rows(g, rows: int, d: int, dev):
    """(rows, d) float32 rows of norm 1 from numpy generator ``g``, on
    ``dev``: the scale of two-tower embeddings."""
    import torch
    x = g.standard_normal((rows, d)).astype(np.float32)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-6)
    return torch.from_numpy(x).to(dev)


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


def concat_lists(lists):
    """Sorted int32 lists on one device -> (their concatenation, the
    (n + 1,) int32 bounds of each), as the kernel backend packs them."""
    import torch
    off = np.cumsum([0] + [int(x.numel()) for x in lists]).astype(np.int32)
    return torch.cat(lists), torch.from_numpy(off).to(lists[0].device)


def term_kernel_parity(eng, rng, names, probs) -> dict:
    """Phase 2 for the term path's per-op kernels, at small sizes and edge
    cases; returns name -> largest absolute difference."""
    import torch
    from repro_torch.core.blockstore import H
    from repro_torch.core.device_index import decode_blocks, gather_chains
    from repro_torch.engine.device_backend import pack_queries
    from repro_torch.kernels.dvbyte_decode.kernel import dvbyte_decode_kernel
    from repro_torch.kernels.intersect.kernel import intersect_kernel
    from repro_torch.kernels.intersect.ref import (PAD, intersect_all_ref,
                                                   intersect_ref)
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
        "empty a": (none, [srt(50, 1, 100)]),
        "empty b": (srt(50, 1, 100), [none]),
        "disjoint": (srt(300, 1, 1000), [srt(300, 2000, 3000)]),
        "PAD entries": (torch.cat([srt(200, 1, 900), pad]),
                        [torch.cat([srt(400, 1, 900), pad[:25]])]),
        "lengths 33 and 61": (srt(100, 1, 300)[:33],
                              [srt(200, 1, 300)[:61]]),
        "overlap 5k/9k": (srt(5000, 1, 40000), [srt(9000, 1, 40000)]),
        "three further lists": (srt(5000, 1, 40000),
                                [srt(n, 1, 40000) for n in (9000, 20000,
                                                            30000)]),
    }
    errs = {"intersect": 0.0}
    for a, lists in cases.values():
        if len(lists) == 1:
            got = (intersect_kernel(a, lists[0]),
                   intersect_kernel(a, lists[0]))
            plain = intersect_ref(a, lists[0])
        else:
            b, off = concat_lists(lists)
            got = intersect_kernel(a, b, off), intersect_kernel(a, b, off)
            plain = intersect_all_ref(a, b, off)
        errs["intersect"] = max(errs["intersect"], exact_and_repeatable(
            "intersect", *got, plain))
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

    def joined(*parts):
        """Segments ``parts`` (docid arrays) run after one another."""
        off = np.cumsum([0] + [len(p) for p in parts]).tolist()
        d = np.concatenate(parts).astype(np.int32)
        return (torch.from_numpy(d).to(dev), torch.from_numpy(
            (g.random(len(d)) * 5).astype(np.float32)).to(dev), off)

    def run(lo, hi, n):
        return np.sort(g.choice(np.arange(lo, hi), size=n, replace=False))

    tcases = {
        "an empty input": (none, torch.zeros(0, device=dev), [0, 0], 300),
        "docid 0 present": (*segments(777, 1, with_zero=True), 777),
        "one segment": (*segments(5000, 1), 5000),
        "four segments over 98,733 docids": (*segments(98_733, 4), 98_733),
        # tile edges: 512 docids a block (2,048 before), and one off each
        **{f"n_docs {n}": (*segments(n, 3), n)
           for n in (511, 512, 513, 1023, 1025, 2047, 2048, 2049)},
        "a segment wholly inside one tile": (
            *joined(run(1, 3000, 900), run(780, 1000, 150),
                    run(1, 3000, 1200)), 3000),
        "an empty segment between full ones": (
            *joined(run(1, 4000, 2000), run(0, 1, 0), run(1, 4000, 1500)),
            4000),
        "docids past n_docs": (*joined(run(1, 1500, 700), run(1, 1500, 900)),
                               1000),
        # a block stages 16 segments a pass
        **{f"{ns} segments": (*segments(20_000, ns), 20_000)
           for ns in (16, 17, 40)},
    }
    errs["topk_score"] = 0.0
    for d, w, off, n in tcases.values():
        ot = torch.tensor(off, dtype=torch.int32, device=dev)
        errs["topk_score"] = max(errs["topk_score"], exact_and_repeatable(
            "topk_score", score_kernel(d, w, n, ot), score_kernel(d, w, n, ot),
            score_ref(d, w, n, off)))
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

    from repro_torch.kernels.retrieval_dot.ops import candidate_scores
    from repro_torch.kernels.retrieval_dot.ref import retrieval_dot_ref
    errs["retrieval_dot"] = 0.0

    def dot_case(label, qt, ct):
        qn, n = qt.shape[0], ct.shape[0]
        first = candidate_scores(qt, ct)
        second = candidate_scores(qt, ct)
        plain = retrieval_dot_ref(qt, ct)
        torch.cuda.synchronize()
        if first.shape != (qn, n) or first.dtype != torch.float32:
            fail(f"retrieval_dot {label}: output {tuple(first.shape)} "
                 f"{first.dtype}")
        if not bit_identical(first, second):
            fail(f"retrieval_dot {label}: a second launch is not "
                 f"bit-identical")
        e = float((first - plain).abs().max()) if n else 0.0
        if e > DENSE_ATOL:
            fail(f"retrieval_dot {label}: max |kernel - plain| {e:.3g} over "
                 f"{DENSE_ATOL}")
        errs["retrieval_dot"] = max(errs["retrieval_dot"], e)

    n_cases = 0
    for qn in (1, 8, 17):
        for d in (30, 64, 256):
            for n in (0, 333, 2048):
                qv, cv = (unit_rows(g, rows, d, dev) for rows in (qn, n))
                for dt in (torch.float32, torch.bfloat16):
                    dot_case(f"q={qn} d={d} n={n} {dt}", qv.to(dt), cv.to(dt))
                    n_cases += 1
    # row counts off the kernel's 2 rows a warp and 16 a block; widths off
    # its 256-float pass; C's base one row and one float (unaligned) along
    extra = [(1, 1, 256), (1, 7, 256), (1, 4099, 256), (8, 4099, 256),
             (3, 7, 1000), (17, 4099, 1000), (2, 333, 1028)]
    for qn, n, d in extra:
        dot_case(f"q={qn} n={n} d={d}", unit_rows(g, qn, d, dev),
                 unit_rows(g, n, d, dev))
    for qn, n in ((8, 333), (1, 4099)):
        qv, flat = unit_rows(g, qn, 256, dev), unit_rows(g, n + 1, 256, dev)
        dot_case(f"q={qn} n={n}, C at a one-row offset", qv, flat[1:])
        dot_case(f"q={qn} n={n}, C at a one-float offset", qv,
                 flat.flatten()[1:1 + n * 256].view(n, 256))
    say(f"[parity] retrieval_dot: kernel within {DENSE_ATOL} of the plain "
        f"version (max |diff| {errs['retrieval_dot']:.3g}), rerun "
        f"bit-identical, on {n_cases + len(extra) + 4} cases: q in (1, 8, "
        f"17), d in (30, 64, 256), n in (0, 333, 2048), float32 and bf16 "
        f"unit rows; (q, n, d) in {extra}; C at a one-row and a one-float "
        f"offset (q, n) in ((8, 333), (1, 4099)), d = 256")
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
    # each mode's batch on the host's clock, and the device time of its
    # two decode launches
    F = eng.index.F
    shares = {}
    for mode, qs in zip(MODES, groups):
        _live, qt, qm, _caps = pack_queries(eng, res, qs, mode)
        inputs = [gather_chains(img, qt, qm, mb)
                  for img, mb in zip(res.images, res.max_blocks)]
        dec = [device_ms_in_turns(lambda x=x: dvbyte_decode_kernel(*x, F))
               for x in inputs]
        batch = host_ms(lambda: split.execute_many(qs), 5)
        shares[mode] = sum(t["ms"] for t in dec) / batch
        say(f"[time] split path {mode}: a batch of 32 through "
            f"DeviceBackend(use_fused=False) {batch:.4f} ms (host clock "
            f"ending in torch.cuda.synchronize(), median of 5); its decode "
            f"launches (frozen NB={inputs[0][0].shape[0]}, delta "
            f"NB={inputs[1][0].shape[0]}) {dec[0]['ms']:.4f} + "
            f"{dec[1]['ms']:.4f} ms device time, {shares[mode]:.4f} of the "
            f"batch")
        if mode == MODES[1]:
            blocks, start, end = inputs[0]
    # the decode kernel at the frozen image's shapes: NB = Q * T * cap
    err = exact_and_repeatable(
        "dvbyte_decode", dvbyte_decode_kernel(blocks, start, end, F),
        dvbyte_decode_kernel(blocks, start, end, F),
        decode_blocks(blocks, start, end, F))
    t = device_ms_in_turns(lambda: dvbyte_decode_kernel(blocks, start, end,
                                                        F))
    ms = t["ms"]
    plain_ms = cuda_ms(lambda: decode_blocks(blocks, start, end, F),
                       REPS // 4, warm=1)
    NB, B = blocks.shape
    bound, every, busy = decode_bound(start, end, B)
    say(f"[time] dvbyte_decode: NB={NB} (Q={qt.shape[0]} T={qt.shape[1]} "
        f"cap={res.max_blocks[0]}) B={B}, {busy} of them non-empty: kernel "
        f"{ms:.4f} ms {turns_text(t)}, plain version {plain_ms:.4f} ms "
        f"(median of {REPS // 4}); bound {bound:.4f} ms ({8 * NB + B * busy} "
        f"bytes in: the bounds of every block, the bytes of the non-empty "
        f"ones; {9 * NB * B} out), kernel at {bound / ms:.3f} of it; "
        f"counting every block's bytes read, {every:.4f} ms; parity exact, "
        f"rerun bit-identical")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "nonempty_rows": busy,
            "bound_ms_every_row": every, "decode_share": shares}


def decode_bound(start, end, B: int) -> tuple[float, float, int]:
    """``dvbyte_decode``'s least time in ms for these bounds: the 8 bytes
    of ``start``/``end`` of every block, the B bytes only of the blocks
    with end > start (the kernel reads no others), 9 bytes written per
    byte position; the same with every block's bytes read; and the count
    of non-empty blocks."""
    NB = start.numel()
    busy = int((end.clamp(max=B) > start.clamp(min=0)).sum())
    out = 9 * NB * B
    return (bound_ms(8 * NB + B * busy + out),
            bound_ms(8 * NB + B * NB + out), busy)


def dot_bound(q: int, n: int, d: int) -> tuple[float, str]:
    """retrieval_dot's least time in ms and what bounds it: Q and C read
    once and the (q, n) float32 scores written once, over 3.35 TB/s, or
    2·q·n·d float32 operations over 67 TFLOP/s."""
    t_bytes = 4 * (q * d + n * d + q * n) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * q * n * d / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_dot(label: str, u, v) -> dict:
    """``retrieval_dot`` at one shape: the kernel against ``torch.mm`` (the
    library call) in turns, and its plain version."""
    import torch
    from repro_torch.kernels.retrieval_dot.kernel import retrieval_dot_kernel
    from repro_torch.kernels.retrieval_dot.ref import retrieval_dot_ref
    (q, d), n = u.shape, v.shape[0]
    t = device_ms_in_turns(lambda: retrieval_dot_kernel(u, v),
                           lambda: torch.mm(u, v.T))
    ms, lib = t["ms"], t["library_ms"]
    plain = cuda_ms(lambda: retrieval_dot_ref(u, v), REPS)
    bound, by = dot_bound(q, n, d)
    say(f"[time] retrieval_dot {label}: q={q} n={n} d={d}: kernel {ms:.4f} "
        f"ms, torch.mm {lib:.4f} ms {turns_text(t, 'torch.mm')}; plain "
        f"version {plain:.4f} ms (median of {REPS}); bound {bound:.4f} ms "
        f"({by}; {4 * (q * d + n * d + q * n)} bytes, {2 * q * n * d} "
        f"operations); kernel at {bound / ms:.3f} of the bound, torch.mm at "
        f"{bound / lib:.3f}")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
            "bound_by": by, "shape": [q, n, d]}


def seeded_dot(label: str, n: int, d: int, dev) -> tuple[float, dict]:
    """``retrieval_dot`` of a seeded unit user row against ``n`` seeded unit
    candidate rows of width ``d``, made on the card: within ``DENSE_ATOL``
    of its plain version, rerun bit-identical, then timed.  Returns (max
    |kernel - plain|, the :func:`time_dot` row)."""
    import torch
    from repro_torch.kernels.retrieval_dot.ops import candidate_scores
    from repro_torch.kernels.retrieval_dot.ref import retrieval_dot_ref
    cq = unit_rows(np.random.default_rng(17), 1, d, dev)
    cc = torch.nn.functional.normalize(torch.randn(
        n, d, device=dev,
        generator=torch.Generator(device=dev).manual_seed(17)), dim=1)
    first = candidate_scores(cq, cc)
    second = candidate_scores(cq, cc)
    plain = retrieval_dot_ref(cq, cc)
    torch.cuda.synchronize()
    if not bit_identical(first, second):
        fail(f"retrieval_dot {label}: a second launch is not bit-identical")
    e = float((first - plain).abs().max())
    if e > DENSE_ATOL:
        fail(f"retrieval_dot {label}: max |kernel - plain| {e:.3g} over "
             f"{DENSE_ATOL}")
    del first, second, plain
    return e, time_dot(f"{label} (max |diff| {e:.3g}, rerun bit-identical)",
                       cq, cc)


def hybrid_phase(eng, corpus, names, probs, rng) -> dict:
    """Hybrid retrieval on the Const engine: stage 1, conjunctive candidates
    from the live index through ``Engine.execute_many`` (the fused kernel);
    stage 2, the full-width two-tower model and the ``retrieval_dot``
    kernel over each query's candidates.  Two rounds of the same 32
    queries, with one fresh document per query ingested between them."""
    import torch
    from repro_torch.configs.two_tower_retrieval import CFG, RETRIEVAL_CAND
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    from repro_torch.kernels.retrieval_dot import kernel as rd_kernel
    from repro_torch.kernels.retrieval_dot.ops import candidate_scores
    from repro_torch.kernels.retrieval_dot.ref import retrieval_dot_ref
    from repro_torch.models.recsys import TwoTower
    t_phase = time.perf_counter()
    dev = eng.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = TwoTower(CFG, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(13))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tables = (model.user_table.weight, model.item_table.weight)
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    say(f"[hybrid] TwoTower {CFG.name} on {dev}: tables {table_bytes} bytes "
        f"({CFG.n_users_vocab:,} + {CFG.n_items:,} rows x {CFG.embed_dim} "
        f"{str(CFG.dtype).replace('torch.', '')}), towers "
        f"{(CFG.embed_dim, *CFG.tower_mlp)}; init {init_s:.3f} s on the "
        f"device from a seeded generator there; allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    queries = zipf_queries(rng, names, probs, eng, 32, "conjunctive")
    feats = [rng.integers(0, CFG.n_users_vocab, CFG.n_user_feats)
             for _ in queries]
    ones = torch.ones((1, CFG.n_user_feats), device=dev)

    def stage2(qi, cands):
        """(u, v, scores, top docids, top scores) of query ``qi``."""
        u = model.user_embedding({
            "user_feats": torch.from_numpy(feats[qi][None]).to(dev),
            "user_mask": ones})
        ids = torch.from_numpy(np.asarray(cands, np.int64)).to(dev)
        v = model.item_embedding(ids)
        s = candidate_scores(u, v)[0]
        top = torch.sort(s, descending=True, stable=True).indices[:TOP]
        return u, v, s, ids[top], s[top]

    rd_kernel.launches = 0          # counts from here are the hybrid path's
    fused_before = fq_kernel.launches
    kept, sizes = [], {}
    with torch.inference_mode():
        for rnd in (0, 1):
            res = eng.execute_many(queries)
            if any(r.backend != "device" for r in res):
                fail("a hybrid stage-1 query was not routed to the device "
                     "backend")
            check_against_host(eng, res, queries, f"hybrid round {rnd}")
            for qi, r in enumerate(res):
                if len(r.docids) == 0:
                    continue
                if int(r.docids.max()) >= CFG.n_items:
                    fail(f"hybrid: docid {int(r.docids.max())} past the "
                         f"item table ({CFG.n_items} rows)")
                kept.append((rnd, qi, r.docids, *stage2(qi, r.docids)))
            torch.cuda.synchronize()
            n_c = [len(r.docids) for r in res]
            sizes[rnd] = max(n_c)
            say(f"[hybrid] round {rnd}: {len(queries)} conjunctive queries "
                f"through Engine.execute_many (device backend), candidate "
                f"sets equal the host backend's; {sum(c > 0 for c in n_c)} "
                f"with candidates (min {min(n_c)}, median "
                f"{int(np.median(n_c))}, max {max(n_c)}), each scored by the "
                f"two-tower model, top {TOP} by (score desc, docid asc)")
            if rnd == 0:
                # one fresh document per query: its terms and the next
                # document of the stream (the generator goes on from where
                # the Const path's stream stopped)
                corpus.spec = corpus.spec.scaled(len(queries))
                fresh = [list(q.terms) + [names[i] for i in ids.tolist()]
                         for q, ids in zip(queries, corpus.doc_term_ids())]
                new_ids = eng.add_documents(fresh)
            else:
                missing = [d for d, r in zip(new_ids, res)
                           if d not in set(r.docids.tolist())]
                if missing:
                    fail(f"hybrid round 1: fresh docids {missing} are not "
                         f"among their queries' candidates")
                say(f"[hybrid] round 1: every fresh docid ({len(new_ids)}, "
                    f"{new_ids[0]}..{new_ids[-1]}) is among its query's "
                    f"candidates: immediate access through the delta")
    torch.cuda.synchronize()
    launches = rd_kernel.launches
    fused = fq_kernel.launches - fused_before
    if launches != len(kept):
        fail(f"retrieval_dot launches on the hybrid path: {launches}, "
             f"expected one per query with candidates = {len(kept)}")
    if fused != 2:
        fail(f"fused_query launches on the hybrid path: {fused}, expected "
             f"one per round = 2")

    # ---- kernel against the plain version, reruns -----------------------
    err = 0.0
    with torch.inference_mode():
        for rnd, qi, cands, u, v, s, top_d, top_s in kept:
            plain = retrieval_dot_ref(u, v)[0]
            again = candidate_scores(u, v)[0]
            torch.cuda.synchronize()
            if not bit_identical(s, again):
                fail(f"hybrid round {rnd} query {qi}: a second "
                     f"retrieval_dot launch is not bit-identical")
            e = float((s - plain).abs().max())
            if e > DENSE_ATOL:
                fail(f"hybrid round {rnd} query {qi}: max |kernel - plain| "
                     f"{e:.3g} over {DENSE_ATOL}")
            err = max(err, e)
            top = torch.sort(plain, descending=True, stable=True).indices[:TOP]
            pd = torch.from_numpy(np.asarray(cands, np.int64)).to(
                plain.device)[top]
            if not ranking_agrees(top_d.cpu().numpy(), top_s.cpu().numpy(),
                                  pd.cpu().numpy(), plain[top].cpu().numpy(),
                                  0.0, DENSE_ATOL):
                fail(f"hybrid round {rnd} query {qi}: top {TOP} "
                     f"{top_d.tolist()} differs from the plain version's "
                     f"{pd.tolist()}")
    say(f"[hybrid] retrieval_dot launches {launches} = queries with "
        f"candidates over both rounds; fused_query launches {fused}; kernel "
        f"within {DENSE_ATOL} of the plain version (max |diff| {err:.3g}), "
        f"top {TOP} equal up to ties within {DENSE_ATOL}, reruns "
        f"bit-identical")

    # ---- times ------------------------------------------------------------
    with torch.inference_mode():
        stage1 = cuda_ms(lambda: eng.execute_many(queries), REPS)
        per_query = [cuda_ms(lambda: stage2(qi, c), 5, warm=1)
                     for rnd, qi, c, *_ in kept if rnd == 1]
        say(f"[time] hybrid stage 1: {stage1:.4f} ms per batch of "
            f"{len(queries)} conjunctive queries (median of {REPS}); stage 2 "
            f"per query (user tower, item tower over the candidates, "
            f"retrieval_dot, top {TOP}): median {np.median(per_query):.4f} "
            f"ms, max {max(per_query):.4f} ms over round 1's "
            f"{len(per_query)} queries with candidates (medians of 5)")
        big = max(kept, key=lambda k: len(k[2]))
        path = time_dot(f"at the path's largest candidate set (round "
                        f"{big[0]})", big[3], big[4])
        del kept, big
        e, cand = seeded_dot("at retrieval_cand", RETRIEVAL_CAND,
                             CFG.embed_dim, dev)
        err = max(err, e)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[hybrid] phase {time.perf_counter() - t_phase:.3f} s")
    return dict(path, launches=launches, max_abs_err=err,
                retrieval_cand=cand)


def const_engine(n_docs: int, rng, on_delta=None, on_freeze=None) -> dict:
    """The Const main path's engine: the first ``n_docs`` documents of the
    WSJ1-like stream through ``QueryService.ingest_batch`` in batches of
    256, ``collate_now()`` at 90 %, then 8 deletes per batch.  ``on_delta``
    (eng, rng, names, probs), if given, runs once after the first
    post-freeze batch, before any delete; its result is returned as
    ``split``.  ``on_freeze`` (eng, names, probs), if given, runs right
    after ``collate_now()``; its result is returned as ``frozen``.  The
    index's bytes per posting at ``TRIANGLE_DOCS`` documents, Path A's
    count, are returned as ``bpp_at``."""
    import torch
    from repro_torch.data.corpus import WSJ1_LIKE, SyntheticCorpus, term_table
    from repro_torch.engine import Engine
    from repro_torch.serve import QueryService

    spec = WSJ1_LIKE.scaled(n_docs)
    corpus = SyntheticCorpus(spec)
    names = term_table(spec.universe)
    probs = 1.0 / np.arange(1, spec.universe + 1) ** spec.zipf_s
    probs /= probs.sum()
    split = frozen = None
    name_len = np.fromiter((len(s) for s in names), np.int64,
                           count=len(names))
    eng = Engine(B=64, growth="const", delta_compact_frac=None)
    svc = QueryService(eng, max_batch=32, cache_size=0)
    freeze_at = int(n_docs * 0.9)
    text_bytes = 0
    dead: set[int] = set()
    batch: list[list[str]] = []
    t_gen = time.perf_counter()
    collate_s = bpp_at = None
    for ids in corpus.doc_term_ids():
        batch.append([names[i] for i in ids.tolist()])
        text_bytes += int(name_len[ids].sum()) + len(ids)
        done = eng.index.num_docs + len(batch)
        if len(batch) == 256 or done == freeze_at or done == n_docs:
            svc.ingest_batch(batch)
            batch.clear()
            if eng.index.num_docs == TRIANGLE_DOCS:
                bpp_at = eng.index.bytes_per_posting()
            if eng.index.num_docs == freeze_at:
                t0 = time.perf_counter()
                eng.collate_now()
                torch.cuda.synchronize()
                collate_s = time.perf_counter() - t0
                if on_freeze is not None:
                    frozen = on_freeze(eng, names, probs)
            elif eng.index.num_docs > freeze_at:
                if on_delta is not None and split is None:
                    split = on_delta(eng, rng, names, probs)
                for _ in range(8):          # tombstone on the way
                    d = int(rng.integers(1, eng.index.num_docs + 1))
                    if d not in dead:
                        dead.add(d)
                        svc.delete(d)
    return dict(eng=eng, svc=svc, corpus=corpus, names=names, probs=probs,
                split=split, frozen=frozen, freeze_at=freeze_at,
                collate_s=collate_s,
                bpp_at=bpp_at,
                text_bytes=text_bytes, wall_s=time.perf_counter() - t_gen)


def batch_steps(eng, qs) -> dict:
    """One engine batch cut into its steps, on the host's clock, medians of
    ``REPS`` after two warm-ups.  ``Engine.execute_many`` runs as it is,
    with the ``pack_queries``, ``prepare`` and kernel wrapper calls that
    ``fused_execute`` makes each wrapped to synchronize the card before and
    after and read the clock; "copy back and the rest" is the whole
    wrapped call less those three (the copy of the output, the host's
    ``flatnonzero`` or filtering, and the routing around them).  "end to
    end" is the call unwrapped, with one synchronize after it."""
    from unittest import mock

    import torch
    from repro_torch.engine import device_backend
    from repro_torch.kernels.fused_query import ops
    timed = ("pack_queries", "prepare", "kernel")
    steps = {k: [] for k in timed + ("copy back and the rest",
                                     "end to end")}

    def clocked(label, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            steps[label].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def whole():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.execute_many(qs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with mock.patch.object(device_backend, "pack_queries",
                           clocked("pack_queries",
                                   device_backend.pack_queries)), \
            mock.patch.object(ops, "prepare",
                              clocked("prepare", ops.prepare)), \
            mock.patch.object(ops, "fused_query_kernel",
                              clocked("kernel", ops.fused_query_kernel)):
        for i in range(REPS + 2):
            total = whole()
            if any(len(steps[k]) != i + 1 for k in timed):
                fail("an engine batch did not make one pack_queries, "
                     "prepare and kernel call")
            steps["copy back and the rest"].append(
                total - sum(steps[k][-1] for k in timed))
    for _ in range(REPS + 2):
        steps["end to end"].append(whole())
    return {k: float(np.median(v[2:])) for k, v in steps.items()}


def batches_digest(batches: dict) -> str:
    """A CRC-32 of the prepared batches' slot metadata, printed so that two
    runs can be seen to time the same batches."""
    crc = 0
    for args in batches.values():
        for part in args["parts"]:
            for t in part[1:]:
                crc = zlib.crc32(t.cpu().numpy().tobytes(), crc)
    return f"{crc:08x}"


def fused_only(path: Path, n_docs: int) -> None:
    """``--fused-only``: the fused kernel alone on the main path's first
    batch of 32 queries per mode.  The prepared batches are read from
    ``path`` (``torch.save``); where it does not exist, the Const engine is
    built as the main path builds it (``n_docs`` documents, a delta,
    deletes, and the split path's draws from the seed without the split
    path), so that the batches are the main path's own, and they are
    written there first.  Each mode's kernel is timed
    (:func:`device_ms_in_turns`) before any check, then held against its
    plain version, so that a partial build still prints its times."""
    import torch
    if not path.exists():
        rng = np.random.default_rng(2024)
        c = const_engine(n_docs, rng, on_delta=lambda eng, rng, names, probs:
                         [zipf_queries(rng, names, probs, eng, 32, mode)
                          for mode in MODES])
        eng = c["eng"]
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({mode: prepared_batch(eng, zipf_queries(
            rng, c["names"], c["probs"], eng, 32, mode), mode)
            for mode in MODES}, path)
        say(f"[fused-only] {eng.index.num_docs} documents, "
            f"{len(eng.index.tombstones)} deletes; batches written to {path}")
        del c, eng
        gc.collect()
    from repro_torch.kernels.fused_query.kernel import fused_query_kernel
    batches = torch.load(path, map_location="cuda")
    say(f"[fused-only] batches {path.name}, digest "
        f"{batches_digest(batches)}")
    for mode, args in batches.items():
        t = device_ms_in_turns(
            lambda: fused_query_kernel(mode=mode, k=K, **args))
        bound, _by = launch_bound(args, mode)
        say(f"[time] fused_query {mode} ({path.name}): "
            f"Q={args['nterms'].shape[0]} "
            f"PB={[p[0].shape[1] for p in args['parts']]} cap={args['cap']}: "
            f"kernel {t['ms']:.4f} ms {turns_text(t)}; bound {bound:.4f} ms")
    for mode, args in batches.items():
        e = kernel_vs_plain(args, mode)
        say(f"[parity] fused_query {mode} ({path.name}): kernel == plain "
            f"version, rerun bit-identical, max |score diff| {e:.3g}")


class _Captured(Exception):
    """Stops :func:`const_engine` once ``on_delta`` has what it needs."""


def split_decode_input(n_docs: int):
    """Path B's timed decode input, (blocks, start, end, F): the frozen
    image's chain blocks for the split path's ranked batch, from a Const
    engine built as phase 3 builds it (the same documents and draws), the
    stream stopped right after."""
    from repro_torch.core.device_index import gather_chains
    from repro_torch.engine.device_backend import pack_queries

    def capture(eng, rng, names, probs):
        groups = [zipf_queries(rng, names, probs, eng, 32, mode)
                  for mode in MODES]
        res = eng.resident
        res.refresh()
        _live, qt, qm, _caps = pack_queries(eng, res, groups[1], MODES[1])
        raise _Captured(*gather_chains(res.images[0], qt, qm,
                                       res.max_blocks[0]), eng.index.F)

    try:
        const_engine(n_docs, np.random.default_rng(2024), on_delta=capture)
    except _Captured as c:
        return c.args
    fail("the stream ended before the split path's batch")


def term_ab(folder: Path, n_docs: int) -> None:
    """``--term-ab DIR``: the ``dvbyte_decode`` and ``intersect`` kernels
    of another revision (``DIR/dvbyte_decode.cu`` and ``DIR/intersect.cu``,
    each with the one-list C interface of that revision) against this
    checkout's, on one card, in turns (other, this, this, other) on the
    same inputs: Path B's frozen-image decode input
    (:func:`split_decode_input`, saved in ``DIR/inputs.pt`` the first time)
    and the seeded intersect case at Path A's round-2 shape
    (:func:`intersect_inputs`) with one and three further lists, where the
    other revision makes one launch per list and ANDs the flags as its
    kernel backend did.  Both revisions' sources build together under
    other library names.  Times first, then both are held against the
    plain versions; a CRC of the inputs is printed.  Drives no path."""
    import ctypes

    import torch
    from repro_torch.core.device_index import decode_blocks
    from repro_torch.kernels import build
    from repro_torch.kernels.dvbyte_decode.kernel import dvbyte_decode_kernel
    from repro_torch.kernels.intersect.kernel import intersect_kernel
    from repro_torch.kernels.intersect.ref import intersect_all_ref
    libs = build.build_sources({
        "dvbyte_decode": build.SOURCES["dvbyte_decode"],
        "intersect": build.SOURCES["intersect"],
        "other_dvbyte_decode": folder / "dvbyte_decode.cu",
        "other_intersect": folder / "intersect.cu"})
    for tag, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {tag}: {line.strip()}")
    p, i = ctypes.c_void_p, ctypes.c_int
    old_dv = ctypes.CDLL(str(libs["other_dvbyte_decode"])).dv_launch
    old_dv.argtypes, old_dv.restype = [p, p, p, i, i, i, p, p, p, p], i
    old_ix = ctypes.CDLL(str(libs["other_intersect"])).ix_launch
    old_ix.argtypes, old_ix.restype = [p, i, p, i, p, p], i
    stream = torch.cuda.current_stream().cuda_stream

    def other_decode(blocks, start, end, F):
        NB, B = blocks.shape
        out = (torch.empty((NB, B), dtype=torch.int32, device=blocks.device),
               torch.empty((NB, B), dtype=torch.int32, device=blocks.device),
               torch.empty((NB, B), dtype=torch.bool, device=blocks.device))
        rc = old_dv(blocks.data_ptr(), start.data_ptr(), end.data_ptr(), NB,
                    B, F, *(t.data_ptr() for t in out), stream)
        if rc:
            fail(f"the other revision's dvbyte_decode: CUDA error {rc}")
        return out

    def other_intersect(a, lists):
        flags = None
        for b in lists:
            hit = torch.empty(a.shape, dtype=torch.bool, device=a.device)
            rc = old_ix(a.data_ptr(), a.numel(), b.data_ptr(), b.numel(),
                        hit.data_ptr(), stream)
            if rc:
                fail(f"the other revision's intersect: CUDA error {rc}")
            flags = hit if flags is None else flags.__iand__(hit)
        return flags

    pt = folder / "inputs.pt"
    if not pt.exists():
        blocks, start, end, F = split_decode_input(n_docs)
        torch.save({"blocks": blocks, "start": start, "end": end, "F": F},
                   pt)
        say(f"[term-ab] Path B's decode input written to {pt}")
        gc.collect()
    saved = torch.load(pt, map_location="cuda")
    blocks, start, end, F = (saved[k] for k in ("blocks", "start", "end",
                                                 "F"))
    a, lists = intersect_inputs(blocks.device)
    crc = 0
    for t in (blocks, start, end, a, *lists):
        crc = zlib.crc32(t.cpu().numpy().tobytes(), crc)
    NB, B = blocks.shape
    bound, every, busy = decode_bound(start, end, B)
    say(f"[term-ab] inputs {pt.name}: decode NB={NB} B={B} ({busy} "
        f"non-empty) F={F}; intersect |a|={a.numel()}, lists "
        f"{[int(x.numel()) for x in lists]}; digest {crc:08x}")
    t = device_ms_in_turns(lambda: other_decode(blocks, start, end, F),
                           lambda: dvbyte_decode_kernel(blocks, start, end,
                                                        F))
    say(f"[time] dvbyte_decode A/B: other revision {t['ms']:.4f} ms, this "
        f"checkout {t['library_ms']:.4f} ms (turns other, this, this, "
        f"other: {' / '.join(f'{x:.4f}' for x in t['turns'])}; device ms "
        f"per call in runs of {LAUNCHES}, medians of {RUNS} runs a turn); "
        f"bound {bound:.4f} ms ({every:.4f} counting every block's bytes "
        f"read): this checkout at {bound / t['library_ms']:.3f} of it")
    for n in (1, 3):
        b, off = concat_lists(lists[:n])
        t = device_ms_in_turns(lambda: other_intersect(a, lists[:n]),
                               lambda: intersect_kernel(a, b, off))
        bound = bound_ms(4 * a.numel() + 4 * b.numel() + a.numel())
        say(f"[time] intersect A/B, {n} further list(s): other revision "
            f"({n} launch(es){' and the ANDs' if n > 1 else ''}) "
            f"{t['ms']:.4f} ms, this checkout (one launch) "
            f"{t['library_ms']:.4f} ms (turns other, this, this, other: "
            f"{' / '.join(f'{x:.4f}' for x in t['turns'])}); bound "
            f"{bound:.6f} ms")
    plain = decode_blocks(blocks, start, end, F)
    exact_and_repeatable("dvbyte_decode (other revision)",
                         other_decode(blocks, start, end, F),
                         other_decode(blocks, start, end, F), plain)
    exact_and_repeatable("dvbyte_decode",
                         dvbyte_decode_kernel(blocks, start, end, F),
                         dvbyte_decode_kernel(blocks, start, end, F), plain)
    for n in (1, 3):
        b, off = concat_lists(lists[:n])
        plain = intersect_all_ref(a, b, off)
        exact_and_repeatable("intersect (other revision)",
                             other_intersect(a, lists[:n]),
                             other_intersect(a, lists[:n]), plain)
        exact_and_repeatable("intersect", intersect_kernel(a, b, off),
                             intersect_kernel(a, b, off), plain)
    say("[parity] term-ab: both revisions' dvbyte_decode and intersect == "
        "plain version bit for bit, reruns bit-identical")


def main_path(n_docs: int) -> dict:
    import inspect

    import torch
    from repro_torch.engine import Engine
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    from repro_torch.kernels.fused_query.kernel import fused_query_kernel
    from repro_torch.kernels.fused_query.ref import fused_tile

    fq_kernel.launches = 0              # counts from here are the path's
    rng = np.random.default_rng(2024)
    c = const_engine(n_docs, rng, on_delta=split_path,
                     on_freeze=lambda eng, names, probs: capture_frozen(
                         eng, names, probs, Path(tempfile.mkdtemp(
                             prefix="mesh-m2-"))))
    eng, svc, corpus = c["eng"], c["svc"], c["corpus"]
    names, probs, split = c["names"], c["probs"], c["split"]
    freeze_at, collate_s = c["freeze_at"], c["collate_s"]
    text_bytes, wall_s = c["text_bytes"], c["wall_s"]
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
    err, ms, plain_ms, bound, e2e, batches = 0.0, {}, {}, {}, {}, {}
    bound_by = "bytes"
    for qs, mode in zip(groups[:3], MODES):
        args = batches[mode] = prepared_batch(eng, qs, mode)
        err = max(err, kernel_vs_plain(args, mode))
        t = device_ms_in_turns(
            lambda: fused_query_kernel(mode=mode, k=K, **args))
        ms[mode] = t["ms"]
        plain_ms[mode] = cuda_ms(lambda: fused_tile(mode=mode, k=K, **args),
                                 REPS // 4, warm=1)
        bound[mode], by = launch_bound(args, mode)
        if by != "bytes":
            bound_by = by
        steps = batch_steps(eng, qs)
        e2e[mode] = steps.pop("end to end")
        parts = args["parts"]
        say(f"[time] {mode}: Q={args['nterms'].shape[0]} "
            f"PB={[p[0].shape[1] for p in parts]} cap={args['cap']}: "
            f"kernel {ms[mode]:.4f} ms {turns_text(t)}, plain version "
            f"{plain_ms[mode]:.4f} ms (median of {REPS // 4}), bound "
            f"{bound[mode]:.4f} ms; engine batch end to end "
            f"{e2e[mode]:.4f} ms; the engine's own steps, each with a "
            f"synchronize around it: "
            + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
            + f" ms (host clock, medians of {REPS})")
    say(f"[time] the batches timed above: digest {batches_digest(batches)}")
    mean = lambda d: float(np.mean([d[m] for m in MODES]))   # noqa: E731
    if split is None:
        fail("the stream ended before the split path ran")
    if c["bpp_at"] is None:
        fail(f"the Const stream never reached Path A's {TRIANGLE_DOCS} "
             f"documents")
    const_index = (c["bpp_at"], TRIANGLE_DOCS)
    planner_launches = planner_phase(eng, names, probs)
    tier = tier_phase(eng, svc, corpus, names, groups[:3])
    hybrid = hybrid_phase(eng, corpus, names, probs, rng)
    return {"launches": launches, "max_abs_err": err, "ms": mean(ms),
            "plain_ms": mean(plain_ms), "bound_ms": mean(bound),
            "bound_by": bound_by, "tier_phase_launches": tier["launches"],
            "planner_phase_launches": planner_launches,
            "library_ms": None, "split": split, "hybrid": hybrid,
            "index": const_index, "e2e": e2e,
            "ingest_rate": st.num_docs / ingest_s, "frozen": c["frozen"]}


def tier_only(n_docs: int) -> None:
    """``--tier-only``: the Const engine as the main path builds it,
    without the split path, then the tier phase on its first batch of 32
    queries per mode."""
    rng = np.random.default_rng(2024)
    c = const_engine(n_docs, rng)
    eng = c["eng"]
    st = eng.stats()
    say(f"[ingest] {st.num_docs} docs, {st.num_postings} postings, "
        f"{len(eng.index.tombstones)} deletes in {st.ingest_time_s:.3f} s "
        f"of add_documents ({c['wall_s']:.3f} s with generation)")
    batches = [zipf_queries(rng, c["names"], c["probs"], eng, 32, mode)
               for mode in MODES]
    tier_phase(eng, c["svc"], c["corpus"], c["names"], batches)


# --------------------------------------------------------------------------
# phase 3, continued: the planner's measured crossover and auto-collation
# --------------------------------------------------------------------------

CROSSOVER_BATCHES = (1, 8, 32)  # (a): batch sizes of the sweep, nested
CROSSOVER_RUNS = 3              # (a): timed runs a cell after one warm-up
CROSSOVER_SEED = 3030           # (a): its own queries, so that the later
                                # phases draw what they drew before it
AUTO_FRAC = 0.25                # (b): Engine(auto_collate_delta_frac=)
AUTO_DOCS = 2_048               # (b): WSJ1-like documents, a freeze at half
AUTO_CHUNK = 128                # (b): documents ingested between batches
PLANNER_DOCS = 8_192            # --planner-only: the Const stream's cut


def timed_batch(eng, qs) -> tuple[float, list]:
    """µs per query of one ``Engine.execute_many`` over ``qs`` on the
    host's clock, ending in a synchronize, and its results."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.execute_many(qs)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / len(qs), res


def crossover_route(eng, q, batch: int, device_mb, kernel_mb) -> str:
    """The backend the planner's rules give an unforced query of a swept
    mode on a device-capable engine without a tier, from the table's
    thresholds (rule 3) and else the candidate volume (rule 4)."""
    from repro_torch.engine import PlannerConfig
    if device_mb is not None and batch >= device_mb:
        return "device"
    if kernel_mb is not None and batch >= kernel_mb:
        return "kernel"
    fts = [eng._fts[t] for t in map(eng.term_id, q.terms) if t is not None]
    fts = [f for f in fts if f > 0]
    if not fts:
        return "host"
    volume = min(fts) if q.mode == "conjunctive" else sum(fts)
    return ("device" if volume >= PlannerConfig().kernel_min_postings
            else "host")


def crossover_phase(eng, names, probs, card: str) -> int:
    """(a) On a Const engine without a tier: each mode's Zipf queries
    timed through ``device`` and ``kernel`` at batches of 1, 8 and 32
    (nested: each the first queries of the next), one warm-up and the
    median of ``CROSSOVER_RUNS``, and through ``host`` one query at a time,
    once each: the host backend answers a batch query by query and keeps
    nothing between them, so its µs per query at a batch is the mean of
    the batch's queries (70-140 ms a query at the Const path's 73,728
    documents on an H100 host: a warm-up and three runs of each host
    batch would take about a minute).  The table
    ``CrossoverTable.from_rows`` derives from those rows; then each batch
    goes unforced under ``PlannerConfig(crossover=table)``: every query
    on the backend the thresholds give, one ``fused_query`` launch per
    (mode, k) group sent to ``device`` or ``kernel``, every answer the
    host's.  The engine's planner is put back.  Returns the routed
    batches' launches."""
    from repro_torch.engine import (CrossoverTable, Planner, PlannerConfig,
                                    Query)
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    if not eng.device_capable or eng.static_tier() is not None:
        fail("the crossover phase wants a Const engine without a tier")
    rng = np.random.default_rng(CROSSOVER_SEED)
    size = eng.index.num_docs
    rows, queries, host = [], {}, {}
    for mode in MODES:
        queries[mode] = zipf_queries(rng, names, probs, eng,
                                     max(CROSSOVER_BATCHES), mode)
        alone = []
        for q in queries[mode]:
            hq = Query(terms=q.terms, mode=mode, k=q.k, backend="host")
            us, res = timed_batch(eng, [hq])
            alone.append(us)
            host[hq] = res[0]
        for backend in ("host", "device", "kernel"):
            us = []
            for b in CROSSOVER_BATCHES:
                if backend == "host":
                    us.append(float(np.mean(alone[:b])))
                else:
                    qs = [Query(terms=q.terms, mode=mode, k=q.k,
                                backend=backend) for q in queries[mode][:b]]
                    timed_batch(eng, qs)                 # the warm-up
                    us.append(float(np.median(
                        [timed_batch(eng, qs)[0]
                         for _ in range(CROSSOVER_RUNS)])))
                rows.append({"workload": mode, "backend": backend,
                             "size": size, "batch": b,
                             "us_per_query": us[-1]})
            how = ("each query once, alone; the mean of the batch's"
                   if backend == "host" else
                   f"median of {CROSSOVER_RUNS} after a warm-up")
            say(f"[crossover] {mode} {backend}: "
                + ", ".join(f"batch {b} {u:.1f}"
                            for b, u in zip(CROSSOVER_BATCHES, us))
                + f" µs/query (host clock, {how}; one collection size, "
                  f"{size} docs; {card})")
    table = CrossoverTable.from_rows(rows)
    say(f"[crossover] rows {json.dumps(rows)}")
    for mode in MODES:
        say(f"[crossover] {mode}: device from batch "
            f"{table.min_batch_for(mode, 'device')}, kernel from batch "
            f"{table.min_batch_for(mode, 'kernel')} (None: never beat the "
            f"host; {card})")
    saved = eng.planner
    eng.planner = Planner(PlannerConfig(crossover=table))
    launched = 0
    for mode in MODES:
        dev = table.min_batch_for(mode, "device")
        ker = table.min_batch_for(mode, "kernel")
        for b in CROSSOVER_BATCHES:
            qs = [Query(terms=q.terms, mode=mode, k=q.k)
                  for q in queries[mode][:b]]
            fq_kernel.launches = 0
            _, res = timed_batch(eng, qs)
            got = fq_kernel.launches
            routes = [r.backend for r in res]
            want = [crossover_route(eng, q, b, dev, ker) for q in qs]
            if routes != want:
                fail(f"crossover {mode} batch {b}: routed {routes}, the "
                     f"table gives {want}")
            groups = len({r for r in routes if r in ("device", "kernel")})
            if got != groups:
                fail(f"crossover {mode} batch {b}: fused_query launches "
                     f"{got}, expected {groups}")
            check_against_host(eng, res, qs, f"crossover {mode} batch {b}",
                               host)
            launched += got
            say(f"[crossover] routed {mode} batch {b}: "
                f"{dict(collections.Counter(routes))} as the table gives, "
                f"fused_query launches {got}; answers agree with the host")
    eng.planner = saved
    return launched


def autocollate_phase(names, probs, card: str) -> int:
    """(b) ``Engine(auto_collate_delta_frac=AUTO_FRAC)`` on the card over
    the first ``AUTO_DOCS`` WSJ1-like documents (``names`` and ``probs``:
    the stream's term table and Zipf weights), a freeze at half, then
    ``AUTO_CHUNK`` documents and an unforced batch of 32 between each: the
    collations must rise, the delta after each batch must stay within the
    fraction of the store plus what one chunk can add (its new blocks and
    one copied tail per term it touched), every answer must be the host's
    and every batch one ``fused_query`` launch.  Delta compaction is off,
    so that only the auto-collation re-freezes.  Returns the launches."""
    from repro_torch.data.corpus import WSJ1_LIKE, SyntheticCorpus
    from repro_torch.engine import Engine, Query
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    spec = WSJ1_LIKE.scaled(AUTO_DOCS)
    if len(names) != spec.universe:
        fail("autocollate: the term table is not the stream's")
    docs = [[names[i] for i in ids.tolist()]
            for ids in SyntheticCorpus(spec).doc_term_ids()]
    eng = Engine(B=64, growth="const", delta_compact_frac=None,
                 auto_collate_delta_frac=AUTO_FRAC)
    half = AUTO_DOCS // 2
    eng.add_documents(docs[:half])
    eng.collate_now()
    rng = np.random.default_rng(CROSSOVER_SEED + 1)
    fq_kernel.launches = 0
    batches = 0
    for start in range(half, AUTO_DOCS, AUTO_CHUNK):
        chunk = docs[start:start + AUTO_CHUNK]
        before = eng.index.store.nblocks
        eng.add_documents(chunk)
        grown = eng.index.store.nblocks - before
        touched = len({t for d in chunk for t in d})
        mode = MODES[batches % len(MODES)]
        qs = zipf_queries(rng, names, probs, eng, 32, mode)
        _, res = timed_batch(eng, qs)
        batches += 1
        if any(r.backend != "device" for r in res):
            fail("autocollate: a batch of 32 left the device backend")
        st = eng.stats()
        delta, total = eng.resident.delta_blocks, eng.index.store.nblocks
        bound = AUTO_FRAC * total + grown + touched
        if delta > bound:
            fail(f"autocollate: delta {delta} blocks after a batch, over "
                 f"{AUTO_FRAC} of {total} + {grown} new + {touched} tails")
        # the host's answers straight from its backend: a batch through
        # the engine would itself re-freeze a delta past the fraction
        asked = [Query(terms=q.terms, mode=q.mode, k=q.k, backend="host")
                 for q in qs]
        check_against_host(eng, res, qs, "autocollate", dict(
            zip(asked, eng.backends["host"].execute_many(asked))))
        say(f"[autocollate] {st.num_docs} docs, {mode} batch of 32: "
            f"collations {st.collations}, delta {delta} / {total} blocks = "
            f"{delta / total:.4f} (bound {bound:.0f}: {AUTO_FRAC} of the "
            f"store + {grown} new + {touched} tails); answers agree with "
            f"the host")
    st = eng.stats()
    if st.collations < 2 or st.delta_compactions:
        fail(f"autocollate: {st.collations} collations (the freeze and "
             f"{st.collations - 1} re-freezes), {st.delta_compactions} "
             f"compactions")
    if fq_kernel.launches != batches:
        fail(f"autocollate: fused_query launches {fq_kernel.launches}, "
             f"expected one per batch = {batches}")
    say(f"[autocollate] {st.collations - 1} re-freezes over {batches} "
        f"batches; fused_query launches {fq_kernel.launches} ({card})")
    return fq_kernel.launches


def planner_phase(eng, names, probs) -> int:
    """The planner phase, (a) on ``eng`` and (b) on an engine of its own;
    prints its seconds and returns its ``fused_query`` launches."""
    card = card_line()
    t0 = time.perf_counter()
    launched = crossover_phase(eng, names, probs, card)
    t1 = time.perf_counter()
    launched += autocollate_phase(names, probs, card)
    t2 = time.perf_counter()
    say(f"[time] planner phase: (a) crossover {t1 - t0:.3f} s, (b) "
        f"auto-collation {t2 - t1:.3f} s, {t2 - t0:.3f} s in all ({card})")
    return launched


# --------------------------------------------------------------------------
# phase 3, continued: the static tier, its freeze and a snapshot restore
# --------------------------------------------------------------------------


def serve_timed(svc, batches) -> tuple[list, dict]:
    """Each batch of 32 through the service (one flush, one fused launch),
    on the host's clock with a synchronize after it: (tickets, ms by
    mode)."""
    import torch
    tickets, ms = [], {}
    for qs in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = [svc.submit(q) for q in qs]        # 32 fill a batch: flush
        svc.flush()
        torch.cuda.synchronize()
        ms[qs[0].mode] = (time.perf_counter() - t0) * 1e3
        if any(t.result.backend != "device" for t in ts):
            fail(f"a {qs[0].mode} query of the tier phase was not routed "
                 f"to the device backend")
        tickets += ts
    return tickets, ms


def same_bits(a, b, label: str) -> None:
    """Two answer lists equal: docids, and score bits where ranked."""
    for ra, rb in zip(a, b, strict=True):
        if ra.docids.tolist() != rb.docids.tolist() or (
                ra.scores is not None
                and ra.scores.tobytes() != rb.scores.tobytes()):
            fail(f"{label}: {ra.docids[:10]} {ra.scores} against "
                 f"{rb.docids[:10]} {rb.scores}")


def tier_phase(eng, svc, corpus, names, batches) -> dict:
    """The static tier on the Const engine: a background freeze into a
    bp128 tier while the main path's first batch of each mode is served
    through ``fused_query``; the tier's checks; the same batches on the
    tier-era frozen image, and through ``tiered``; a post-freeze delta of
    256 documents with 8 deletes; a snapshot and ``Engine.restore`` onto
    the card, whose fused answers must equal the engine's bit for bit.
    Every answer is held against the host backend."""
    import tempfile

    import torch
    from repro_torch.core.lifecycle import FreezePolicy
    from repro_torch.engine import Engine, Query
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    from repro_torch.serve import QueryService
    card = card_line()
    dead = set(eng.index.tombstones)
    fq_kernel.launches = 0          # counts from here are the tier phase's

    # ---- 1-2. freeze in the background, serve meanwhile -----------------
    lc = eng.enable_tiering(FreezePolicy(codec="bp128"))
    t0 = time.perf_counter()
    if not lc.freeze():
        fail("the tier freeze did not start")
    call_s = time.perf_counter() - t0    # collate_now + clone, this thread
    t1 = time.perf_counter()
    eng.resident.refresh()               # the new frozen image's stats
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t1
    tickets, during = serve_timed(svc, batches)
    if not lc.in_flight:
        fail("the encode ended before the batches were answered: nothing "
             "was served during it")
    # the host's answers by query, kept while the index's contents stand
    # still (a freeze moves no document): one host run per query for the
    # checks during and after the encode and the tiered batches
    host: dict = {}
    t1 = time.perf_counter()
    check_against_host(eng, [t.result for t in tickets],
                       [t.query for t in tickets], "during the encode", host)
    check_s = time.perf_counter() - t1
    say(f"[tier] during the encode: {len(tickets)} queries answered through "
        f"fused_query, the encode still running after them; equal to the "
        f"host backend's ({check_s:.3f} s for the host's answers)")
    lc.wait()
    wall_s = time.perf_counter() - t0

    # ---- 3. the tier -----------------------------------------------------
    tier, st = eng.static_tier(), eng.stats()
    if st.tier_epoch != 1 or tier is None or tier.epoch != 1:
        fail(f"tier epoch {st.tier_epoch}, expected 1")
    if tier.num_docs != eng.index.num_docs:
        fail(f"tier horizon {tier.num_docs} != num_docs "
             f"{eng.index.num_docs}")
    if st.tombstones_compacted != len(dead):
        fail(f"tombstones_compacted {st.tombstones_compacted} != deletes "
             f"{len(dead)}")
    say(f"[tier] epoch 1, horizon {tier.num_docs} = num_docs, "
        f"{st.tombstones_compacted} tombstones compacted = the deletes; "
        f"{tier.num_postings} postings; static bp128 "
        f"{tier.index.bytes_per_posting():.4f} bytes/posting against the "
        f"dynamic index's {eng.index.bytes_per_posting():.4f}")
    say(f"[time] tier freeze: encode {tier.encode_s:.3f} s on its thread "
        f"(wall {wall_s:.3f} s from the freeze call to wait(); the call, "
        f"collate_now and the clone on this thread, {call_s:.3f} s; the "
        f"first refresh of the new frozen image {refresh_s:.3f} s, during "
        f"the encode) ({card})")

    # ---- 4. the same batches on the new frozen image, and tiered --------
    after_t, after = serve_timed(svc, batches)
    check_against_host(eng, [t.result for t in after_t],
                       [t.query for t in after_t], "after the swap", host)
    say("[time] main-path batch of 32, ms during the encode -> after it: "
        + ", ".join(f"{m} {during[m]:.3f} -> {after[m]:.3f}" for m in MODES)
        + f" (host clock, one batch each) ({card})")
    tiered_ms = {}
    for qs in batches:
        forced = [Query(terms=q.terms, mode=q.mode, k=q.k, backend="tiered")
                  for q in qs]
        t1 = time.perf_counter()
        got = eng.execute_many(forced)
        tiered_ms[qs[0].mode] = (time.perf_counter() - t1) * 1e3
        if any(r.backend != "tiered" for r in got):
            fail("a forced tiered query was served elsewhere")
        same_bits(got, [host[Query(terms=q.terms, mode=q.mode, k=q.k,
                                   backend="host")] for q in qs],
                  f"tiered {qs[0].mode}")
    say(f"[tier] one batch of 32 per mode through the tiered backend: "
        f"docids and score bits equal to the host backend's; ms a batch "
        + ", ".join(f"{m} {tiered_ms[m]:.3f}" for m in MODES)
        + f" (host clock) ({card})")

    # ---- 5. a post-freeze delta -----------------------------------------
    corpus.spec = corpus.spec.scaled(256)
    fresh = [[names[i] for i in ids.tolist()]
             for ids in corpus.doc_term_ids()]
    rng = np.random.default_rng(99)
    svc.ingest_batch(fresh)
    while len(eng.index.tombstones) < len(dead) + 8:
        d = int(rng.integers(1, eng.index.num_docs + 1))
        if d not in eng.index.tombstones:
            svc.delete(d)
    delta_t, _ = serve_timed(svc, batches)
    before = [t.result for t in delta_t]
    host = {}                  # the restored engine holds these contents
    check_against_host(eng, before, [t.query for t in delta_t],
                       "with a post-freeze delta", host)
    say(f"[tier] {len(fresh)} more documents and 8 deletes: fused answers "
        f"over the tier-era frozen image and a delta of "
        f"{eng.resident.delta_blocks} blocks equal the host backend's")

    # ---- 6. snapshot, restore onto the card ------------------------------
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        snap = eng.snapshot(root)
        snap_s = time.perf_counter() - t0
        snap_bytes = sum(p.stat().st_size for p in Path(snap).iterdir())
        say(f"[time] snapshot {snap_s:.3f} s, {snap_bytes} bytes in "
            f"{len(list(Path(snap).iterdir()))} files ({card})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = Engine.restore(root, delta_compact_frac=None)
        rsvc = QueryService(restored, max_batch=32, cache_size=0)
        first = [rsvc.submit(q) for q in batches[0]]
        rsvc.flush()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    where = restored.resident.images[0].blocks.device
    if where.type != eng.device.type:
        fail(f"the restored engine's frozen image lives on {where}, the "
             f"engine's on {eng.device}")
    rest_t, _ = serve_timed(rsvc, batches[1:])
    got = [t.result for t in first + rest_t]
    same_bits(got, before, "restored against the engine before the "
                           "snapshot")
    check_against_host(restored, got, [t.query for t in first + rest_t],
                       "restored", host)
    say(f"[tier] restored: epoch {restored.stats().tier_epoch}, "
        f"{restored.index.num_docs} docs, delta "
        f"{restored.resident.delta_blocks} blocks; fused answers equal the "
        f"engine's before the snapshot bit for bit, and the host backend's")
    say(f"[time] restore to the first answer on the card {first_s:.3f} s "
        f"({card})")
    torch.cuda.synchronize()
    launches = fq_kernel.launches
    if launches != 4 * len(batches):
        fail(f"fused_query launches in the tier phase: {launches}, expected "
             f"one per batch of 32 = {4 * len(batches)}")
    say(f"[tier] fused_query launches in the phase: {launches}, one per "
        f"batch (during, after, with the delta, restored)")
    del restored, rsvc
    gc.collect()
    return {"launches": launches}


# --------------------------------------------------------------------------
# phase 4: the host fleet behind the pipelined service
# --------------------------------------------------------------------------


def live_on(eng, q) -> bool:
    """Whether ``q`` needs shard ``eng``'s fused launch (``pack_queries``'s
    rule): a conjunctive query every term of which the shard has seen, a
    ranked one with at least one such term."""
    ids = [eng.term_id(t) for t in q.terms]
    if q.mode == "conjunctive":
        return bool(ids) and None not in ids
    return any(i is not None for i in ids)


def fleet_stream(n_docs: int):
    """(term names, Zipf probabilities, documents): the first ``n_docs`` +
    256 documents of the WSJ1-like stream scaled to that many, as term
    lists; the last 256 are the traffic's ingests."""
    from repro_torch.data.corpus import WSJ1_LIKE, SyntheticCorpus, term_table
    spec = WSJ1_LIKE.scaled(n_docs + 256)
    names = term_table(spec.universe)
    probs = 1.0 / np.arange(1, spec.universe + 1) ** spec.zipf_s
    probs /= probs.sum()
    docs = [[names[i] for i in ids.tolist()]
            for ids in SyntheticCorpus(spec).doc_term_ids()]
    return names, probs, docs


def fleet_round(fleet, svc, groups, label: str,
                times: list | None = None) -> list:
    """Each group of 32 through the pipelined service (one flush, one
    fan-out); every answer against the fleet's host backend; each shard's
    ``fused_query`` launches against one per group with a query live on
    it, the ones the service answers from its cache left out.  ``times``
    collects each group's seconds in the service (host clock)."""
    import torch
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    tickets = []
    for qs in groups:
        served = [e.resident.batches_served for e in fleet.engines]
        before = fq_kernel.launches
        misses = [q for q in dict.fromkeys(qs)
                  if svc._cache_key(q) not in svc._cache]
        want = [int(any(live_on(e, q) for q in misses))
                for e in fleet.engines]
        t = time.perf_counter()
        ts = [svc.submit(q) for q in qs]        # 32 fill a batch: flush
        torch.cuda.synchronize()
        if times is not None:
            times.append(time.perf_counter() - t)
        got = [e.resident.batches_served - b
               for e, b in zip(fleet.engines, served)]
        if got != want or fq_kernel.launches - before != sum(want):
            fail(f"{label} {qs[0].mode}: fused_query launches per shard "
                 f"{got} ({fq_kernel.launches - before} in all), expected "
                 f"{want}")
        if any(t.result.backend != "device" for t in ts):
            fail(f"a {label} {qs[0].mode} query was not served by every "
                 f"shard's device backend")
        tickets += ts
    check_against_host(fleet, [t.result for t in tickets],
                       [t.query for t in tickets], f"fleet {label}")
    return tickets


def fleet_phase(const: dict | None) -> dict:
    """Phase 4: a two-shard fleet on the card behind the pipelined
    service.  ``const`` holds the Const path's ingest rate and batch ms
    for comparison (None with ``--fleet-only``)."""
    import torch
    from repro_torch.core.sharded_index import ShardedEngine
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    from repro_torch.serve import (QueryService, WorkloadSpec,
                                   generate_schedule, run_traffic)
    card = card_line()
    t_phase = time.perf_counter()
    names, probs, docs = fleet_stream(FLEET_DOCS)
    gen_s = time.perf_counter() - t_phase
    stream, more = docs[:FLEET_DOCS], docs[FLEET_DOCS:]
    fq_kernel.launches = 0          # counts from here are the fleet's
    fleet = ShardedEngine(num_shards=2, B=64, growth="const",
                          delta_compact_frac=None)
    svc = QueryService(fleet, max_batch=32, pipelined=True)
    rng = np.random.default_rng(4096)

    def known(t):
        return fleet._ft.get(t.encode(), 0) > 0

    def draw():
        return [zipf_queries(rng, names, probs, None, 32, mode, known=known)
                for mode in MODES]

    def drain() -> float:
        t = time.perf_counter()
        svc.pipeline.drain()
        return time.perf_counter() - t

    freeze_at = round(FLEET_DOCS * 0.9 / 256) * 256
    dead: set[int] = set()
    ingest_s = collate_s = 0.0
    for i in range(0, FLEET_DOCS, 256):
        t = time.perf_counter()
        svc.ingest_batch(stream[i:i + 256])
        ingest_s += time.perf_counter() - t
        done = i + 256
        if done == freeze_at:
            ingest_s += drain()
            t = time.perf_counter()
            fleet.collate_now()
            torch.cuda.synchronize()
            collate_s = time.perf_counter() - t
            fleet_round(fleet, svc, draw(), "right after the freeze")
        elif done > freeze_at:
            ingest_s += drain()
            for _ in range(8):              # tombstone on the way
                d = int(rng.integers(1, fleet.num_docs + 1))
                if d not in dead:
                    dead.add(d)
                    svc.delete(d)
    ingest_s += drain()
    st = fleet.stats()
    writer_s = [e.stats().ingest_time_s for e in fleet.engines]
    rate = FLEET_DOCS / ingest_s
    const_rate = (f"{const['ingest_rate']:.1f} docs/s" if const
                  else "not measured in this run")
    say(f"[fleet] pipelined ingest: {FLEET_DOCS} docs ({st.num_postings} "
        f"postings, {st.vocab_size} terms) into 2 shards of "
        f"{[e.index.num_docs for e in fleet.engines]} docs in "
        f"{ingest_s:.3f} s of ingest_batch and drains: {rate:.1f} docs/s "
        f"(writer threads {writer_s[0]:.3f} + {writer_s[1]:.3f} s inside "
        f"add_documents; generation {gen_s:.3f} s apart); the Const path's "
        f"synchronous add_documents {const_rate} ({card})")
    # each shard's refresh after the stream's last ingest and deletes
    refresh_s = []
    for e in fleet.engines:
        torch.cuda.synchronize()
        t = time.perf_counter()
        e.resident.refresh()
        torch.cuda.synchronize()
        refresh_s.append(time.perf_counter() - t)
    frozen = fleet.engines[0].resident.images[0]
    say(f"[fleet] collate_now at {freeze_at} docs {collate_s:.3f} s (both "
        f"shards); {len(dead)} deletes after it; per shard: docid capacity "
        f"{frozen.num_docs}, delta "
        f"{[e.resident.delta_blocks for e in fleet.engines]} blocks, "
        f"the first refresh after the stream's last "
        f"{FLEET_DOCS - freeze_at} documents and deletes "
        + " / ".join(f"{s:.3f}" for s in refresh_s)
        + f" s; fleet N {fleet.num_docs - fleet.deleted_docs} ({card})")
    last = fleet_round(fleet, svc, draw(), "at the end of the stream")
    groups = [[t.query for t in last[i:i + 32]] for i in range(0, 96, 32)]
    fleet_ms = {qs[0].mode: host_ms(lambda: fleet.execute_many(qs), REPS)
                for qs in groups}
    pool, fleet._pool = fleet._pool, None       # the same, fanned out serially
    serial_ms = {qs[0].mode: host_ms(lambda: fleet.execute_many(qs), REPS)
                 for qs in groups}
    fleet._pool = pool
    say("[time] fleet engine batch of 32 (ShardedEngine.execute_many, two "
        "shards on one card, fan-out on 2 threads), ms: "
        + ", ".join(f"{m} {fleet_ms[m]:.4f}" for m in MODES)
        + "; fanned out serially: "
        + ", ".join(f"{m} {serial_ms[m]:.4f}" for m in MODES)
        + "; the single engine's: "
        + (", ".join(f"{m} {const['e2e'][m]:.4f}" for m in MODES)
           if const else "not measured in this run")
        + f" (host clock, medians of {REPS}) ({card})")

    # ---- traffic ---------------------------------------------------------
    wspec = WorkloadSpec(seed=0, num_events=TRAFFIC_EVENTS,
                         ingest_fraction=0.2, delete_fraction=0.01,
                         num_distinct_queries=64, max_terms=3, k=K)
    before = fleet.stats().by_backend.get("device", 0)
    zips = list(zip(fleet.engines,
                    [e.stats().delta_refreshes for e in fleet.engines]))
    hits0, misses0 = svc.cache_hits, svc.cache_misses
    spent: list[float] = []         # each shard refresh that rebuilt, s

    def clocked(real):
        def run():
            t = time.perf_counter()
            rebuilt = real()
            if rebuilt:
                torch.cuda.synchronize()
                spent.append(time.perf_counter() - t)
            return rebuilt
        return run

    for e in fleet.engines:
        e.resident.refresh = clocked(e.resident.refresh)
    t = time.perf_counter()
    rep = run_traffic(fleet, generate_schedule(wspec, list(names)), more,
                      service=svc)
    traffic_s = time.perf_counter() - t
    for e in fleet.engines:
        del e.resident.refresh          # the method again
    st = fleet.stats()
    device = st.by_backend.get("device", 0) - before
    hits, misses = svc.cache_hits - hits0, svc.cache_misses - misses0
    say(f"[traffic] {rep.num_events} events ({rep.num_queries} queries, "
        f"{rep.num_ingests} ingests, {rep.num_deletes} deletes) in "
        f"{traffic_s:.3f} s: p50 {rep.p50_ms:.4f} ms, p99 {rep.p99_ms:.4f} "
        f"ms, p999 {rep.p999_ms:.4f} ms, mean {rep.mean_ms:.4f} ms, max "
        f"{rep.max_ms:.4f} ms; {rep.qps:.1f} queries/s; cache hit rate "
        f"{hits / max(1, hits + misses):.4f} ({hits} hits, {misses} misses "
        f"in the traffic; the service's since it started "
        f"{rep.cache_hit_rate:.4f}); availability gap "
        f"{rep.availability_gap}; fleet by_backend {st.by_backend} (shard "
        f"answers, all phases), {device} during the traffic on device; "
        f"shard delta_refreshes "
        f"{[e.stats().delta_refreshes - r for e, r in zips]} during it, "
        f"each {np.median(spent) * 1e3 if spent else 0:.3f} ms (median; "
        f"{sum(spent):.3f} s in all) ({card})")
    if rep.availability_gap > 0:
        fail(f"the traffic left {rep.availability_gap} requests unanswered")
    if device == 0:
        fail("no traffic batch was served by the device backend")
    fleet_round(fleet, svc, draw(), "after the traffic")
    launches = fq_kernel.launches
    say(f"[fleet] fused_query launches in the phase: {launches} (every "
        f"shard's device batches: 3 rounds and the traffic); every round's "
        f"answers equal the fleet host backend's (conjunctive exact, ranked "
        f"rtol {HOST_RTOL}); the phase took "
        f"{time.perf_counter() - t_phase:.3f} s ({card})")
    svc.close()
    fleet.close()
    return {"launches": launches, "names": names, "probs": probs,
            "indexes": [e.index for e in fleet.engines]}


# --------------------------------------------------------------------------
# phase 4b: the fleet's concurrency under the port's sanitizer
# --------------------------------------------------------------------------


def sanitize_phase() -> dict:
    """Phase 4b: a two-shard fleet on the card behind the pipelined service
    with background bp128 freezes under one encode slot, built after the
    port's :class:`~repro_torch.analysis.Sanitizer` is enabled, so that
    its locks are instrumented and its ``guarded_by`` fields shadowed; then
    a seeded lock-order inversion on a fresh fleet, which a second
    sanitizer must catch."""
    import torch
    from repro_torch.analysis import Sanitizer
    from repro_torch.core.lifecycle import FreezePolicy
    from repro_torch.core.sharded_index import ShardedEngine
    from repro_torch.kernels.fused_query import kernel as fq_kernel
    from repro_torch.serve import (QueryService, WorkloadSpec,
                                   generate_schedule, run_traffic)
    card = card_line()
    t_phase = time.perf_counter()
    names, probs, docs = fleet_stream(SANITIZE_DOCS)
    gen_s = time.perf_counter() - t_phase
    stream, more = docs[:SANITIZE_DOCS], docs[SANITIZE_DOCS:]
    rng = np.random.default_rng(4097)
    times: list[float] = []         # each served group of 32, s
    reports = []
    ingest_s = rounds_s = traffic_s = 0.0
    fq_kernel.launches = 0          # counts from here are the phase's
    san = Sanitizer("sanitized-fleet")
    san.enable()                    # before the fleet: its locks are
    try:                            # instrumented only if made after this
        fleet = ShardedEngine(
            num_shards=2, B=64, growth="const", delta_compact_frac=None,
            tier_policy=FreezePolicy(every_docs=SANITIZE_EVERY,
                                     background=True, codec="bp128"),
            max_in_flight=1)
        svc = QueryService(fleet, max_batch=32, pipelined=True)
        coord = fleet.coordinator
        # every guarded_by field of the port; published and writer_only
        # fields are lock-free by contract and are not shadowed
        san.shadow(coord, "_in_flight", "_waiters", "peak_in_flight",
                   "deferrals", label="FreezeCoordinator")
        for s, w in enumerate(svc.pipeline._writers):
            san.shadow(w, "_completed", "_error", label=f"ShardWriter{s}")
        conds = [coord._cond] + [w._cv for w in svc.pipeline._writers]
        if not all(type(c._lock).__name__ == "_SanLock" for c in conds):
            fail("the fleet's locks are not instrumented: build it after "
                 "Sanitizer.enable()")

        def known(t):
            return fleet._ft.get(t.encode(), 0) > 0

        def draw():
            return [zipf_queries(rng, names, probs, None, 32, mode,
                                 known=known) for mode in MODES]

        for i in range(0, SANITIZE_DOCS, 256):
            t = time.perf_counter()
            svc.ingest_batch(stream[i:i + 256])
            ingest_s += time.perf_counter() - t
            done = i + 256
            if done % SANITIZE_EVERY:
                continue
            t = time.perf_counter()
            fleet_round(fleet, svc, draw(), f"sanitized fleet at {done}",
                        times)
            rounds_s += time.perf_counter() - t
            wspec = WorkloadSpec(seed=done // SANITIZE_EVERY,
                                 num_events=SANITIZE_EVENTS,
                                 ingest_fraction=0.2, delete_fraction=0.01,
                                 num_distinct_queries=64, max_terms=3, k=K)
            t = time.perf_counter()
            rep = run_traffic(fleet, generate_schedule(wspec, list(names)),
                              more, service=svc)
            traffic_s += time.perf_counter() - t
            if rep.availability_gap > 0:
                fail(f"the sanitized fleet's traffic at {done} left "
                     f"{rep.availability_gap} requests unanswered")
            reports.append(rep)
        t = time.perf_counter()
        svc.pipeline.drain()
        fleet.drain_freezes()
        drain_s = time.perf_counter() - t
        t = time.perf_counter()
        fleet_round(fleet, svc, draw(), "sanitized fleet after "
                    "drain_freezes", times)
        rounds_s += time.perf_counter() - t
        torch.cuda.synchronize()
        with coord._cond:           # guarded fields: read under the guard
            peak, deferrals = coord.peak_in_flight, coord.deferrals
            pending = len(coord._waiters)
        epochs = [e.lifecycle.epoch for e in fleet.engines]
        encode_s = [e.lifecycle.last_freeze_s for e in fleet.engines]
        launches = fq_kernel.launches
        svc.close()
        fleet.close()
    finally:
        san.disable()
    if san.findings:
        fail(f"the sanitizer reported the port's fleet on the card:\n"
             f"{san.report()}")
    if peak != 1:
        fail(f"peak_in_flight {peak} under max_in_flight=1")
    if deferrals < 1:
        fail("no freeze was deferred: the two shards' background freezes "
             "never contended for the one slot")
    if pending or min(epochs) < 1:
        fail(f"freezes left after drain_freezes: {pending} queued, epochs "
             f"{epochs}")
    run_s = time.perf_counter() - t_phase

    # ---- a seeded inversion, which a second sanitizer must catch --------
    san2 = Sanitizer("seeded-inversion")
    ingest_mu, stats_mu = san2.lock("ingest_mu"), san2.lock("stats_mu")
    san2.enable()
    try:
        seeded = ShardedEngine(
            num_shards=2, B=64, growth="const", delta_compact_frac=None,
            tier_policy=FreezePolicy(every_docs=8, background=True),
            max_in_flight=1)
        for j, d in enumerate(stream[:SEEDED_DOCS]):
            first, second = ((ingest_mu, stats_mu) if j % 2
                             else (stats_mu, ingest_mu))    # the seeded bug
            with first:
                with second:
                    seeded.add_document(d)
        seeded.drain_freezes()
        seeded.close()
    finally:
        san2.disable()
    caught = [f for f in san2.findings
              if "lock-order inversion" in f.message
              and "ingest_mu" in f.message and "stats_mu" in f.message]
    if not caught:
        fail(f"the seeded lock-order inversion went undetected on this "
             f"machine: {san2.report()}")
    phase_s = time.perf_counter() - t_phase
    ms = np.asarray(times) * 1e3
    say(f"[sanitize] two shards behind QueryService(pipelined=True) under "
        f"the port's sanitizer (locks made after enable() instrumented; "
        f"FreezeCoordinator._in_flight/_waiters/peak_in_flight/deferrals "
        f"and each ShardWriter's _completed/_error shadowed): "
        f"{SANITIZE_DOCS} docs through ingest_batch in {ingest_s:.3f} s "
        f"({SANITIZE_DOCS / ingest_s:.1f} docs/s); background bp128 "
        f"freezes every {SANITIZE_EVERY} docs a shard under one slot: "
        f"{sum(epochs)} granted (epochs per shard {epochs}), {deferrals} "
        f"deferred, peak in flight {peak}; the last encode per shard "
        + " / ".join(f"{x:.3f}" for x in encode_s)
        + f" s; drain_freezes {drain_s:.3f} s; "
        f"{len(times)} groups of 32 in the service, each "
        f"{np.median(ms):.3f} ms median, {ms.max():.3f} ms max (host "
        f"clock, sanitizer on), every answer equal to the fleet host "
        f"backend's; traffic {len(reports)} x {SANITIZE_EVENTS} events, "
        f"none unanswered; fused_query launches {launches}; sanitizer "
        f"findings 0 ({card})")
    say(f"[sanitize] seeded inversion on a fresh fleet of {SEEDED_DOCS} "
        f"docs caught: {caught[0].message[:160]}; the phase took "
        f"{phase_s:.3f} s: generation {gen_s:.3f}, ingest_batch "
        f"{ingest_s:.3f}, the {len(times) // 3} checked rounds (their "
        f"flushes wait for the writers) {rounds_s:.3f}, the traffic "
        f"{traffic_s:.3f}, drain_freezes {drain_s:.3f}, the seeded run "
        f"{phase_s - run_s:.3f} s ({card})")
    return {"launches": launches}


# --------------------------------------------------------------------------
# phase 5: the device-mesh query step, two ranks on the card
# --------------------------------------------------------------------------

MESH_REPS = 5           # timed steps per mode and layout (median)
MESH_HOST_Q = 32        # queries per mode held against the host oracle
MESH_BACKEND = "gloo"   # NCCL does not put two ranks on one card
MESH_DEVICE = "cuda:0"  # both ranks' card
MESH_IMAGE = ("blocks", "term_slot", "term_nblk", "term_skip", "term_nx",
              "term_ft")


def save_image(img, folder: Path) -> None:
    """A device image's arrays as ``.npy`` files, for a rank to load."""
    folder.mkdir(parents=True, exist_ok=True)
    for f in MESH_IMAGE:
        np.save(folder / f"{f}.npy", getattr(img, f).cpu().numpy())
    (folder / "meta.json").write_text(json.dumps(
        {"num_docs": int(img.num_docs), "F": int(img.F)}))


def load_image(folder, device):
    import torch
    from repro_torch.core.device_index import DeviceIndex
    folder = Path(folder)
    return DeviceIndex(
        **{f: torch.from_numpy(np.load(folder / f"{f}.npy")).to(device)
           for f in MESH_IMAGE},
        **json.loads((folder / "meta.json").read_text()))


def capture_frozen(eng, names, probs, folder: Path) -> dict:
    """Layout M2's inputs, taken right after the Const path's freeze: the
    frozen image's arrays saved under ``folder``, a clone of the collated
    host index (the host oracle reads it) and the vocabulary of the image's
    term ids.  The mesh step reads every posting of the image, so the
    oracle's clone keeps no tombstones."""
    t = time.perf_counter()
    img = eng.resident._frozen_raw
    save_image(img, folder)
    index = eng.index.clone()
    index.tombstones = set()
    return dict(folders=[str(folder)], indexes=[index],
                vocab=list(eng.vocab), names=names, probs=probs,
                capture_s=time.perf_counter() - t)


def const_frozen(n_docs: int, folder: Path) -> dict:
    """``--mesh-only``: :func:`capture_frozen` from a Const engine built as
    phase 3 builds it, the stream stopped at the freeze."""
    def stop(eng, names, probs):
        raise _Captured(capture_frozen(eng, names, probs, folder))

    try:
        const_engine(n_docs, np.random.default_rng(2024), on_freeze=stop)
    except _Captured as c:
        return c.args[0]
    fail("the Const stream ended before its freeze")


def fleet_indexes() -> dict:
    """``--mesh-only``: layout M1's host shards without the fleet phase: the
    first ``FLEET_DOCS`` WSJ1-like documents through a host
    ``ShardedEngine(num_shards=2)`` in batches of 256, as the fleet phase
    feeds its own (no device image is built).  The fleet phase's traffic
    documents and deletes are not replayed."""
    from repro_torch.core.sharded_index import ShardedEngine
    names, probs, docs = fleet_stream(FLEET_DOCS)
    docs = docs[:FLEET_DOCS]
    with ShardedEngine(num_shards=2, B=64, growth="const",
                       delta_compact_frac=None, device="cpu",
                       parallel=False) as fleet:
        for i in range(0, FLEET_DOCS, 256):
            fleet.add_documents(docs[i:i + 256])
    return dict(indexes=[e.index for e in fleet.engines], names=names,
                probs=probs)


def mesh_queries(rng, names, cdf, tid: dict, n: int, T: int):
    """``n`` queries of 1 to ``T`` terms drawn by Zipf rank among
    ``names`` (``cdf``: the cumulative Zipf probabilities), keeping those
    whose terms are all in ``tid``: (term ids (n, T) int32, mask (n, T)
    bool, the queries' terms)."""
    qt = np.zeros((n, T), np.int32)
    qm = np.zeros((n, T), bool)
    terms: list[list[str]] = []
    while len(terms) < n:
        ranks = np.minimum(np.searchsorted(
            cdf, rng.random(int(rng.integers(1, T + 1)))), len(names) - 1)
        ts = list(dict.fromkeys(names[r] for r in ranks.tolist()))
        ids = [tid.get(t.encode()) for t in ts]
        if None in ids:
            continue
        qt[len(terms), :len(ids)] = ids
        qm[len(terms), :len(ids)] = True
        terms.append(ts)
    return qt, qm, terms


def mesh_rank(rank: int, world: int, job_path: str) -> dict:
    """One rank of the mesh phase (a spawned process on ``cuda:0``): for
    each layout, its shard's image from the ``.npy`` files, then every run
    of the job through the port's ``make_sharded_query_step`` on a
    ``make_host_mesh`` mesh; each step must launch ``dvbyte_decode`` once.
    Rank 0 returns the assembled answers; every rank its step times."""
    import torch
    from repro_torch.core.sharded_index import make_sharded_query_step
    from repro_torch.kernels.dvbyte_decode import kernel as dv_kernel
    from repro_torch.launch import make_host_mesh
    job = json.loads(Path(job_path).read_text())
    dev = torch.device(MESH_DEVICE)
    torch.cuda.set_device(dev)
    out: dict = {"answers": {}, "times": {}}
    dv_kernel.launches = 0
    steps = 0
    for lay in job["layouts"]:
        mesh = make_host_mesh(model=lay["model"])
        q = {k: torch.from_numpy(v).to(dev)
             for k, v in np.load(lay["queries"]).items()}
        img = off = None
        for run in lay["runs"]:
            step = make_sharded_query_step(
                mesh, k=K, max_blocks=run["max_blocks"],
                num_docs=lay["num_docs"], mode=run["mode"])
            if img is None:
                img = load_image(lay["folders"][step.shard], dev)
                off = lay["offsets"][step.shard]
            qt, qm = q[run["batch"] + "_t"], q[run["batch"] + "_m"]

            def call():
                """One step, its local half and its collectives timed
                apart (ms); ``dvbyte_decode`` must launch once in it."""
                nonlocal steps
                before = dv_kernel.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                local = step.local(img, off, qt, qm)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res = step.fuse(local)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                steps += 1
                if dv_kernel.launches - before != 1:
                    raise RuntimeError(
                        f"rank {rank} {lay['name']} {run['key']}: "
                        f"dvbyte_decode launched "
                        f"{dv_kernel.launches - before} times in one step")
                return res, (t2 - t0) * 1e3, (t2 - t1) * 1e3

            res, _, _ = call()
            full = step.assemble(res, dst=0)
            if full is not None:
                out["answers"][f"{lay['name']}/{run['key']}"] = [
                    x.cpu().numpy() for x in full]
            if run["timed"]:
                times = [call()[1:] for _ in range(2 + MESH_REPS)][2:]
                out["times"][f"{lay['name']}/{run['key']}"] = [
                    float(np.median([t[0] for t in times])),
                    float(np.median([t[1] for t in times]))]
        del img
        torch.cuda.empty_cache()
    out["launches"], out["steps"] = dv_kernel.launches, steps
    out["device"] = torch.cuda.get_device_name(dev)
    return out


def mesh_layout(name: str, indexes: list, vocab: list, work: Path,
                model: int, names, probs, rng, saved=None) -> dict:
    """One layout's images, queries and runs, written under ``work`` for
    the ranks.  The images: the one ``saved`` by :func:`capture_frozen`
    (M2), or each collated host index imaged on one common ``vocab`` (term
    ids are global, and each shard numbers its terms in its own order),
    ``term_ft`` rebased to the shards' summed store f_t (each image keeps
    its own ``num_docs``; the step's is the total: the reference's
    recipe)."""
    from repro_torch.configs.paper_index import INDEX_SHAPES
    from repro_torch.core.device_index import (build_device_image,
                                               with_global_stats)
    from repro_torch.core.sharded_index import shard_doc_offsets
    if saved is None:
        ims = [build_device_image(ix, vocab, device=MESH_DEVICE)
               for ix in indexes]
        gft = sum(im.term_ft.long() for im in ims).cpu().numpy()
        ims = [with_global_stats(im, gft, im.num_docs) for im in ims]
        folders = [work / f"{name}_{s}" for s in range(len(ims))]
        for im, f in zip(ims, folders):
            save_image(im, f)
    else:
        folders = [Path(saved)]
        ims = [load_image(saved, MESH_DEVICE)]
    tid = {t: i for i, t in enumerate(vocab)}
    nblk = np.stack([im.term_nblk.cpu().numpy() for im in ims])
    ft = ims[0].term_ft.cpu().numpy()
    cdf = np.cumsum(probs)
    rank, conj = INDEX_SHAPES["query_rank"], INDEX_SHAPES["query_conj"]
    batches = {}
    for key, n, T in (("query_rank", rank["qbatch"], rank["qterms"]),
                      ("query_conj", conj["qbatch"], conj["qterms"]),
                      ("host_rank", MESH_HOST_Q, rank["qterms"]),
                      ("host_conj", MESH_HOST_Q, conj["qterms"])):
        qt, qm, terms = mesh_queries(rng, names, cdf, tid, n, T)
        batches[key] = dict(t=qt, m=qm, terms=terms,
                            mb=int(nblk[:, qt[qm]].max()))
    qpath = work / f"{name}_queries.npz"
    np.savez(qpath, **{f"{k}_{x}": b[x] for k, b in batches.items()
                       for x in ("t", "m")})
    runs = []
    for mode, batch, timed in (
            ("ranked_sparse", "query_rank", True),
            ("ranked", "query_rank", True),
            ("conjunctive", "query_conj", True),
            ("ranked_sparse", "host_rank", False),
            ("ranked", "host_rank", False),
            ("conjunctive", "host_conj", False)):
        runs.append(dict(mode=mode, batch=batch, timed=timed,
                         key=f"{mode}/{batch}",
                         max_blocks=(INDEX_SHAPES[batch]["max_blocks"]
                                     if timed else batches[batch]["mb"])))
    offsets = shard_doc_offsets(ims).tolist()
    return dict(name=name, model=model, folders=[str(f) for f in folders],
                offsets=offsets, num_docs=sum(im.num_docs for im in ims),
                queries=str(qpath), runs=runs, ims=ims, indexes=indexes,
                batches=batches,
                stats={t: int(ft[tid[t.encode()]]) for b in batches.values()
                       for ts in b["terms"] for t in ts})


def mesh_host_oracle(lay: dict, run: dict) -> list:
    """The host oracle of a host batch: the core's ``conjunctive_query``
    (each shard's local docids) or ``ranked_disjunctive_taat`` over each
    collated shard with the layout's global statistics, globalized by the
    offsets and merged (score descending, global docid ascending)."""
    from repro_torch.core.query import (CollectionStats, conjunctive_query,
                                        ranked_disjunctive_taat)
    stats = CollectionStats(num_docs=lay["num_docs"], avg_doclen=0.0,
                            ft={t.encode(): f
                                for t, f in lay["stats"].items()})
    out = []
    for terms in lay["batches"][run["batch"]]["terms"]:
        if run["mode"] == "conjunctive":
            out.append([conjunctive_query(ix, terms)
                        for ix in lay["indexes"]])
            continue
        cand = []
        for ix, off in zip(lay["indexes"], lay["offsets"]):
            d, s = ranked_disjunctive_taat(ix, terms, k=K, stats=stats)
            cand += [(-float(sc), off + int(dd)) for dd, sc in zip(d, s)]
        cand.sort()
        out.append(cand[:K])
    return out


def mesh_check(lay: dict, run: dict, got, host_cache: dict) -> str:
    """A rank-assembled answer against ``sharded_query_plain`` with the
    plain decode (``decode_blocks``: the ranks launch the kernel) on the
    same images on the card (conjunctive bitmaps and counts equal;
    ``ranked_sparse`` docids equal, scores within ``PARITY_RTOL``;
    ``ranked`` by :func:`ranking_agrees` at ``HOST_RTOL``: its float
    atomics are not reproducible), and a host batch against the host
    oracle."""
    import torch
    from repro_torch.core.device_index import decode_blocks
    from repro_torch.core.sharded_index import sharded_query_plain
    b = lay["batches"][run["batch"]]
    mode = run["mode"]
    qt, qm = (torch.from_numpy(b[x]).to(MESH_DEVICE) for x in ("t", "m"))
    plain = sharded_query_plain(
        lay["ims"], lay["offsets"], qt, qm, k=K,
        max_blocks=run["max_blocks"], num_docs=lay["num_docs"],
        decode_fn=decode_blocks, mode=mode)
    pa, pb = (x.cpu().numpy() for x in plain)
    ga, gb = got
    label = f"mesh {lay['name']} {run['key']}"
    if mode == "conjunctive":
        if not (np.array_equal(ga, pa) and np.array_equal(gb, pb)):
            fail(f"{label}: bitmap or counts differ from the plain version")
    for row in range(ga.shape[0]):
        if mode == "ranked_sparse":
            ok = (np.array_equal(ga[row], pa[row])
                  and np.allclose(gb[row], pb[row], rtol=PARITY_RTOL,
                                  atol=0))
        elif mode == "ranked":
            ok = ranking_agrees(ga[row], gb[row], pa[row], pb[row],
                                HOST_RTOL)
        else:
            ok = True
        if not ok:
            fail(f"{label} row {row}: {ga[row].tolist()} {gb[row].tolist()}"
                 f" plain {pa[row].tolist()} {pb[row].tolist()}")
    if run["timed"]:
        return "plain"
    key = (run["batch"], mode == "conjunctive")
    if key not in host_cache:
        host_cache[key] = mesh_host_oracle(lay, run)
    N = lay["num_docs"]
    for row, want in enumerate(host_cache[key]):
        if mode == "conjunctive":
            parts = [np.flatnonzero(ga[row, s * N:(s + 1) * N]) + 1
                     for s in range(len(want))]
            if (any(p.tolist() != w.tolist() for p, w in zip(parts, want))
                    or int(gb[row]) != sum(len(w) for w in want)):
                fail(f"{label} row {row}: hits per shard "
                     f"{[len(p) for p in parts]} host "
                     f"{[len(w) for w in want]}")
            continue
        live = np.isfinite(gb[row]) & (gb[row] > 0)
        hd = np.array([d for _, d in want], np.int64)
        hs = np.array([-s for s, _ in want])
        if not ranking_agrees(ga[row][live], gb[row][live], hd, hs,
                              HOST_RTOL):
            fail(f"{label} row {row}: {ga[row].tolist()} "
                 f"{gb[row].tolist()} host {hd.tolist()} {hs.tolist()}")
    return "plain and host"


def mesh_phase(m1: dict, m2: dict) -> dict:
    """Phase 5: the port's device-mesh query step on two ranks, each a
    process on the one card, gloo collectives on the host.  Layout M1,
    (data 2, model 1): the two fleet shards ``m1["indexes"]``, collated.
    Layout M2, (data 1, model 2): the Const path's frozen image saved by
    :func:`capture_frozen`, replicated, each rank taking 128 of the 256
    queries."""
    import torch
    from repro_torch.core.collate import collate
    from repro_torch.launch import launch
    card = card_line()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(8192)
    folder = Path(tempfile.mkdtemp(prefix="mesh-"))
    try:
        t = time.perf_counter()
        cols = [collate(ix) for ix in m1["indexes"]]
        for c in cols:
            c.tombstones = set()    # the mesh step reads every posting
        vocab = list(dict.fromkeys(term for c in cols
                                   for term, _ in c.terms()))
        lays = [mesh_layout("M1", cols, vocab, folder, 1, m1["names"],
                            m1["probs"], rng),
                mesh_layout("M2", m2["indexes"], m2["vocab"], folder, 2,
                            m2["names"], m2["probs"], rng,
                            saved=m2["folders"][0])]
        prep_s = time.perf_counter() - t
        for lay in lays:
            ims, b = lay["ims"], lay["batches"]
            say(f"[mesh] {lay['name']} (data {len(ims)}, model "
                f"{lay['model']}): {len(ims)} image(s) of "
                f"{[im.num_docs for im in ims]} docs, "
                f"{[im.blocks.shape[0] for im in ims]} blocks ("
                + ", ".join(f"{im.blocks.shape[0] / 2**20:.4f}" for im in ims)
                + " of the paper's 2^20 a shard), "
                f"{ims[0].term_slot.shape[0]} terms, offsets "
                f"{lay['offsets']}, step N {lay['num_docs']}; query_rank "
                f"{' x '.join(map(str, b['query_rank']['t'].shape))} and "
                f"query_conj "
                f"{' x '.join(map(str, b['query_conj']['t'].shape))} at "
                f"max_blocks {lay['runs'][0]['max_blocks']} / "
                f"{lay['runs'][2]['max_blocks']}, host batches of "
                f"{MESH_HOST_Q} at max_blocks {b['host_rank']['mb']} / "
                f"{b['host_conj']['mb']}")
        say(f"[mesh] backend {MESH_BACKEND}, 2 ranks on 1 card (both on "
            f"cuda:0; NCCL does not put two ranks on one card, so it is not "
            f"exercised here); inputs built in {prep_s:.3f} s (M1: collate, "
            f"images on one vocabulary, global f_t; M2 saved at the freeze "
            f"in {m2['capture_s']:.3f} s)")
        job = folder / "job.json"
        job.write_text(json.dumps({"layouts": [
            {k: lay[k] for k in ("name", "model", "folders", "offsets",
                                 "num_docs", "queries", "runs")}
            for lay in lays]}))
        t = time.perf_counter()
        ranks = launch(mesh_rank, 2, backend=MESH_BACKEND, store_dir=folder,
                       args=(str(job),), deadline_s=600)
        world_s = time.perf_counter() - t
        host_cache: dict = {}
        t = time.perf_counter()
        for lay in lays:
            host_cache.clear()
            for run in lay["runs"]:
                key = f"{lay['name']}/{run['key']}"
                what = mesh_check(lay, run, ranks[0]["answers"][key],
                                  host_cache)
                if run["timed"]:
                    t0, t1 = (ranks[r]["times"][key] for r in range(2))
                    fuse = ("its collectives, with the wait for the other "
                            "rank," if len(lay["ims"]) > 1 else
                            "its fuse (a data group of one rank: no "
                            "cross-rank collective, so host copies and the "
                            "card shared with the other rank's step)")
                    shape = " x ".join(
                        map(str, lay["batches"][run["batch"]]["t"].shape))
                    say(f"[time] mesh {key.replace('/', ' ')} ({shape}, "
                        f"max_blocks {run['max_blocks']}): step "
                        f"{t0[0]:.4f} / {t1[0]:.4f} ms (rank 0 / rank 1), "
                        f"{fuse} {t0[1]:.4f} / {t1[1]:.4f} ms (share "
                        f"{t0[1] / t0[0]:.4f} / {t1[1] / t1[0]:.4f}); "
                        f"medians of {MESH_REPS}, host clock, both ranks "
                        f"on one card; equals the {what} version ({card})")
        check_s = time.perf_counter() - t
        launches = [r["launches"] for r in ranks]
        if any(r["launches"] != r["steps"] for r in ranks):
            fail(f"mesh: dvbyte_decode launches {launches} against steps "
                 f"{[r['steps'] for r in ranks]}")
        if any(r["device"] != torch.cuda.get_device_name(0) for r in ranks):
            fail("a mesh rank ran on another device")
    finally:
        for f in (folder, *m2["folders"]):
            shutil.rmtree(f, ignore_errors=True)
    say(f"[mesh] every answer equals sharded_query_plain with the plain "
        f"decode on the same images (conjunctive bitmaps and counts, "
        f"ranked_sparse docids and scores "
        f"within rtol {PARITY_RTOL}, ranked within {HOST_RTOL} with "
        f"near-tie swaps), every host batch the host oracle; dvbyte_decode "
        f"launches per rank {launches}, one per step; the world took "
        f"{world_s:.3f} s, the checks {check_s:.3f} s, the phase "
        f"{time.perf_counter() - t_phase:.3f} s ({card})")
    return {"launches": launches}


# --------------------------------------------------------------------------
# phase 6: Path A, the variable-growth kernel backend at full scale
# --------------------------------------------------------------------------


def expected_kernel_launches(eng, queries, backends) -> tuple[int, int]:
    """(intersect, topk_score) launches the kernel backend makes for the
    kernel-served queries among ``queries``: one per conjunctive query of
    two or more terms that all have postings (tombstoned ones included),
    for all its further lists at once; one per ranked query with a live
    posting."""
    ix = ts = 0
    for q, b in zip(queries, backends):
        if b != "kernel":
            continue
        tids = [eng.term_id(t) for t in q.terms]
        if q.mode == "conjunctive":
            if len(tids) > 1 and all(t is not None
                                     and eng._appended_fts[t] > 0
                                     for t in tids):
                ix += 1
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


def time_intersect(label: str, a, lists) -> dict:
    """``intersect`` of ``a`` against the sorted ``lists`` in one launch:
    the kernel against the one PyTorch call per list (``torch.isin``, ANDed)
    and an empty kernel on the same grid (the launch floor) in turns, its
    plain version and its bound.  ``torch.isin`` waits for the card within
    a call, so its time holds the host's (the line says so)."""
    import torch
    from repro_torch.kernels.intersect.kernel import (empty_launch,
                                                      intersect_kernel)
    from repro_torch.kernels.intersect.ref import (intersect_all_ref,
                                                   intersect_ref)
    if len(lists) == 1:
        b, off = lists[0], None
        plain_fn = lambda: intersect_ref(a, b)                # noqa: E731
    else:
        b, off = concat_lists(lists)
        bounds = off.tolist()
        plain_fn = lambda: intersect_all_ref(a, b, bounds)    # noqa: E731

    def library():
        hit = torch.isin(a, lists[0])
        for x in lists[1:]:
            hit &= torch.isin(a, x)
        return hit

    t = device_ms_in_turns(lambda: intersect_kernel(a, b, off), library,
                           lambda: empty_launch(a.numel(), a.device))
    plain = cuda_ms(plain_fn, REPS)
    bound = bound_ms(4 * a.numel() + 4 * b.numel() + a.numel())
    say(f"[time] {label} intersect: |a|={a.numel()}, {len(lists)} further "
        f"list(s) of {[int(x.numel()) for x in lists]}: kernel "
        f"{t['ms']:.4f} ms, torch.isin {t['library_ms']:.4f} ms, empty "
        f"kernel on the same grid {t['floor_ms']:.4f} ms "
        f"{turns_text(t, 'torch.isin')}; plain version {plain:.4f} ms "
        f"(median of {REPS}); bound {bound:.6f} ms (bytes); parity exact, "
        f"rerun bit-identical")
    return dict(ms=t["ms"], plain_ms=plain, library_ms=t["library_ms"],
                bound_ms=bound, floor_ms=t["floor_ms"])


def time_score(label: str, d, w, n: int, offsets) -> dict:
    """``topk_score`` at one input (``offsets`` the segment bounds on the
    host): the kernel against ``zeros + index_add_`` in turns, its plain
    version and its bound."""
    import torch
    from repro_torch.kernels.topk_score.kernel import score_kernel
    from repro_torch.kernels.topk_score.ref import score_ref
    ot = torch.tensor([int(x) for x in offsets], dtype=torch.int32,
                      device=d.device)
    dl = d.long()
    t = device_ms_in_turns(
        lambda: score_kernel(d, w, n, ot),
        lambda: torch.zeros(n, device=d.device).index_add_(0, dl, w))
    plain = cuda_ms(lambda: score_ref(d, w, n, offsets), REPS)
    bound = bound_ms(8 * d.numel() + 4 * ot.numel() + 4 * n)
    say(f"[time] {label} topk_score: M={d.numel()} postings in "
        f"{ot.numel() - 1} segments, n_docs={n}: kernel {t['ms']:.4f} ms, "
        f"zeros + index_add_ {t['library_ms']:.4f} ms "
        f"{turns_text(t, 'library')}; plain version {plain:.4f} ms (median "
        f"of {REPS}); bound {bound:.6f} ms (bytes), kernel at "
        f"{bound / t['ms']:.3f} of it; parity exact, rerun bit-identical")
    return dict(ms=t["ms"], plain_ms=plain, library_ms=t["library_ms"],
                bound_ms=bound)


#: synthetic ranked inputs over Path A's 98,733 docids: segment sizes for
#: Path A's largest shape (4 segments, 290,352 postings) and, off the path,
#: 9 and 40 segments of about the same total
SCORE_SWEEP = {4: (96_000, 80_000, 62_000, 52_352), 9: (32_000,) * 9,
               40: (7_000,) * 40}


def score_sweep(dev, nsegs, n_docs: int = 98_733) -> dict:
    """``topk_score`` on seeded synthetic postings with ``nsegs`` segments
    (keys of ``SCORE_SWEEP``): parity exact, rerun bit-identical, timed."""
    import torch
    from repro_torch.kernels.topk_score.kernel import score_kernel
    from repro_torch.kernels.topk_score.ref import score_ref
    g = np.random.default_rng(29)
    out = {}
    for nseg in nsegs:
        ds, off = [], [0]
        for size in SCORE_SWEEP[nseg]:
            ds.append(np.sort(g.choice(np.arange(1, n_docs), size=size,
                                       replace=False)).astype(np.int32))
            off.append(off[-1] + size)
        d = torch.from_numpy(np.concatenate(ds)).to(dev)
        w = torch.from_numpy((g.random(off[-1]) * 5).astype(np.float32)).to(
            dev)
        ot = torch.tensor(off, dtype=torch.int32, device=dev)
        exact_and_repeatable("topk_score", score_kernel(d, w, n_docs, ot),
                             score_kernel(d, w, n_docs, ot),
                             score_ref(d, w, n_docs, off))
        where = "Path A's shape" if nseg == 4 else "off the path"
        out[nseg] = time_score(f"synthetic ({where})", d, w, n_docs, off)
    return out


def time_round(eng, groups, label: str) -> dict:
    """Per-query kernel-backend time by mode, end to end and its host
    postings decode; then each kernel at the round's largest shapes against
    its plain version, its bound and the one PyTorch call for the same
    function."""
    import torch
    from repro_torch.engine import Query
    from repro_torch.kernels.intersect.kernel import intersect_kernel
    from repro_torch.kernels.intersect.ref import (intersect_all_ref,
                                                   intersect_ref)
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
    # list against its longest, and its launch against all its lists
    best = None
    for q in groups[0]:
        lists = kb.conjunctive_lists(q)
        if lists is not None and len(lists) > 1 and (
                best is None or len(lists[0]) + len(lists[-1])
                > len(best[0]) + len(best[-1])):
            best = lists
    out = {}
    if best is not None:
        a, *rest = (torch.from_numpy(x).to(dev) for x in best)
        b, off = concat_lists(rest)
        err = exact_and_repeatable("intersect", intersect_kernel(a, b, off),
                                   intersect_kernel(a, b, off),
                                   intersect_all_ref(a, b, off))
        err = max(err, exact_and_repeatable(
            "intersect", intersect_kernel(a, rest[-1]),
            intersect_kernel(a, rest[-1]), intersect_ref(a, rest[-1])))
        out["intersect"] = dict(time_intersect(
            f"{label}, the longest lists", a, rest[-1:]), max_abs_err=err)
        if len(rest) > 1:
            out["intersect"]["path_query"] = time_intersect(
                f"{label}, that query's launch", a, rest)
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
        out["topk_score"] = dict(time_score(label, d, w, n, best[2]),
                                 max_abs_err=err)
    return out


def triangle_path(n_docs: int, const_index: tuple[float, int]) -> dict:
    """Path A: the first ``n_docs`` documents of the WSJ1-like stream into
    a Triangle-growth engine on the card, one query round at 90 % through
    the service, unforced and forced to the kernel backend (timed), then
    at the end 8 deletes and a second round, untimed: ``intersect`` and
    ``topk_score`` with tombstones.  ``const_index`` is the Const path's
    (bytes per posting, documents), compared at the same document
    count."""
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
    batch: list[list[str]] = []
    t_gen = time.perf_counter()

    def query_round(label, timed_too=True):
        groups = [zipf_queries(rng, names, probs, eng, 32, mode)
                  for mode in MODES]
        for k, v in serve_round(eng, svc, groups, label).items():
            launches[k] += v
        if timed_too:
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
                query_round(f"round 1 ({round_at} docs)")
    wall_s = time.perf_counter() - t_gen
    while len(eng.index.tombstones) < 8:
        d = int(rng.integers(1, eng.index.num_docs + 1))
        if d not in eng.index.tombstones:
            svc.delete(d)
    query_round(f"round 2 ({eng.index.num_docs} docs, 8 deletes)",
                timed_too=False)
    st = eng.stats()
    say(f"[ingest] triangle: {st.num_docs} docs, {st.num_postings} postings "
        f"in {st.ingest_time_s:.3f} s of add_documents ({wall_s:.3f} s with "
        f"generation and round 1): {st.num_docs / st.ingest_time_s:.1f} "
        f"docs/s")
    if tri_bpp is None:
        fail(f"Path A's stream never reached the Const path's {const_docs} "
             f"documents")
    say(f"[index] at {const_docs} docs (the same stream prefix): triangle "
        f"{tri_bpp:.4f} bytes/posting vs const {const_bpp:.4f}; triangle "
        f"{eng.index.bytes_per_posting():.4f} at {st.num_docs} docs (host "
        f"dynamic index incl. hash; paper §5.4: Triangle growth keeps "
        f"Θ(√n) space overhead)")
    torch.cuda.synchronize()
    for name in launches:
        if launches[name] == 0 or name not in timed:
            fail(f"Path A never launched {name}")
    out = {name: dict(timed[name], launches=launches[name])
           for name in launches}
    out["topk_score"]["off_path"] = {
        f"{nseg} segments": {k: r[k] for k in ("ms", "library_ms")}
        for nseg, r in score_sweep(eng.device, (9, 40)).items()}
    return out


def intersect_inputs(dev):
    """A seeded intersect case at Path A's round-2 shape: 91,737 sorted
    docids of 98,732, and three further lists (all 98,732 docids, then
    90,000 and 95,000 of them)."""
    import torch
    g = np.random.default_rng(31)
    ids = np.arange(1, 98_733)
    a = np.sort(g.choice(ids, size=91_737, replace=False))
    lists = [ids] + [np.sort(g.choice(ids, size=n, replace=False))
                     for n in (90_000, 95_000)]
    return (torch.from_numpy(a.astype(np.int32)).to(dev),
            [torch.from_numpy(x.astype(np.int32)).to(dev) for x in lists])


def kernel_shapes(dev) -> None:
    """``--kernels``: the kernels that have a library call, against it, on
    seeded inputs at the paths' shapes (Path A's round 2, the hybrid path's
    largest candidate set, retrieval_cand), without driving the paths."""
    from repro_torch.configs.two_tower_retrieval import CFG, RETRIEVAL_CAND
    from repro_torch.kernels.intersect.kernel import intersect_kernel
    from repro_torch.kernels.intersect.ref import intersect_all_ref
    score_sweep(dev, (4, 9, 40))
    a, lists = intersect_inputs(dev)
    for n in (1, 3):
        b, off = concat_lists(lists[:n])
        exact_and_repeatable("intersect", intersect_kernel(a, b, off),
                             intersect_kernel(a, b, off),
                             intersect_all_ref(a, b, off))
        time_intersect("synthetic (Path A's shape)", a, lists[:n])
    for n in (73_474, RETRIEVAL_CAND):
        seeded_dot(f"synthetic, n={n}", n, CFG.embed_dim, dev)


# --------------------------------------------------------------------------
# phase 6: the LM serving path
# --------------------------------------------------------------------------

LM_ARCHS = ("llama3.2-3b", "granite-moe-3b-a800m")
LM_SHALLOW = 2          # (a): layers of the float32 models at full width
LM_PREFILL = 64         # (a): prefill tokens per sequence (B = 2)
LM_DECODE = 8           # (a): greedy decode steps after the prefill
LM_TOL = 1e-4           # (a): max |card - CPU| over max |CPU|, float32
LM_STEPS = 32           # (b), (c): greedy decode steps through serve_lm
LM_BATCH, LM_SEQ = 2, 128   # (b), (c): serve_lm's B and S, the reference's
LM_PROFILED = 3         # (b), (c): decode steps under torch.profiler
LM_LONG = 32_768        # page overheads also at decode_32k's length
LM_DEVICE = "cuda"
def _params_to(params: dict, device) -> dict:
    return {"embed": params["embed"].to(device),
            "layers": {n: w.to(device) for n, w in params["layers"].items()},
            "ln_f": params["ln_f"].to(device),
            "out_proj": params["out_proj"].to(device)}


def _rel_err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _kernel_counters() -> dict:
    """The five kernels' modules, their launch counts set to 0."""
    import importlib
    from repro_torch.kernels import build
    counters = {name: importlib.import_module(
        f"repro_torch.kernels.{name}.kernel") for name in build.SOURCES}
    for mod in counters.values():
        mod.launches = 0
    return counters


def lm_against_cpu(arch_id: str) -> dict:
    """Phase 6 (a): ``arch_id`` at full width and ``LM_SHALLOW`` layers in
    float32, drawn once on the card and copied to the CPU; a prefill of
    ``LM_PREFILL`` tokens per sequence and ``LM_DECODE`` greedy decode
    steps on both.  Every logit and the final K/V caches must agree within
    ``LM_TOL`` of the CPU's largest |value|, the greedy tokens and the
    tokens an MoE drops at capacity must be equal; for a dense model,
    prefill(t + 1)'s last logits must equal decode after prefill(t) on the
    card within the same tolerance (an MoE's prefill drops tokens, so
    they differ there as in the reference)."""
    import torch
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    cfg = replace(get_arch(arch_id).cfg, n_layers=LM_SHALLOW,
                  dtype=torch.float32)
    card = LM(cfg, device=LM_DEVICE,
              generator=torch.Generator(device=LM_DEVICE).manual_seed(1))
    host = LM(cfg, device="cpu", params=_params_to(card.params(), "cpu"))
    gb = sum(p.numel() * p.element_size() for p in card.parameters()) / 1e9
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (LM_BATCH, LM_PREFILL + 1)))
    runs = {}
    for name, model in (("card", card), ("cpu", host)):
        t = toks.to(model.device)
        drops: list = []
        logits, cache = model.prefill(t[:, :LM_PREFILL],
                                      max_len=LM_PREFILL + LM_DECODE,
                                      drops=drops)
        seen, greedy = [logits], []
        for i in range(LM_DECODE):
            tok = torch.argmax(logits[:, :cfg.vocab], -1)
            greedy.append(tok)
            logits, cache = model.decode(cache, tok, LM_PREFILL + i,
                                         drops=drops)
            seen.append(logits)
        runs[name] = {"logits": torch.stack(seen).cpu(),
                      "k": cache["k"].cpu(), "v": cache["v"].cpu(),
                      "tokens": torch.stack(greedy).cpu(),
                      "dropped": sum(int(d) for d in drops)}
    c, h = runs["card"], runs["cpu"]
    errs = {key: _rel_err(c[key], h[key]) for key in ("logits", "k", "v")}
    if not torch.equal(c["tokens"], h["tokens"]):
        fail(f"[lm] {arch_id}: greedy tokens on the card {c['tokens']} "
             f"differ from the CPU's {h['tokens']}")
    if max(errs.values()) > LM_TOL:
        fail(f"[lm] {arch_id}: card against CPU {errs} > {LM_TOL}")
    if c["dropped"] != h["dropped"]:
        fail(f"[lm] {arch_id}: the card dropped {c['dropped']} tokens at "
             f"capacity, the CPU {h['dropped']}")
    consistency = None
    if cfg.moe is None:
        t = toks.to(card.device)
        full, _ = card.prefill(t)
        _, cache = card.prefill(t[:, :LM_PREFILL], max_len=LM_PREFILL + 1)
        dec, _ = card.decode(cache, t[:, LM_PREFILL], LM_PREFILL)
        consistency = _rel_err(dec, full)
        if consistency > LM_TOL:
            fail(f"[lm] {arch_id}: decode after prefill({LM_PREFILL}) "
                 f"differs from prefill({LM_PREFILL + 1}) by {consistency} "
                 f"> {LM_TOL}")
    del card, host
    _free_card()
    wall = time.perf_counter() - t0
    say(f"[lm] (a) {arch_id} at full width, {LM_SHALLOW} layers, float32 "
        f"({gb:.3f} GB, drawn on the card, copied to the CPU; TF32 off): "
        f"prefill {LM_BATCH} x {LM_PREFILL} and {LM_DECODE} greedy decode "
        f"steps, card against CPU: logits {errs['logits']:.3e}, K "
        f"{errs['k']:.3e}, V {errs['v']:.3e} of the CPU's max |value| "
        f"(tolerance {LM_TOL}); greedy tokens equal "
        f"{c['tokens'][:, 0].tolist()}...; (token, slot) pairs dropped at "
        f"capacity: {c['dropped']} on both"
        + ("" if consistency is None else
           f"; prefill({LM_PREFILL + 1}) against decode after "
           f"prefill({LM_PREFILL}) on the card: {consistency:.3e}")
        + f"; {wall:.1f} s")
    return {"errs": errs, "consistency": consistency,
            "dropped": c["dropped"], "s": wall}


def decode_profile(model) -> dict:
    """Where a decode step's time goes, at serve_lm's shapes:
    ``LM_PROFILED`` steps under ``torch.profiler`` (CPU and CUDA
    activities), each ending in a synchronize.  Returns the wall ms per
    step (host clock, profiler on), the device's busy ms per step (the
    sum of the CUDA kernels' durations), its idle share, the kernels per
    step, the five kernels that took most device time, and the host syncs
    inside the steps (``aten::_local_scalar_dense``, ``aten::nonzero``:
    none is allowed, the decode path must not wait for the card).  Where
    the profiler records no device time, the busy ms is None and the
    device time per step comes from CUDA events around each step
    (``event_ms``: the device's time including its idle gaps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = model.new_cache(LM_BATCH, LM_SEQ)
    tok = torch.zeros(LM_BATCH, dtype=torch.int64, device=model.device)

    def step():
        model.decode(cache, tok, LM_STEPS - 1)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    events = []
    for _ in range(LM_PROFILED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        b.synchronize()
        events.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILED):
            step()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / LM_PROFILED
    kernels, syncs = {}, {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if getattr(e, "device_type", None) == DeviceType.CUDA and dev > 0:
            kernels[e.key] = (dev / 1e3 / LM_PROFILED, e.count)
        if e.key in ("aten::_local_scalar_dense", "aten::nonzero",
                     "aten::item"):
            syncs[e.key] = e.count
    if any(syncs.values()):
        fail(f"[lm] the decode step waits for the card: {syncs}")
    busy = sum(ms for ms, _ in kernels.values()) or None
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle": None if busy is None else 1 - busy / wall_ms,
            "kernels": sum(n for _, n in kernels.values()) / LM_PROFILED,
            "event_ms": float(np.median(events)),
            "top": [(name[:60], ms) for name, (ms, _) in top]}


def lm_step_bytes(model) -> int:
    """Bytes a decode step at serve_lm's shapes must move: every layer's
    weights (an MoE's padded experts too: the step computes each at
    capacity) and ``ln_f``/``out_proj`` read once, the embedding rows of
    the batch, the K/V cache read once, the logits written."""
    cfg = model.cfg
    esize = model.embed.element_size()
    weights = sum(w.numel() for w in model.layers.values()) + \
        model.ln_f.numel() + model.out_proj.numel()
    kv = 2 * cfg.n_layers * LM_BATCH * LM_SEQ * cfg.n_kv_heads * cfg.d_head
    rows = LM_BATCH * cfg.d_model
    logits = LM_BATCH * cfg.vocab_padded
    return (weights + kv + rows + logits) * esize


def lm_serve(arch_id: str) -> dict:
    """Phase 6 (b) and (c): ``arch_id`` at full width and full depth in
    bf16, drawn on the card from seed 0, through ``serve_lm`` (B = 2, S =
    128, ``LM_STEPS`` greedy steps, the Triangle ``PagedKVCache``); then
    a profiled window of decode steps; then ``serve_lm(cfg=...)``, which
    draws the model from the same seed itself, whose tokens must be the
    same.  Logits must be finite, and an MoE must drop
    no token at decode (N = 2 is within every expert's capacity)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.lm import LM, moe_capacity
    from repro_torch.serve import PagedKVCache
    cfg = get_arch(arch_id).cfg
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LM(cfg, device=LM_DEVICE,
               generator=torch.Generator(device=LM_DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    first = serve_lm(LM_STEPS, model=model)
    params = sum(p.numel() for p in model.parameters())
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    nbytes = lm_step_bytes(model)
    prof = decode_profile(model)
    del model
    _free_card()
    second = serve_lm(LM_STEPS, cfg=cfg, device=LM_DEVICE)
    _free_card()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runs = (first, second)
    if not np.array_equal(first["tokens"], second["tokens"]):
        fail(f"[lm] {arch_id}: a second run from the same seed gave other "
             f"tokens")
    if not (first["finite"] and second["finite"]):
        fail(f"[lm] {arch_id}: logits not finite")
    if cfg.moe is not None:
        C = moe_capacity(cfg, LM_BATCH)
        if first["dropped"] or second["dropped"] or C < LM_BATCH:
            fail(f"[lm] {arch_id}: {first['dropped']} / "
                 f"{second['dropped']} tokens dropped at decode (C = {C})")
    const = PagedKVCache(n_pages=256, page_tokens=16, policy="const")
    for b in range(LM_BATCH):
        const.add_sequence(b)
        const.append_tokens(b, LM_STEPS)
    const_ovh = [const.overhead_tokens(b) for b in range(LM_BATCH)]
    long = {}                   # one sequence at decode_32k's length
    for policy in ("triangle", "const"):
        pool = PagedKVCache(n_pages=4096, page_tokens=16, policy=policy)
        pool.add_sequence(0)
        pool.append_tokens(0, LM_LONG)
        long[policy] = (pool.overhead_tokens(0),
                        len(pool.seqs[0].page_capacity))
    steps_ms = [t * 1e3 for r in runs for t in r["step_s"][1:]]
    ms = float(np.median(steps_ms))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    moe = ("" if cfg.moe is None else
           f"; {cfg.moe.n_experts} experts padded to {cfg.n_experts_padded}"
           f", top-{cfg.moe.top_k}, each at capacity "
           f"{moe_capacity(cfg, LM_BATCH)}: no token dropped")
    say(f"[lm] ({'b' if cfg.moe is None else 'c'}) {arch_id} at full width "
        f"and depth, bf16: {cfg.n_layers} layers, {params / 1e6:.1f} M "
        f"parameters, {gb:.3f} GB (drawn on the card in {init_s:.2f} s); "
        f"serve_lm B={LM_BATCH}, S={LM_SEQ}, {LM_STEPS} greedy steps, with "
        f"that model and with serve_lm's own draw from seed 0: tokens equal "
        f"{first['tokens'][0, :8].tolist()}..., logits finite{moe}")
    busy = prof["busy_ms"]
    dev_ms = busy if busy is not None else prof["event_ms"]
    say(f"[time] lm {arch_id} decode step: {ms:.3f} ms median on the "
        f"host's clock (steps 2-{LM_STEPS} of both runs, each ending in a "
        f"synchronize; step 1 {first['step_s'][0] * 1e3:.1f} / "
        f"{second['step_s'][0] * 1e3:.1f} ms); bound {bound:.3f} ms "
        f"({nbytes / 1e9:.3f} GB per step over 3.35 TB/s: the weights, the "
        f"K/V cache, the logits), ms/bound {ms / bound:.2f}; peak memory "
        f"{peak_gb:.2f} GB; {card_line()}")
    if busy is None:
        say(f"[time] lm {arch_id} under torch.profiler: no device time "
            f"recorded; CUDA events around a step: {prof['event_ms']:.3f} "
            f"ms (device time with its idle gaps)")
    else:
        say(f"[time] lm {arch_id} under torch.profiler ({LM_PROFILED} "
            f"steps): {prof['wall_ms']:.3f} ms a step, the card busy "
            f"{busy:.3f} ms of it (idle share {prof['idle']:.3f}) in "
            f"{prof['kernels']:.0f} kernels a step, {nbytes / busy / 1e6:.0f}"
            f" GB/s while busy, busy/bound {busy / bound:.2f}; CUDA events "
            f"around a step {prof['event_ms']:.3f} ms; most device time: "
            + "; ".join(f"{name} {t:.3f} ms" for name, t in prof["top"]))
    say(f"[lm] {arch_id} page overhead per sequence after {LM_STEPS} "
        f"tokens: Triangle {first['overhead']} tokens "
        f"({len(first['pool'].seqs[0].page_capacity)} pages of "
        f"{first['pool'].seqs[0].page_capacity}) against Const {const_ovh} "
        f"({len(const.seqs[0].page_capacity)} pages of 16); at {LM_LONG} "
        f"tokens (decode_32k's length): Triangle {long['triangle'][0]} "
        f"tokens in {long['triangle'][1]} pages against Const "
        f"{long['const'][0]} in {long['const'][1]}")
    return {"ms": ms, "device_ms": dev_ms, "profile": prof,
            "bound_ms": bound, "bytes": nbytes, "params": params,
            "overhead": first["overhead"], "const_overhead": const_ovh,
            "peak_gb": peak_gb}


def lm_phase() -> dict:
    """Phase 6, the LM serving path: (a) for each of ``LM_ARCHS``, then
    (b) llama3.2-3b and (c) granite-moe-3b-a800m through ``serve_lm``.
    The five kernels' counts are set to 0 before it and read after: the
    LM path launches none of them."""
    counters = _kernel_counters()
    t0 = time.perf_counter()
    out = {"parity": {a: lm_against_cpu(a) for a in LM_ARCHS},
           "serve": {a: lm_serve(a) for a in LM_ARCHS}}
    launched = {name: mod.launches for name, mod in counters.items()}
    if any(launched.values()):
        fail(f"[lm] the LM path launched {launched}")
    out["s"] = time.perf_counter() - t0
    say(f"[lm] phase 6 took {out['s']:.1f} s; launches of the five "
        f"hand-written kernels during it: {launched} (the LM path's "
        f"attention, norms, FFNs and MoE dispatch are torch ops and "
        f"cuBLAS products; it reaches no Pallas kernel in the reference)")
    return out


# --------------------------------------------------------------------------
# phase 7: the LM training path
# --------------------------------------------------------------------------

TRAIN_ARCHS = LM_ARCHS  # (a): card against CPU, at full width
TRAIN_SHALLOW = 2       # (a), (c): layers at full width
TRAIN_AB = (2, 64)      # (a): B x S of the one step, float32
TRAIN_TOL = 1e-5        # (a): loss and gnorm, card against CPU, relative
TRAIN_GRAD_TOL = 1e-4   # (a): each leaf's max |difference| / its max |g|
TRAIN_OPT_TOL = 1e-6    # (a): AdamW from the same gradients, per leaf
TRAIN_BATCH = 4         # (b): train_4k's batch of 256, cut to one card's 4
TRAIN_SEQ = 2048        # (b): train_4k's sequence (configs/common.py) of
#                         4,096, halved for the run's time: 4 x 4,096 fits
#                         (53.1 GB peak) but took 6.0 s a step, and the
#                         default run passed 800 s on a slow host
TRAIN_STEPS = 6         # (b), (c): steps of the straight runs
TRAIN_PEAK_LR = 3e-4    # (b), (c): cosine_schedule's peak ...
TRAIN_WARMUP = 2        # ... and warmup steps, over TRAIN_STEPS
RESUME_AB = (4, 512)    # (c): B x S of each step
RESUME_EVERY = 2        # (c): ckpt_every of the interrupted run
TRAIN_DEVICE = "cuda"
BF16_FLOPS = 989e12     # H100 SXM, dense bf16


def _grad_capture(store: dict):
    """An optimizer_update for make_train_step that keeps the gradients
    and changes nothing."""
    from repro_torch.optim.adamw import global_norm

    def update(p, g, s):
        store["grads"] = g
        return p, s, global_norm(g)
    return update


def _leaf_err(got, want) -> float:
    """max |got - want| over max |want| (0 where both are all zero),
    computed on got's device."""
    got, want = got.float(), want.to(got.device).float()
    top = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / top if top else (0.0 if diff == 0 else float("inf"))


def _host_gb(*trees) -> float:
    from repro_torch import tree
    return sum(t.numel() * t.element_size() for t in tree.leaves(trees)
               if t.device.type == "cpu") / 1e9


def _lr(step):
    from repro_torch.optim import cosine_schedule
    return cosine_schedule(step, TRAIN_PEAK_LR, TRAIN_WARMUP, TRAIN_STEPS)


def train_against_cpu(arch_id: str) -> dict:
    """Phase 7 (a): ``arch_id`` at full width, ``TRAIN_SHALLOW`` layers, in
    float32 (TF32 off), drawn once on the card and copied to the CPU; one
    ``make_train_step`` step of the config's microbatches at ``TRAIN_AB``
    from ``TokenBatches`` on both, its gradients kept.  The loss and the
    gnorm must agree within ``TRAIN_TOL``, each leaf's gradient within
    ``TRAIN_GRAD_TOL`` of that leaf's max |g|, and an MoE's forward over
    the same microbatches must drop the same (token, slot) pairs at
    capacity.  Then one AdamW update from the CPU's gradients on both:
    parameters and moments within ``TRAIN_OPT_TOL`` of each leaf's max
    |value|.  The updated parameters of two gradient computations are
    never compared: an element whose gradient is near 0 may flip its sign
    at step 1 (AdamW's m/sqrt(v) is +-1) and then differs by 2 lr."""
    import torch
    from dataclasses import replace
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenBatches
    from repro_torch.models import lm as lm_mod
    from repro_torch.optim import adamw_init, adamw_update
    t0 = time.perf_counter()
    cfg = replace(get_arch(arch_id).cfg, n_layers=TRAIN_SHALLOW,
                  dtype=torch.float32)
    B, S = TRAIN_AB
    card = lm_mod.init_params(
        cfg, TRAIN_DEVICE,
        torch.Generator(device=TRAIN_DEVICE).manual_seed(1))
    host = _params_to(card, "cpu")
    batch = TokenBatches(cfg.vocab, B, S).batch_at(0)
    runs, secs = {}, {}
    for name, params in (("card", card), ("cpu", host)):
        dev = params["embed"].device
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        store: dict = {}
        step = lm_mod.make_train_step(cfg, _grad_capture(store))
        ts = time.perf_counter()
        _, _, loss, gnorm = step(params, None, b)
        secs[f"{name} step"] = time.perf_counter() - ts
        drops: list = []
        sz = B // cfg.microbatch
        with torch.no_grad():
            for i in range(cfg.microbatch if cfg.moe else 0):
                lm_mod.forward(params, b["tokens"][i * sz:(i + 1) * sz],
                               cfg, drops=drops)
        runs[name] = {"loss": float(loss), "gnorm": float(gnorm),
                      "grads": store["grads"],
                      "dropped": sum(int(d) for d in drops)}
    c, h = runs["card"], runs["cpu"]
    loss_err = abs(c["loss"] - h["loss"]) / abs(h["loss"])
    gnorm_err = abs(c["gnorm"] - h["gnorm"]) / abs(h["gnorm"])
    grads = h["grads"]                  # the CPU's, on the card too
    grads_card = tree.tree_map(lambda t: t.to(TRAIN_DEVICE), grads)
    grad_errs = [_leaf_err(g, w) for g, w in
                 zip(tree.leaves(c["grads"]), tree.leaves(grads_card))]
    dropped = c["dropped"]
    if max(loss_err, gnorm_err) > TRAIN_TOL:
        fail(f"[train] {arch_id}: loss {c['loss']} / {h['loss']}, gnorm "
             f"{c['gnorm']} / {h['gnorm']} on the card / the CPU, beyond "
             f"{TRAIN_TOL}")
    if max(grad_errs) > TRAIN_GRAD_TOL:
        fail(f"[train] {arch_id}: gradient leaves card against CPU "
             f"{grad_errs} > {TRAIN_GRAD_TOL} of each leaf's max |g|")
    if c["dropped"] != h["dropped"]:
        fail(f"[train] {arch_id}: the card dropped {c['dropped']} tokens at "
             f"capacity, the CPU {h['dropped']}")
    # the optimizer alone, fed the CPU's gradients on both
    del runs, c, h
    out = {}
    for name, params, g in (("card", card, grads_card),
                            ("cpu", host, grads)):
        ts = time.perf_counter()
        state = adamw_init(params)
        adamw_update(params, g, state, TRAIN_PEAK_LR)
        float(state.step)
        secs[f"{name} AdamW"] = time.perf_counter() - ts
        out[name] = (params, state)
    host_gb = _host_gb(host, grads, out["cpu"][1])
    opt_errs = [_leaf_err(a, b) for a, b in
                zip(tree.leaves(out["card"]), tree.leaves(out["cpu"]))]
    if max(opt_errs) > TRAIN_OPT_TOL:
        fail(f"[train] {arch_id}: one AdamW update from the same gradients, "
             f"card against CPU {opt_errs} > {TRAIN_OPT_TOL}")
    del card, host, grads, grads_card, out
    _free_card()
    wall = time.perf_counter() - t0
    say(f"[train] (a) {arch_id} at full width, {TRAIN_SHALLOW} layers, "
        f"float32 (drawn on the card, copied to the CPU; TF32 off): one "
        f"make_train_step step at B={B}, S={S} in {cfg.microbatch} "
        f"microbatches, card against CPU: loss {loss_err:.3e}, gnorm "
        f"{gnorm_err:.3e} (tolerance {TRAIN_TOL}); the "
        f"{len(grad_errs)} gradient leaves within {max(grad_errs):.3e} of "
        f"each leaf's max |g| (tolerance {TRAIN_GRAD_TOL}); (token, slot) "
        f"pairs dropped at capacity: {dropped} on both; one AdamW update "
        f"from the same gradients: parameters and moments within "
        f"{max(opt_errs):.3e} (tolerance {TRAIN_OPT_TOL}); host memory "
        f"held {host_gb:.1f} GB; {wall:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    return {"loss": loss_err, "gnorm": gnorm_err, "grad": max(grad_errs),
            "opt": max(opt_errs), "dropped": dropped, "host_gb": host_gb,
            "s": wall}


class _OneBatch:
    """``batch_at`` that gives batch 0 at every step (phase 7 (b))."""

    def __init__(self, data):
        self.batch = data.batch_at(0)

    def batch_at(self, step):
        return self.batch


def train_profile(step) -> dict:
    """One more train step under ``torch.profiler`` with the CUDA activity
    alone (a step launches ~145,000 kernels; recording its CPU ops too
    doubled the step and took minutes to summarise), ending in a
    synchronize: its wall ms on the host's clock (profiler on), the
    card's busy ms (the durations of its kernels, copies and fills
    summed: one stream, so none overlap), their count, and the five
    kernels with most device time.  Where the profiler records no device
    time, the busy ms is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ts = time.perf_counter()
    kernels: dict = {}
    # the raw device events: key_averages() builds a Python object per
    # event and took 30 s over a step's
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e6
            k[1] += 1
    busy = sum(ms for ms, _ in kernels.values()) or None
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "kernels": sum(n for _, n in kernels.values()),
            "summary_s": time.perf_counter() - ts,
            "top": [(name[:60], ms) for name, (ms, _) in top]}


def train_flops(cfg, tokens: int) -> tuple[float, int]:
    """(6 N T, N): N the parameters a token's products use, the layers'
    and ``out_proj``'s (the embedding is a gather); attention's own
    products (the scores and the weighted sum) are not in it."""
    D, H, KV, dh, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head, cfg.d_ff)
    layer = D * H * dh + 2 * D * KV * dh + H * dh * D + 3 * D * Fd + 2 * D
    n = cfg.n_layers * layer + D * cfg.vocab_padded + D
    return 6.0 * n * tokens, n


def train_full() -> dict:
    """Phase 7 (b): llama3.2-3b at full width and depth in bf16 (the
    config's microbatch 2, remat, q_chunk 512, kv_chunk 1,024, loss_chunk
    512) through ``launch.train.train_lm`` and the Trainer without
    checkpoints: ``TRAIN_STEPS`` AdamW steps (moments float32, the cosine
    schedule) on one ``TokenBatches`` batch of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` repeated.  Every loss and gnorm finite, no step skipped
    (the step counter reads ``TRAIN_STEPS``), the last loss below the
    first.  Then one more step under the profiler."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import TokenBatches
    from repro_torch.launch.train import train_lm
    cfg = get_arch("llama3.2-3b").cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_lm(cfg, TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   device=TRAIN_DEVICE, lr=_lr, log_every=0,
                   data=_OneBatch(TokenBatches(cfg.vocab, TRAIN_BATCH,
                                               TRAIN_SEQ)))
    wall = time.perf_counter() - t0
    trainer = run["trainer"]
    m = trainer.metrics
    losses = [x["loss"] for x in m]
    gnorms = [x["gnorm"] for x in m]
    if not all(np.isfinite(losses + gnorms)):
        fail(f"[train] (b) losses {losses}, gnorms {gnorms}: not finite")
    if int(trainer.opt_state.step) != TRAIN_STEPS:
        fail(f"[train] (b) {int(trainer.opt_state.step)} of {TRAIN_STEPS} "
             f"steps were applied")
    if not losses[-1] < losses[0]:
        fail(f"[train] (b) the loss did not fall: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params = sum(t.numel() for t in trainer.params["layers"].values()) + \
        sum(trainer.params[k].numel() for k in ("embed", "ln_f",
                                                "out_proj"))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, n = train_flops(cfg, tokens)
    bound_ms = flops / BF16_FLOPS * 1e3
    ms = float(np.median([x["sec"] for x in m[1:]])) * 1e3
    batch = {k: torch.from_numpy(v).to(TRAIN_DEVICE) for k, v in
             TokenBatches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ)
             .batch_at(0).items()}
    prof = train_profile(lambda: trainer.train_step(
        trainer.params, trainer.opt_state, batch))
    del trainer, run
    _free_card()
    say(f"[train] (b) llama3.2-3b at full width and depth, bf16 "
        f"({cfg.n_layers} layers, {params / 1e6:.1f} M parameters, AdamW "
        f"moments float32), remat, microbatch {cfg.microbatch}, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step (train_4k's batch of "
        f"256 cut to 4, its sequence of 4,096 to {TRAIN_SEQ}) on one batch "
        f"repeated, "
        f"cosine_schedule(peak {TRAIN_PEAK_LR}, warmup {TRAIN_WARMUP}, "
        f"total {TRAIN_STEPS}), {TRAIN_STEPS} steps through train_lm and "
        f"the Trainer: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; gnorms "
        + ", ".join(f"{x:.3f}" for x in gnorms)
        + f"; every step applied; {wall:.1f} s with the draw")
    busy = prof["busy_ms"]
    idle = None if busy is None else 1 - busy / ms
    say(f"[time] train llama3.2-3b step: {ms:.1f} ms median of steps "
        f"2-{TRAIN_STEPS} on the host's clock (each ending in a "
        f"synchronize; step 1 {m[0]['sec'] * 1e3:.1f} ms), "
        f"{tokens / ms * 1e3:.0f} tokens/s; compute bound {bound_ms:.1f} ms "
        f"(6 x {n / 1e9:.3f} G parameters x {tokens} tokens over 989 "
        f"TFLOP/s, attention's products not counted), ms/bound "
        f"{ms / bound_ms:.2f}; peak memory {peak_gb:.2f} GB; {card_line()}")
    if busy is None:
        say(f"[time] train llama3.2-3b under torch.profiler: no device "
            f"time recorded; {prof['wall_ms']:.1f} ms a step")
    else:
        say(f"[time] train llama3.2-3b under torch.profiler (one step, "
            f"CUDA activity): {prof['wall_ms']:.1f} ms, the card busy "
            f"{busy:.1f} ms in {prof['kernels']} kernels: idle share "
            f"{idle:.3f} of the unprofiled step's {ms:.1f} ms "
            f"({1 - busy / prof['wall_ms']:.3f} of the profiled one), "
            f"busy/bound {busy / bound_ms:.2f}; summarised in "
            f"{prof['summary_s']:.1f} s; most device time: "
            + "; ".join(f"{name} {t:.1f} ms" for name, t in prof["top"]))
    return {"ms": ms, "bound_ms": bound_ms, "losses": losses,
            "gnorms": gnorms, "peak_gb": peak_gb, "profile": prof,
            "idle": idle, "s": wall}


def train_resume() -> dict:
    """Phase 7 (c): llama3.2-3b at full width, ``TRAIN_SHALLOW`` layers,
    bf16 weights and bf16 moments (``opt_dtype``, the reference's
    PaLM-style option), ``RESUME_AB`` a step from ``TokenBatches``.
    ``TRAIN_STEPS`` steps straight; then half of them with an async
    checkpoint every ``RESUME_EVERY`` steps and the final blocking save,
    and a new run from freshly drawn parameters (another seed) on the same
    directory, which must resume at the next step and run to the end.
    Parameters, moments and the step counter must equal the straight
    run's bit for bit, and so must the resumed steps' losses.  The saves
    (the caller's part: the host copy, and the write where blocking) and
    the restore are timed."""
    import torch
    from dataclasses import replace
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_lm
    cfg = replace(get_arch("llama3.2-3b").cfg, n_layers=TRAIN_SHALLOW,
                  opt_dtype=torch.bfloat16)
    B, S = RESUME_AB
    half = TRAIN_STEPS // 2
    kw = dict(batch=B, seq=S, device=TRAIN_DEVICE, lr=_lr, log_every=0)
    t0 = time.perf_counter()
    straight = train_lm(cfg, TRAIN_STEPS, **kw)["trainer"]
    want = [t.cpu() for t in tree.leaves((straight.params,
                                          straight.opt_state))]
    losses = [x["loss"] for x in straight.metrics]
    del straight
    _free_card()
    folder = Path(tempfile.mkdtemp(prefix="train-resume-"))
    times = {"save": [], "restore": []}
    save, restore = CheckpointManager.save, CheckpointManager.restore

    def timed_save(self, *a, **k):
        ts = time.perf_counter()
        save(self, *a, **k)
        times["save"].append(time.perf_counter() - ts)

    def timed_restore(self, *a, **k):
        ts = time.perf_counter()
        out = restore(self, *a, **k)
        torch.cuda.synchronize()
        times["restore"].append(time.perf_counter() - ts)
        return out

    CheckpointManager.save, CheckpointManager.restore = \
        timed_save, timed_restore
    try:
        free_gb = shutil.disk_usage(folder).free / 1e9
        first = train_lm(cfg, half, ckpt_dir=str(folder),
                         ckpt_every=RESUME_EVERY, **kw)["trainer"]
        saved = first.ckpt.all_steps()
        del first
        _free_card()
        lines: list = []
        second = train_lm(cfg, TRAIN_STEPS - half, ckpt_dir=str(folder),
                          ckpt_every=RESUME_EVERY, seed=2,
                          log_fn=lines.append, **kw)["trainer"]
        second.ckpt.wait()
        ckpt_gb = sum(f.stat().st_size for f in
                      (folder / f"step-{saved[-1]:010d}").iterdir()) / 1e9
    finally:
        CheckpointManager.save, CheckpointManager.restore = save, restore
        shutil.rmtree(folder, ignore_errors=True)
    got = [t.cpu() for t in tree.leaves((second.params, second.opt_state))]
    resumed = [x["loss"] for x in second.metrics]
    wall = time.perf_counter() - t0
    if saved != [half - 1] or lines[:1] != [f"[trainer] resumed from step "
                                           f"{half - 1}"]:
        fail(f"[train] (c) checkpoints {saved}, log {lines[:1]}: the run "
             f"did not resume at step {half}")
    if [x["step"] for x in second.metrics] != list(range(half,
                                                         TRAIN_STEPS)):
        fail(f"[train] (c) the resumed run took steps "
             f"{[x['step'] for x in second.metrics]}")
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    if not all(same) or len(got) != len(want):
        fail(f"[train] (c) the resumed parameters and moments differ from "
             f"the straight run's: {same.count(False)} of {len(same)} "
             f"leaves")
    if resumed != losses[half:]:
        fail(f"[train] (c) resumed losses {resumed} differ from the "
             f"straight run's {losses[half:]}")
    del second
    _free_card()
    say(f"[train] (c) llama3.2-3b at full width, {TRAIN_SHALLOW} layers, "
        f"bf16 weights and moments, {B} x {S} tokens a step: "
        f"{TRAIN_STEPS} steps straight against {half} steps (async "
        f"checkpoint every {RESUME_EVERY}, {ckpt_gb:.2f} GB each, "
        f"{free_gb:.0f} GB free there) and a new run from another draw that "
        f"resumed at step {half}: the {len(got)} leaves (parameters, "
        f"moments, the step counter) bit-identical, losses of steps "
        f"{half}-{TRAIN_STEPS - 1} equal ("
        + ", ".join(f"{x:.4f}" for x in resumed) + f"); {wall:.1f} s")
    say(f"[time] train checkpoint of {ckpt_gb:.2f} GB: saves "
        + ", ".join(f"{x:.2f}" for x in times["save"])
        + " s on the caller's thread (the host copy; the write too where "
        f"blocking), restore " + ", ".join(f"{x:.2f}" for x in
                                          times["restore"])
        + f" s; {card_line()}")
    return {"save_s": times["save"], "restore_s": times["restore"],
            "ckpt_gb": ckpt_gb, "s": wall}


def train_phase() -> dict:
    """Phase 7, the LM training path: (a) for each of ``TRAIN_ARCHS``, (b)
    llama3.2-3b at full width and depth, (c) the bit-identical resume.
    The five kernels' counts are set to 0 before it and read after: the
    training path launches none of them."""
    counters = _kernel_counters()
    t0 = time.perf_counter()
    out = {"parity": {a: train_against_cpu(a) for a in TRAIN_ARCHS},
           "full": train_full(), "resume": train_resume()}
    launched = {name: mod.launches for name, mod in counters.items()}
    if any(launched.values()):
        fail(f"[train] the training path launched {launched}")
    out["s"] = time.perf_counter() - t0
    say(f"[train] phase 7 took {out['s']:.1f} s; launches of the five "
        f"hand-written kernels during it: {launched} (the training path's "
        f"attention, norms, loss and AdamW are torch ops and cuBLAS "
        f"products; it reaches no Pallas kernel in the reference)")
    return out


# --------------------------------------------------------------------------
# phase 7b: the recsys path
# --------------------------------------------------------------------------

RECSYS_ARCHS = ("dlrm-mlperf", "sasrec", "din", "two-tower-retrieval")
RECSYS_CUT_ROWS = 4_096     # (a): rows a DLRM field or a table, for the
#                             CPU's side of the comparison
RECSYS_AB = 64              # (a): the batch of the comparison
RECSYS_TOL = 1e-5           # (a): outputs, loss, gnorm: max |card - CPU|
#                             over the CPU's max |value|, float32
RECSYS_GRAD_TOL = 1e-4      # (a): each gradient leaf, of its max |g|
RECSYS_OPT_TOL = 1e-6       # (a): AdamW from the same gradients, per leaf
RECSYS_STEPS = 4            # (b): AdamW steps on one batch repeated
RECSYS_LR = 1e-3            # (b): the reference's recsys rate
DLRM_ROW_CAP = 2_000_000    # (b): rows a DLRM field: Criteo-1TB's
#                             204,184,588 x 128 float32 (104.5 GB) do not
#                             fit the card's 80 GB
TWOTOWER_BATCH = 16_384     # (b): the two-tower's train batch: at 65,536
#                             the (B, B) float32 logits and their gradient
#                             alone take 34.4 GB
RECSYS_SERVE_REPS = 5       # serve: timed batches per shape (median)
F32_FLOPS = 67e12           # H100 SXM, float32 outside the tensor cores
RECSYS_DEVICE = "cuda"


def _recsys_cut(arch):
    """``arch`` with its tables cut to ``RECSYS_CUT_ROWS`` rows a DLRM
    field or a table, every width kept."""
    from dataclasses import replace
    c, n = arch.cfg, RECSYS_CUT_ROWS
    cfg = {"dlrm": lambda: replace(c, table_rows=(n,) * len(c.table_rows)),
           "sasrec": lambda: replace(c, n_items=n),
           "din": lambda: replace(c, n_items=n),
           "twotower": lambda: replace(c, n_users_vocab=n, n_items=n)}[
        arch.kind]()
    return replace(arch, cfg=cfg)


def _recsys_serve_batch(arch, B: int, seed: int = 0) -> dict:
    """A serve batch of ``B`` examples with ``_batch_specs(B, serve=True)``'s
    keys: the train batch's inputs, and for SASRec the specs' candidate
    items a user, drawn uniformly from the seed."""
    from repro_torch.data.recsys import ModelBatches
    b = ModelBatches(arch.kind, arch.cfg, B, seed=seed).batch_at(0)
    keys = arch._batch_specs(B, serve=True)
    if arch.kind == "sasrec":
        b["cands"] = np.random.default_rng(seed).integers(
            0, arch.cfg.n_items, tuple(keys["cands"].shape)).astype(np.int32)
    return {k: b[k] for k in keys}


def _on(batch: dict, device) -> dict:
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def recsys_against_cpu(arch_id: str) -> dict:
    """Phase 7b (a): ``arch_id`` at its published widths, its tables cut
    to ``RECSYS_CUT_ROWS`` rows, float32 (TF32 off), drawn once on the card
    and copied to the CPU; a batch of ``RECSYS_AB`` through both: the
    serve output, the loss and gnorm of one ``make_train_step`` step and
    every gradient leaf, then one AdamW update from the CPU's gradients on
    both."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import ModelBatches
    from repro_torch.models.recsys import make_train_step
    from repro_torch.optim import adamw_init, adamw_update
    t0 = time.perf_counter()
    arch = _recsys_cut(get_arch(arch_id))
    card = arch.init(RECSYS_DEVICE, torch.Generator(
        device=RECSYS_DEVICE).manual_seed(1))
    host = tree.tree_map(lambda t: t.cpu(), card)
    train_b = ModelBatches(arch.kind, arch.cfg, RECSYS_AB).batch_at(0)
    serve_b = _recsys_serve_batch(arch, RECSYS_AB)
    loss_fn, serve_fn = arch.loss_and_serve()
    runs = {}
    for name, params in (("card", card), ("cpu", host)):
        dev = tree.leaves(params)[0].device
        with torch.no_grad():
            out = serve_fn(params, _on(serve_b, dev))
        store: dict = {}
        _, _, loss, gnorm = make_train_step(loss_fn, _grad_capture(store))(
            params, None, _on(train_b, dev))
        runs[name] = {"out": out, "loss": loss, "gnorm": gnorm,
                      "grads": store["grads"]}
    c, h = runs["card"], runs["cpu"]
    errs = {k: _rel_err(c[k].reshape(-1), h[k].reshape(-1))
            for k in ("out", "loss", "gnorm")}
    grads = h["grads"]
    grads_card = tree.tree_map(lambda t: t.to(RECSYS_DEVICE), grads)
    grad_errs = [_leaf_err(g, w) for g, w in
                 zip(tree.leaves(c["grads"]), tree.leaves(grads_card))]
    if max(errs.values()) > RECSYS_TOL:
        fail(f"[recsys] (a) {arch_id}: card against CPU {errs} > "
             f"{RECSYS_TOL}")
    if max(grad_errs) > RECSYS_GRAD_TOL:
        fail(f"[recsys] (a) {arch_id}: gradient leaves card against CPU "
             f"{grad_errs} > {RECSYS_GRAD_TOL} of each leaf's max |g|")
    del runs, c, h
    done = {}
    for name, params, g in (("card", card, grads_card), ("cpu", host, grads)):
        state = adamw_init(params)
        adamw_update(params, g, state, RECSYS_LR)
        done[name] = (params, state)
    opt_errs = [_leaf_err(a, b) for a, b in
                zip(tree.leaves(done["card"]), tree.leaves(done["cpu"]))]
    if max(opt_errs) > RECSYS_OPT_TOL:
        fail(f"[recsys] (a) {arch_id}: one AdamW update from the same "
             f"gradients, card against CPU {opt_errs} > {RECSYS_OPT_TOL}")
    n_params = sum(t.numel() for t in tree.leaves(card))
    del card, host, grads, grads_card, done
    _free_card()
    wall = time.perf_counter() - t0
    say(f"[recsys] (a) {arch_id} at its published widths, tables cut to "
        f"{RECSYS_CUT_ROWS} rows a field or table ({n_params / 1e6:.1f} M "
        f"parameters), float32 (drawn on the card, copied to the CPU; TF32 "
        f"off), a batch of {RECSYS_AB}, card against CPU: serve output "
        f"{errs['out']:.3e}, loss {errs['loss']:.3e}, gnorm "
        f"{errs['gnorm']:.3e} (tolerance {RECSYS_TOL}); the "
        f"{len(grad_errs)} gradient leaves within {max(grad_errs):.3e} of "
        f"each leaf's max |g| (tolerance {RECSYS_GRAD_TOL}); one AdamW "
        f"update from the same gradients within {max(opt_errs):.3e} "
        f"(tolerance {RECSYS_OPT_TOL}); {wall:.1f} s")
    return {**errs, "grad": max(grad_errs), "opt": max(opt_errs), "s": wall}


def recsys_full(arch_id: str) -> dict:
    """Phase 7b (b): ``arch_id`` at full scale on the card (DLRM's fields
    capped at ``DLRM_ROW_CAP`` rows), ``RECSYS_STEPS`` AdamW steps through
    ``train_recsys`` and the Trainer on one ``ModelBatches`` batch of
    train_batch's 65,536 (the two-tower's ``TWOTOWER_BATCH``) repeated:
    every loss finite and applied, the last below the first; then served
    at serve_p99 (and DLRM at serve_bulk).  Each shape's median ms beside
    its compute bound, and the peak memory; one more train step under
    ``torch.profiler``."""
    import torch
    from dataclasses import replace
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import REC_SHAPES
    from repro_torch.data.recsys import ModelBatches
    from repro_torch.launch.train import train_recsys
    arch = get_arch(arch_id)
    cut = ""
    if arch.kind == "dlrm":
        rows = tuple(min(r, DLRM_ROW_CAP) for r in arch.cfg.table_rows)
        arch = replace(arch, cfg=replace(arch.cfg, table_rows=rows))
        cut = (f"; fields capped at {DLRM_ROW_CAP:,} rows: "
               f"{sum(rows):,} rows padded to {arch.cfg.total_rows:,} of "
               f"Criteo-1TB's 204,184,588")
    B = REC_SHAPES["train_batch"]["batch"]
    if arch.kind == "twotower":
        B = TWOTOWER_BATCH
        cut = f"; train batch {B:,} of train_batch's 65,536"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = _OneBatch(ModelBatches(arch.kind, arch.cfg, B))
    data_s = time.perf_counter() - t0
    run = train_recsys(arch, None, RECSYS_STEPS, batch=B,
                       device=RECSYS_DEVICE, lr=RECSYS_LR, log_every=0,
                       data=data)
    wall = time.perf_counter() - t0
    trainer = run["trainer"]
    m = trainer.metrics
    losses = [x["loss"] for x in m]
    gnorms = [x["gnorm"] for x in m]
    if not all(np.isfinite(losses + gnorms)):
        fail(f"[recsys] (b) {arch_id}: losses {losses}, gnorms {gnorms}: "
             f"not finite")
    if int(trainer.opt_state.step) != RECSYS_STEPS:
        fail(f"[recsys] (b) {arch_id}: {int(trainer.opt_state.step)} of "
             f"{RECSYS_STEPS} steps were applied")
    if not losses[-1] < losses[0]:
        fail(f"[recsys] (b) {arch_id}: the loss did not fall: {losses}")
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    params = trainer.params
    gb = sum(t.numel() * t.element_size() for t in tree.leaves(params)) / 1e9
    ms = float(np.median([x["sec"] for x in m[1:]])) * 1e3
    bound = arch.flops("train_batch", batch=B) / F32_FLOPS * 1e3
    out = {"train_ms": ms, "train_bound_ms": bound, "losses": losses,
           "train_peak_gb": train_peak, "serve": {}}
    batch = _on(data.batch, RECSYS_DEVICE)
    prof = train_profile(lambda: trainer.train_step(
        trainer.params, trainer.opt_state, batch))
    out["profile"] = prof
    say(f"[recsys] (b) {arch_id} at full scale ({gb:.2f} GB of float32 "
        f"parameters{cut}), {RECSYS_STEPS} AdamW steps (lr {RECSYS_LR}, "
        f"moments float32) through train_recsys and the Trainer on one "
        f"ModelBatches batch of {B:,} repeated (drawn in {data_s:.1f} s): "
        f"losses " + ", ".join(f"{x:.4f}" for x in losses) + "; gnorms "
        + ", ".join(f"{x:.3f}" for x in gnorms)
        + f"; every step applied; {wall:.1f} s with the draw")
    say(f"[time] recsys {arch_id} train step at B={B:,}: {ms:.1f} ms median "
        f"of steps 2-{RECSYS_STEPS} on the host's clock (each ending in a "
        f"synchronize; step 1 {m[0]['sec'] * 1e3:.1f} ms), "
        f"{B / ms * 1e3:,.0f} examples/s; compute bound {bound:.2f} ms "
        f"(RecsysArch.flops at B={B:,} over 67 TFLOP/s float32), ms/bound "
        f"{ms / bound:.1f}; peak memory {train_peak:.2f} GB; {card_line()}")
    busy = prof["busy_ms"]
    if busy is None:
        say(f"[time] recsys {arch_id} under torch.profiler: no device "
            f"time recorded; {prof['wall_ms']:.1f} ms a step")
    else:
        out["idle"] = 1 - busy / ms
        say(f"[time] recsys {arch_id} train step under torch.profiler "
            f"(CUDA activity): {prof['wall_ms']:.1f} ms, the card busy "
            f"{busy:.1f} ms in {prof['kernels']} kernels: idle share "
            f"{out['idle']:.3f} of the unprofiled step's {ms:.1f} ms; "
            f"most device time: " + "; ".join(
                f"{name} {t:.1f} ms" for name, t in prof["top"]))
    del data, run, trainer, batch
    _, serve_fn = arch.loss_and_serve()
    shapes = ["serve_p99"] + (["serve_bulk"] if arch.kind == "dlrm" else [])
    for shape in shapes:
        Bs = REC_SHAPES[shape]["batch"]
        batch = _on(_recsys_serve_batch(arch, Bs, seed=2), RECSYS_DEVICE)
        torch.cuda.reset_peak_memory_stats()
        times = []
        with torch.no_grad():
            for _ in range(RECSYS_SERVE_REPS + 1):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                scores = serve_fn(params, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - ts) * 1e3)
        want = tuple(arch._batch_specs(Bs, serve=True)["cands"].shape) \
            if arch.kind == "sasrec" else (Bs,)
        if tuple(scores.shape) != want or not torch.isfinite(scores).all():
            fail(f"[recsys] serve {arch_id} {shape}: scores of shape "
                 f"{tuple(scores.shape)} (want {want}), finite "
                 f"{bool(torch.isfinite(scores).all())}")
        sms = float(np.median(times[1:]))
        sbound = arch.flops(shape) / F32_FLOPS * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        out["serve"][shape] = {"ms": sms, "bound_ms": sbound, "peak_gb": peak}
        say(f"[time] recsys {arch_id} serve at {shape} (B={Bs:,}): "
            f"{sms:.2f} ms median of {RECSYS_SERVE_REPS} batches (first "
            f"{times[0]:.2f} ms), {Bs / sms * 1e3:,.0f} examples/s; compute "
            f"bound {sbound:.3f} ms (RecsysArch.flops over 67 TFLOP/s "
            f"float32), ms/bound {sms / sbound:.1f}; peak memory "
            f"{peak:.2f} GB; {card_line()}")
        del batch, scores
    del params
    _free_card()
    out["s"] = time.perf_counter() - t0
    return out


def recsys_phase() -> dict:
    """Phase 7b, the recsys path: (a) each of ``RECSYS_ARCHS`` card against
    CPU at its widths, (b) each at full scale, trained and served.  The
    five kernels' counts are set to 0 before it and read after: the path
    launches none of them."""
    counters = _kernel_counters()
    t0 = time.perf_counter()
    say(f"[recsys] cuts: (a) tables of {RECSYS_CUT_ROWS:,} rows a field or "
        f"table for the CPU's side; (b) DLRM's fields capped at "
        f"{DLRM_ROW_CAP:,} rows (Criteo-1TB's 104.5 GB of float32 tables "
        f"exceed the card), the two-tower's train batch "
        f"{TWOTOWER_BATCH:,} of 65,536; SASRec, DIN and the two-tower "
        f"keep their full tables")
    out = {"parity": {a: recsys_against_cpu(a) for a in RECSYS_ARCHS},
           "full": {a: recsys_full(a) for a in RECSYS_ARCHS}}
    launched = {name: mod.launches for name, mod in counters.items()}
    if any(launched.values()):
        fail(f"[recsys] the recsys path launched {launched}")
    out["s"] = time.perf_counter() - t0
    say(f"[recsys] phase 7b took {out['s']:.1f} s; launches of the five "
        f"hand-written kernels during it: {launched} (the recsys models "
        f"are torch ops and cuBLAS products; they reach no Pallas kernel "
        f"in the reference)")
    return out


# --------------------------------------------------------------------------
# phase 7c: the GNN path
# --------------------------------------------------------------------------

GNN_AB = (2_000, 4_096)     # (a): nodes and edges of the comparison graphs
GNN_AB_GRAPHS = 8           # (a): the regression head's graphs
GNN_AB_CHUNKS = 4           # (a): edge chunks of the chunked cases
GNN_TOL = 1e-5              # (a): outputs and loss: max |card - CPU| over
#                             the CPU's max |value|, float32
GNN_GRAD_TOL = 1e-4         # (a): each gradient leaf, of its max |g|
GNN_OPT_TOL = 1e-6          # (a): AdamW from the same gradients, per leaf
GNN_STEPS = 4               # (b): AdamW steps on one batch repeated
GNN_SHAPE_STEPS = 2         # (c): AdamW steps at molecule and full_graph_sm
GNN_LR = 1e-3               # the reference's GNN rate (GNNArch.build)
OGB_DEGREE = 26             # (b): synthetic_power_law draws n x 26 =
#                             63,674,754 edges; the first 61,859,140 in
#                             COO order are kept (ogbn-products' count)
GNN_DEVICE = "cuda"


def _gnn_batch(shape_id: str, cfg, seed: int = 0) -> dict:
    """A numpy batch at ``shape_id``'s counts, padded to 512 as the
    reference's ``GNNArch.build`` pads them (the padding masked):
    molecule's 128 graphs of 30 nodes, each with 64 edges inside it;
    full_graph_sm's graph from ``synthetic_power_law`` (degree 4, its
    first 10,556 edges).  Features N(0, 1), distances uniform on [0,
    cutoff), labels uniform over the classes, targets N(0, 1)."""
    from repro_torch.configs.common import GNN_SHAPES, _pad512
    from repro_torch.data.graph import edges_coo, synthetic_power_law
    s = GNN_SHAPES[shape_id]
    N, E = s["n_nodes"], s["n_edges"]
    Np, Ep = _pad512(N), _pad512(E)
    rng = np.random.default_rng(seed)
    src, dst = np.zeros(Ep, np.int32), np.zeros(Ep, np.int32)
    if shape_id == "molecule":
        G = s["n_graphs"]
        per_n, per_e = N // G, E // G
        base = np.repeat(np.arange(G) * per_n, per_e)
        src[:E] = base + rng.integers(0, per_n, E)
        dst[:E] = base + rng.integers(0, per_n, E)
    else:
        g = synthetic_power_law(N, 4, seed=seed)
        a, b = edges_coo(g)
        src[:E], dst[:E] = a[:E], b[:E]
    mask = np.zeros(Np, np.float32)
    mask[:N] = 1
    out = {"node_feat": rng.standard_normal((Np, cfg.d_feat)).astype(
               np.float32),
           "src": src, "dst": dst,
           "dist": (rng.random(Ep) * cfg.cutoff).astype(np.float32),
           "edge_mask": np.arange(Ep) < E, "node_mask": mask}
    if cfg.n_out > 1:
        out["labels"] = rng.integers(0, cfg.n_out, Np).astype(np.int32)
    else:
        out["graph_ids"] = (np.arange(Np) // (N // s["n_graphs"])).clip(
            0, s["n_graphs"] - 1).astype(np.int32)
        out["target"] = rng.standard_normal(s["n_graphs"]).astype(np.float32)
    return out


def gnn_against_cpu(classify: bool, chunks: int) -> dict:
    """Phase 7c (a): SchNet at its published widths (3 interactions,
    d_hidden 64, 300 RBFs, cutoff 10) with the 47-class head and
    ogb_products' 100 features, or the regression head over
    ``GNN_AB_GRAPHS`` graphs and molecule's 16 features; a graph of
    ``GNN_AB`` nodes and edges, unchunked or in ``chunks`` edge chunks;
    float32 (TF32 off), drawn once on the card and copied to the CPU.  The
    outputs, the loss and every gradient leaf of one ``make_train_step``
    step on both, one AdamW update from the CPU's gradients on both, and
    ``compress_int8``/``ef_compress_tree`` of the CPU's gradients on both,
    bit for bit."""
    import torch
    from dataclasses import replace
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.distributed.compression import (ef_compress_tree,
                                                     ef_init)
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.optim import adamw_init, adamw_update
    t0 = time.perf_counter()
    N, E = GNN_AB
    G = 1 if classify else GNN_AB_GRAPHS
    cfg = replace(get_arch("schnet").base_cfg,
                  d_feat=100 if classify else 16,
                  n_out=47 if classify else 1,
                  edge_chunk=E // chunks if chunks > 1 else None)
    rng = np.random.default_rng(7)
    b = {"node_feat": rng.standard_normal((N, cfg.d_feat)).astype(
             np.float32),
         "src": rng.integers(0, N, E).astype(np.int32),
         "dst": rng.integers(0, N, E).astype(np.int32),
         "dist": (rng.random(E) * cfg.cutoff).astype(np.float32),
         "edge_mask": rng.random(E) < 0.95,
         "node_mask": np.ones(N, np.float32)}
    if classify:
        b["labels"] = rng.integers(0, 47, N).astype(np.int32)
    else:
        b["graph_ids"] = np.sort(rng.integers(0, G, N)).astype(np.int32)
        b["target"] = rng.standard_normal(G).astype(np.float32)
    card = gnn_mod.init_params(cfg, GNN_DEVICE, torch.Generator(
        device=GNN_DEVICE).manual_seed(1))
    host = tree.tree_map(lambda t: t.cpu(), card)
    runs = {}
    for name, params in (("card", card), ("cpu", host)):
        dev = tree.leaves(params)[0].device
        batch = _on(b, dev)
        with torch.no_grad():
            out = gnn_mod.forward(params, batch, cfg)
        store: dict = {}
        _, _, loss, _ = gnn_mod.make_train_step(
            cfg, _grad_capture(store), G)(params, None, batch)
        runs[name] = {"out": out, "loss": loss, "grads": store["grads"]}
    c, h = runs["card"], runs["cpu"]
    errs = {k: _rel_err(c[k].reshape(-1), h[k].reshape(-1))
            for k in ("out", "loss")}
    grads = h["grads"]
    grads_card = tree.tree_map(lambda t: t.to(GNN_DEVICE), grads)
    grad_errs = [_leaf_err(g, w) for g, w in
                 zip(tree.leaves(c["grads"]), tree.leaves(grads_card))]
    label = (f"{'47-class' if classify else 'regression'} head, "
             f"{f'{chunks} edge chunks' if chunks > 1 else 'unchunked'}")
    if max(errs.values()) > GNN_TOL:
        fail(f"[gnn] (a) {label}: card against CPU {errs} > {GNN_TOL}")
    if max(grad_errs) > GNN_GRAD_TOL:
        fail(f"[gnn] (a) {label}: gradient leaves card against CPU "
             f"{grad_errs} > {GNN_GRAD_TOL} of each leaf's max |g|")
    del runs, c, h
    done = {}
    for name, params, g in (("card", card, grads_card), ("cpu", host, grads)):
        state = adamw_init(params)
        adamw_update(params, g, state, GNN_LR)
        done[name] = (params, state)
    opt_errs = [_leaf_err(a, b) for a, b in
                zip(tree.leaves(done["card"]), tree.leaves(done["cpu"]))]
    if max(opt_errs) > GNN_OPT_TOL:
        fail(f"[gnn] (a) {label}: one AdamW update from the same "
             f"gradients, card against CPU {opt_errs} > {GNN_OPT_TOL}")
    # int8 compression with error feedback, two steps, of the same tree
    packs = {}
    for name, g in (("card", grads_card), ("cpu", grads)):
        ef = ef_init(g)
        q1, ef = ef_compress_tree(g, ef)
        q2, ef = ef_compress_tree(g, ef)
        packs[name] = [t.cpu() for t in tree.leaves((q1, q2, ef.residual))]
    diff = [i for i, (a, b) in enumerate(zip(packs["card"], packs["cpu"]))
            if a.dtype != b.dtype or not torch.equal(a, b)]
    if diff:
        fail(f"[gnn] (a) {label}: compress_int8/ef_compress_tree card "
             f"against CPU differ in leaves {diff}")
    del card, host, grads, grads_card, done, packs
    _free_card()
    wall = time.perf_counter() - t0
    say(f"[gnn] (a) SchNet at its published widths, {label}, {N:,} nodes, "
        f"{E:,} edges, float32 (drawn on the card, copied to the CPU; TF32 "
        f"off), card against CPU: outputs {errs['out']:.3e}, loss "
        f"{errs['loss']:.3e} (tolerance {GNN_TOL}); the {len(grad_errs)} "
        f"gradient leaves within {max(grad_errs):.3e} of each leaf's max "
        f"|g| (tolerance {GNN_GRAD_TOL}); one AdamW update from the same "
        f"gradients within {max(opt_errs):.3e} (tolerance {GNN_OPT_TOL}); "
        f"two steps of ef_compress_tree over the same gradients: q, scales "
        f"and residuals bit for bit; {wall:.1f} s")
    return {**errs, "grad": max(grad_errs), "opt": max(opt_errs), "s": wall}


class _OgbDraw:
    """ogb_products' graph drawn on a thread (numpy releases the
    interpreter lock in its samplers and sorts), so that the draw overlaps
    the phase's other cases: ``synthetic_power_law(2,449,029,
    OGB_DEGREE)``'s COO edges cut to the shape's 61,859,140."""

    def __init__(self):
        import threading
        self.out: dict = {}
        self.thread = threading.Thread(target=self._draw, daemon=True)
        self.thread.start()

    def _draw(self):
        from repro_torch.configs.common import GNN_SHAPES
        from repro_torch.data.graph import edges_coo, synthetic_power_law
        try:
            s = GNN_SHAPES["ogb_products"]
            t0 = time.perf_counter()
            g = synthetic_power_law(s["n_nodes"], OGB_DEGREE, seed=0)
            src, dst = edges_coo(g)
            E = s["n_edges"]
            self.out = {"src": src[:E], "dst": dst[:E], "drawn": g.n_edges,
                        "s": time.perf_counter() - t0}
        except BaseException as e:      # re-raised by result()
            self.out = {"error": e}

    def result(self) -> dict:
        self.thread.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out


def gnn_ogb(draw: "_OgbDraw") -> dict:
    """Phase 7c (b): SchNet at ogb_products' full scale on the card
    (``GNNArch.cfg_for``: 100 features, 47 classes, 16 checkpointed
    chunks of 3,866,208 edges): the graph from :class:`_OgbDraw`, nodes
    and edges padded to 512 as the reference's ``GNNArch.build`` pads
    them, features N(0, 1), distances uniform on [0, cutoff) and labels
    uniform over the classes drawn on the card; ``GNN_STEPS`` AdamW steps
    through ``train_gnn`` and the Trainer on the one batch repeated, every
    loss finite and applied.  Its median ms beside the compute bound
    (``GNNArch.flops`` over 67 TFLOP/s float32), the peak memory, and one
    more step under ``torch.profiler``."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import GNN_SHAPES, _pad512
    from repro_torch.launch.train import train_gnn
    t0 = time.perf_counter()
    arch = get_arch("schnet")
    cfg = arch.cfg_for("ogb_products")
    s = GNN_SHAPES["ogb_products"]
    N, E = s["n_nodes"], s["n_edges"]
    Np, Ep = _pad512(N), _pad512(E)
    g = draw.result()
    wait = time.perf_counter() - t0
    indeg = np.bincount(g["dst"], minlength=N)
    hot = int(indeg.argmax())
    gen = torch.Generator(device=GNN_DEVICE).manual_seed(0)
    dev = GNN_DEVICE

    def pad(a, n, fill=0):
        t = torch.full((n,), fill, dtype=torch.int32, device=dev)
        t[:len(a)] = torch.from_numpy(a).to(dev)
        return t

    node_mask = torch.zeros(Np, device=dev)
    node_mask[:N] = 1
    batch = {"node_feat": torch.randn((Np, cfg.d_feat), generator=gen,
                                      device=dev),
             "src": pad(g["src"], Ep), "dst": pad(g["dst"], Ep),
             "dist": torch.rand(Ep, generator=gen, device=dev) * cfg.cutoff,
             "edge_mask": torch.arange(Ep, device=dev) < E,
             "node_mask": node_mask,
             "labels": torch.randint(0, cfg.n_out, (Np,), generator=gen,
                                     device=dev, dtype=torch.int32)}
    batch_gb = sum(t.numel() * t.element_size() for t in batch.values()) / 1e9

    class OneBatch:
        def batch_at(self, step):
            return batch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts = time.perf_counter()
    run = train_gnn(arch, GNN_STEPS, shape="ogb_products", data=OneBatch(),
                    device=dev, lr=GNN_LR, log_every=0,
                    name="schnet ogb_products")
    wall = time.perf_counter() - ts
    trainer = run["trainer"]
    m = trainer.metrics
    losses = [x["loss"] for x in m]
    gnorms = [x["gnorm"] for x in m]
    if not all(np.isfinite(losses + gnorms)):
        fail(f"[gnn] (b) ogb_products: losses {losses}, gnorms {gnorms}: "
             f"not finite")
    if int(trainer.opt_state.step) != GNN_STEPS:
        fail(f"[gnn] (b) ogb_products: {int(trainer.opt_state.step)} of "
             f"{GNN_STEPS} steps were applied")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median([x["sec"] for x in m[1:]])) * 1e3
    flops = arch.flops("ogb_products")
    bound = flops / F32_FLOPS * 1e3
    n_params = sum(t.numel() for t in tree.leaves(trainer.params))
    say(f"[gnn] (b) ogb_products at full scale: {N:,} nodes (padded to "
        f"{Np:,}), synthetic_power_law's {g['drawn']:,} edges at degree "
        f"{OGB_DEGREE} cut to the first {E:,} in COO order and padded to "
        f"{Ep:,} ({cfg.edge_chunk:,} a chunk, {Ep // cfg.edge_chunk} "
        f"checkpointed chunks), {cfg.d_feat} features, {cfg.n_out} classes, "
        f"{n_params:,} parameters; the draw took {g['s']:.1f} s on a thread "
        f"({wait:.1f} s of it waited for here), the batch {batch_gb:.2f} GB "
        f"on the card; the generator's largest in-degree {indeg[hot]:,} "
        f"(node {hot}), {indeg[hot] / E:.3f} of the edges (zipf(1.5) mod N: "
        f"a hot spot of the JAX package's generator, not of ogbn-products; "
        f"segment_sum's index_add_ adds its messages onto that one row)")
    say(f"[gnn] (b) {GNN_STEPS} AdamW steps (lr {GNN_LR}, moments float32) "
        f"through train_gnn and the Trainer on the one batch repeated: "
        f"losses " + ", ".join(f"{x:.4f}" for x in losses) + "; gnorms "
        + ", ".join(f"{x:.3f}" for x in gnorms)
        + f"; every step applied; {wall:.1f} s")
    say(f"[time] gnn ogb_products train step: {ms:.1f} ms median of steps "
        f"2-{GNN_STEPS} on the host's clock (each ending in a synchronize; "
        f"step 1 {m[0]['sec'] * 1e3:.1f} ms); compute bound {bound:.1f} ms "
        f"(GNNArch.flops {flops:.4g} over 67 TFLOP/s float32), ms/bound "
        f"{ms / bound:.2f}; peak memory {peak:.2f} GB; {card_line()}")
    out = {"ms": ms, "bound_ms": bound, "peak_gb": peak, "losses": losses,
           "hot_share": indeg[hot] / E}
    prof = train_profile(lambda: trainer.train_step(
        trainer.params, trainer.opt_state, batch))
    out["profile"] = prof
    busy = prof["busy_ms"]
    if busy is None:
        say(f"[time] gnn ogb_products under torch.profiler: no device time "
            f"recorded; {prof['wall_ms']:.1f} ms a step")
    else:
        out["idle"] = 1 - busy / ms
        say(f"[time] gnn ogb_products train step under torch.profiler "
            f"(CUDA activity): {prof['wall_ms']:.1f} ms, the card busy "
            f"{busy:.1f} ms in {prof['kernels']} kernels: idle share "
            f"{out['idle']:.3f} of the unprofiled step's {ms:.1f} ms; most "
            f"device time: " + "; ".join(
                f"{name} {t:.1f} ms" for name, t in prof["top"]))
    del run, trainer
    out["hot_row"] = _hot_row_cost(batch["dst"][:cfg.edge_chunk], Np,
                                   cfg.d_hidden, gen)
    del batch
    _free_card()
    out["s"] = time.perf_counter() - t0
    return out


def _hot_row_cost(dst, n: int, width: int, gen) -> dict:
    """How much the generator's hot row costs ``segment_sum``: one chunk's
    messages, (len(dst), width) float32, summed into ``n`` rows by the
    chunk's destinations and by as many uniform ones, in turns (median
    of 5 a side, CUDA events)."""
    import torch
    from repro_torch.sparse.ops import segment_sum
    msg = torch.randn((len(dst), width), generator=gen, device=dst.device)
    uniform = torch.randint(0, n, (len(dst),), generator=gen,
                            device=dst.device, dtype=dst.dtype)
    times = {"graph": [], "uniform": []}
    for _ in range(5):
        for name, ids in (("graph", dst), ("uniform", uniform),
                          ("uniform", uniform), ("graph", dst)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            segment_sum(msg, ids, n)
            b.record()
            torch.cuda.synchronize()
            times[name].append(a.elapsed_time(b))
    ms = {k: float(np.median(v)) for k, v in times.items()}
    share = float((dst == int(torch.bincount(dst.long()).argmax())).float()
                  .mean())
    say(f"[time] gnn segment_sum of one chunk's messages ({len(dst):,} x "
        f"{width} float32 into {n:,} rows): {ms['graph']:.3f} ms with the "
        f"graph's destinations (its most frequent one takes {share:.3f} of "
        f"them), {ms['uniform']:.3f} ms with uniform ones (medians of 10, "
        f"in turns, CUDA events); {card_line()}")
    del msg, uniform
    return {**ms, "share": share}


def gnn_shape(shape_id: str) -> dict:
    """Phase 7c (c): SchNet at ``shape_id``'s config and counts
    (:func:`_gnn_batch`), ``GNN_SHAPE_STEPS`` AdamW steps through
    ``train_gnn``: finite losses, each step's ms."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.launch.train import train_gnn
    t0 = time.perf_counter()
    arch = get_arch("schnet")
    cfg = arch.cfg_for(shape_id)
    s = GNN_SHAPES[shape_id]
    b = _gnn_batch(shape_id, cfg)

    class OneBatch:
        def batch_at(self, step):
            return b

    torch.cuda.reset_peak_memory_stats()
    run = train_gnn(arch, GNN_SHAPE_STEPS, shape=shape_id, data=OneBatch(),
                    n_graphs=s.get("n_graphs", 1), device=GNN_DEVICE,
                    lr=GNN_LR, log_every=0, name=f"schnet {shape_id}")
    m = run["trainer"].metrics
    losses = [x["loss"] for x in m]
    if not np.isfinite(losses).all():
        fail(f"[gnn] (c) {shape_id}: losses {losses} not finite")
    step_ms = [x["sec"] * 1e3 for x in m]
    bound = arch.flops(shape_id) / F32_FLOPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"[gnn] (c) {shape_id} ({s['n_nodes']:,} nodes, {s['n_edges']:,} "
        f"edges, {cfg.d_feat} features, "
        + (f"{cfg.n_out} classes" if cfg.n_out > 1
           else f"{s['n_graphs']} graphs, regression")
        + f"; padded to 512): {GNN_SHAPE_STEPS} AdamW steps through "
        f"train_gnn, losses " + ", ".join(f"{x:.4f}" for x in losses)
        + "; step ms " + ", ".join(f"{x:.1f}" for x in step_ms)
        + f" (the first with its allocations), compute bound {bound:.4f} "
        f"ms; peak memory {peak:.2f} GB; {card_line()}")
    del run
    _free_card()
    return {"ms": step_ms, "bound_ms": bound, "losses": losses,
            "s": time.perf_counter() - t0}


def gnn_phase() -> dict:
    """Phase 7c, the GNN path: (a) card against CPU at the published
    widths, both heads, unchunked and chunked; (c) molecule and
    full_graph_sm at their shapes; (b) ogb_products at full scale, its
    graph drawn on a thread while (a) and (c) run.  The five kernels'
    counts are set to 0 before it and read after: the path launches none
    of them."""
    counters = _kernel_counters()
    t0 = time.perf_counter()
    draw = _OgbDraw()
    out = {"parity": {f"{'class' if c else 'reg'}-{k}":
                      gnn_against_cpu(c, k)
                      for c in (False, True) for k in (1, GNN_AB_CHUNKS)},
           "shapes": {sid: gnn_shape(sid)
                      for sid in ("molecule", "full_graph_sm")},
           "ogb": gnn_ogb(draw)}
    launched = {name: mod.launches for name, mod in counters.items()}
    if any(launched.values()):
        fail(f"[gnn] the GNN path launched {launched}")
    out["s"] = time.perf_counter() - t0
    say(f"[gnn] phase 7c took {out['s']:.1f} s; launches of the five "
        f"hand-written kernels during it: {launched} (SchNet is torch ops, "
        f"index_add_ and cuBLAS products; it reaches no Pallas kernel in "
        f"the reference); not run: minibatch_lg (the JAX package defines "
        f"its shapes but no code that flattens sampled blocks into its "
        f"batch)")
    return out


# --------------------------------------------------------------------------
# phase 8: the dry run
# --------------------------------------------------------------------------

#: (a): the dry run's CLI arguments, each run as its own process (a fake
#: process group is process-wide), all side by side
DRYRUN_FAKE = (
    ("--arch", "llama3.2-3b", "--shape", "train_4k", "--probe"),
    ("--arch", "schnet", "--shape", "molecule", "--mesh", "both"),
    ("--arch", "dlrm-mlperf", "--shape", "train_batch", "--mesh", "both"),
    ("--arch", "paper_index", "--shape", "query_rank", "--mesh", "both"),
)
#: (b): the cells predicted on a fake one-rank world and run on the card
#: (arch, shape, probe layers): one a family
DRYRUN_CARD = (("llama3.2-3b", "train_4k", 2), ("schnet", "minibatch_lg", None),
               ("sasrec", "train_batch", None))
DRYRUN_LM_BATCH = 2       # (b): train_4k's batch of 256, cut to what one
#                           card holds: the probe cell at L = 2 keeps all
#                           28 layers' parameters and moments (36.1 GB),
#                           and a batch of 2 takes 36.7 GB more (predicted)
DRYRUN_PEAK_TOL = 0.10    # (b): predicted peak within 10 % of the measured
DRYRUN_HBM_GB = 80.0      # one H100's device memory, GB
DRYRUN_DEVICE = "cuda"
DRYRUN_TIMEOUT_S = 600


def dryrun_fake_start(out: Path) -> list:
    """(a): start the dry run's processes on fake worlds of 256 and 512
    ranks, fake ``DRYRUN_DEVICE`` tensors, writing records into ``out``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         DRYRUN_DEVICE, "--force", "--out", str(out), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for args in DRYRUN_FAKE]


def dryrun_fake_finish(procs: list, out: Path) -> list:
    """(a): wait for the processes, check every record and print one
    ``[dryrun]`` line a cell; any error fails."""
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        errs.append((p, "\n".join(line for line in err.splitlines()
                                   if "redistributing" not in line)))
    recs = []
    for path in sorted(out.glob("*.json")):
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            say(rec.get("traceback", ""))
            fail(f"[dryrun] {path.stem}: {rec.get('error')}")
        m = rec["memory"]
        args_gb, temp_gb = m["argument_bytes"] / 1e9, m["temp_bytes"] / 1e9
        say(f"[dryrun] {path.stem}: ok, per rank of {rec['chips']}: "
            f"arguments {args_gb:.3f} GB + temp {temp_gb:.3f} GB = "
            f"{args_gb + temp_gb:.3f} of {DRYRUN_HBM_GB:.0f} GB, "
            f"{rec['hlo_flops']:.4e} flops, link "
            f"{rec['collectives']['link_bytes'] / 1e9:.4f} GB, traced in "
            f"{rec['trace_s']} s")
        recs.append(rec)
    for p, err in errs:
        if p.returncode != 0:
            fail(f"[dryrun] {' '.join(p.args[2:])} exited "
                 f"{p.returncode}: {err[-3000:]}")
    if len(recs) != 8:
        fail(f"[dryrun] {len(recs)} records, not 8")
    return recs


def _card_args(cell, mesh, arch, gen) -> tuple:
    """The cell's arguments on the card as DTensors of its placements on a
    one-rank mesh: floats N(0, 0.02²), ids within their ranges, masks
    true, the AdamW moments and step zero."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import tree
    from repro_torch.configs.common import GNN_SHAPES
    c = getattr(arch, "cfg", None)
    if arch.family == "lm":
        bound = {"tokens": c.vocab, "labels": c.vocab}
    elif arch.family == "gnn":
        s = GNN_SHAPES[cell.shape_id]
        bound = {"src": s["n_nodes"], "dst": s["n_nodes"],
                 "labels": max(s["classify"], 1),
                 "graph_ids": s.get("n_graphs", 1)}
    else:
        bound = {k: c.n_items for k in ("seq", "pos", "neg", "cands")}
    out = []
    for arg, pls in zip(cell.args, cell.in_shardings):
        flat, treedef = tree.flatten(arg)
        made = []
        for name, x, pl in zip(tree.path_names(arg), flat, pls):
            key = name.split("/")[-1]
            if name.startswith((".mu", ".nu", ".step")):
                t = torch.zeros(x.shape, dtype=x.dtype, device=DRYRUN_DEVICE)
            elif x.dtype == torch.bool:
                t = torch.ones(x.shape, dtype=x.dtype, device=DRYRUN_DEVICE)
            elif x.dtype.is_floating_point:
                t = torch.empty(x.shape, dtype=x.dtype, device=DRYRUN_DEVICE)
                t.normal_(0.0, 0.02, generator=gen)
            else:
                t = torch.randint(0, bound[key], x.shape, generator=gen,
                                  device=DRYRUN_DEVICE).to(x.dtype)
            made.append(DTensor.from_local(t, mesh, pl, run_check=False))
        out.append(tree.unflatten(treedef, made))
    return tuple(out)


def dryrun_against_card(arch_id: str, shape_id: str, probe) -> dict:
    """(b): ``arch_id``'s cell predicted on a fake one-rank world (mesh
    data 1 x model 1, fake CUDA tensors), then built on a one-rank NCCL
    world and run on the card: the argument bytes allocated must equal the
    prediction, the peak growth of ``max_memory_allocated`` lie within
    ``DRYRUN_PEAK_TOL`` of the predicted peak (arguments and temp), and
    ``FlopCounterMode``'s count of the run equal the predicted flops."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import tree
    from repro_torch.configs import common, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    arch = get_arch(arch_id)
    saved = dict(common.LM_SHAPES["train_4k"])
    if arch.family == "lm":
        common.LM_SHAPES["train_4k"]["batch"] = DRYRUN_LM_BATCH
    store = Path(tempfile.mkdtemp(prefix="dryrun-pg-"))
    try:
        with fake_world(1):
            mesh = init_device_mesh(DRYRUN_DEVICE, (1, 1),
                                    mesh_dim_names=("data", "model"))
            pred = dryrun.trace_cell(
                dryrun.build_cell(arch_id, shape_id, mesh, probe), mesh,
                DRYRUN_DEVICE)
        dist.init_process_group("nccl" if DRYRUN_DEVICE == "cuda" else "gloo",
                                init_method=f"file://{store}/pg",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh(DRYRUN_DEVICE, (1, 1),
                                    mesh_dim_names=("data", "model"))
            cell = dryrun.build_cell(arch_id, shape_id, mesh, probe)
            # cuBLAS workspaces, one a handle, are allocated at a handle's
            # first product: make them now, for this thread and for the
            # autograd engine's, so that none lands inside a segment of
            # the cell's tensors and keeps it from being released
            for dt in (torch.float32, torch.bfloat16):
                w = torch.ones(64, 64, dtype=dt, device=DRYRUN_DEVICE,
                               requires_grad=True)
                (w @ w).sum().backward()
            del w
            _free_card()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            args = _card_args(cell, mesh, arch, torch.Generator(
                device=DRYRUN_DEVICE).manual_seed(0))
            torch.cuda.synchronize()
            allocated = torch.cuda.memory_allocated() - before
            torch.cuda.reset_peak_memory_stats()
            with FlopCounterMode(display=False) as counter:
                out = cell.fn(*args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            small = [x.full_tensor() if hasattr(x, "full_tensor") else x
                     for x in tree.leaves(out)
                     if x.dtype.is_floating_point and x.numel() <= 1 << 20]
            finite = all(bool(torch.isfinite(x).all()) for x in small)
            del small
            del out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = cell.fn(*args)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            del out, args, cell
        finally:
            dist.destroy_process_group()
    finally:
        common.LM_SHAPES["train_4k"] = saved
        shutil.rmtree(store, ignore_errors=True)
        _free_card()
    m = pred["memory"]
    want_peak = m["argument_bytes"] + m["temp_bytes"]
    row = dict(cell=f"{arch_id} {shape_id}" + (f" probe L={probe}" if probe
                                               else ""),
               args_pred=m["argument_bytes"], args_alloc=allocated,
               peak_pred=want_peak, peak_meas=peak,
               flops_pred=pred["hlo_flops"],
               flops_meas=float(counter.get_total_flops()), ms=ms,
               trace_s=pred["trace_s"])
    say(f"[dryrun] card {row['cell']}: arguments predicted "
        f"{row['args_pred']} B, allocated {allocated} B; peak predicted "
        f"{want_peak / 1e9:.4f} GB, measured {peak / 1e9:.4f} GB "
        f"({(want_peak - peak) / peak:+.4f}); flops predicted "
        f"{row['flops_pred']:.6e}, FlopCounterMode {row['flops_meas']:.6e}; "
        f"step {ms:.2f} ms by CUDA events (second step); traced in "
        f"{pred['trace_s']:.2f} s; {card_line()}")
    if not finite:
        fail(f"[dryrun] {row['cell']}: a non-finite output")
    if allocated != m["argument_bytes"]:
        fail(f"[dryrun] {row['cell']}: {allocated} argument bytes allocated, "
             f"{m['argument_bytes']} predicted")
    if abs(want_peak - peak) > DRYRUN_PEAK_TOL * peak:
        fail(f"[dryrun] {row['cell']}: peak predicted {want_peak}, "
             f"measured {peak}")
    if row["flops_pred"] != row["flops_meas"]:
        fail(f"[dryrun] {row['cell']}: flops predicted {row['flops_pred']}, "
             f"counted {row['flops_meas']}")
    return row


def dryrun_card_process() -> None:
    """(b) in a process of its own (:func:`dryrun_phase` starts it): the
    caching allocator starts empty there, as the prediction assumes, and
    not with the blocks earlier phases leave cached.  Prints each cell's
    line and, last, a JSON list of the rows; exits non-zero on a failed
    check or a kernel launch."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    counters = _kernel_counters()
    rows = [dryrun_against_card(*c) for c in DRYRUN_CARD]
    launched = {name: mod.launches for name, mod in counters.items()}
    if any(launched.values()):
        fail(f"[dryrun] the card cells launched {launched}")
    say(json.dumps(rows))


def _dryrun_card_start():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.dryrun_card_process()")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _dryrun_card_finish(proc) -> list:
    out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        say(line)
    if proc.returncode != 0 or not lines:
        say("\n".join(lines[-1:]))
        fail(f"[dryrun] the card cells' process exited {proc.returncode}: "
             + "\n".join(line for line in err.splitlines()
                         if "redistributing" not in line)[-3000:])
    return json.loads(lines[-1])


def dryrun_phase(everything: bool = False) -> dict:
    """Phase 8, the dry run: (a) the fake-world cells of ``DRYRUN_FAKE``
    in processes of their own while (b) checks ``DRYRUN_CARD``'s cells
    against the card in one more (:func:`dryrun_card_process`); with
    ``everything`` (``--dryrun-all``) (a) is every cell and every probe
    instead.  The five kernels' counts are set to 0 before it and read
    after, here and in (b)'s process: the dry run launches none of
    them."""
    counters = _kernel_counters()
    t0 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun-"))
    try:
        if everything:
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            for extra in ((), ("--probe",)):
                got = subprocess.run(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--device", DRYRUN_DEVICE, "--arch", "all", "--mesh",
                     "both", "--out", str(out_dir), *extra], env=env,
                    capture_output=True, text=True)
                say(got.stdout.strip())
                if got.returncode != 0:
                    fail(f"[dryrun] the sweep failed: {got.stderr[-2000:]}")
            return {"s": time.perf_counter() - t0}
        procs = dryrun_fake_start(out_dir)
        procs.append(_dryrun_card_start())
        try:
            card = _dryrun_card_finish(procs[-1])
            fake = dryrun_fake_finish(procs[:-1], out_dir)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    launched = {name: mod.launches for name, mod in counters.items()}
    if any(launched.values()):
        fail(f"[dryrun] the dry run launched {launched}")
    s = time.perf_counter() - t0
    say(f"[dryrun] phase 8 took {s:.1f} s; launches of the five "
        f"hand-written kernels during it: {launched} (the reference's dry "
        f"run reaches no Pallas kernel)")
    return {"fake": fake, "card": card, "s": s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=None,
                    help="documents in the Const path's WSJ1-like stream "
                         f"(default {CONST_DOCS}; {PLANNER_DOCS} with "
                         "--planner-only)")
    ap.add_argument("--kernels", action="store_true",
                    help="build and check every kernel, time the kernels "
                         "that have a library call on seeded inputs at the "
                         "paths' shapes, and stop: no path is driven")
    ap.add_argument("--term-ab", type=Path, metavar="DIR",
                    help="time the dvbyte_decode and intersect kernels of "
                         "another revision (DIR/dvbyte_decode.cu, "
                         "DIR/intersect.cu) against this checkout's in "
                         "turns on Path B's decode input (DIR/inputs.pt, "
                         "written first from a Const engine of --docs "
                         "documents) and Path A's intersect shape, then "
                         "check both, and stop: no path is driven")
    ap.add_argument("--tier-only", action="store_true",
                    help="build fused_query, ingest the Const stream of "
                         "--docs documents and run the tier phase on it "
                         "(freeze, serve, delta, snapshot, restore), and "
                         "stop: no other path is driven")
    ap.add_argument("--planner-only", action="store_true",
                    help="build fused_query, ingest the Const stream of "
                         "--docs documents and run the planner phase on it "
                         "(the measured crossover, then auto-collation on "
                         "an engine of its own), and stop: no other path "
                         "is driven")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build fused_query and run the fleet phase alone "
                         "(a two-shard fleet behind the pipelined service: "
                         "ingest, freeze, deletes, query rounds, traffic), "
                         "and stop: no other path is driven")
    ap.add_argument("--sanitize-only", action="store_true",
                    help="build fused_query and run the sanitized fleet "
                         "phase alone (phase 4b: the port's sanitizer over "
                         "a two-shard fleet with background freezes, then "
                         "a seeded inversion), and stop: no other path is "
                         "driven")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build dvbyte_decode, ingest what the mesh phase's "
                         "layouts need (the Const stream of --docs "
                         "documents to its freeze, the fleet's documents "
                         "into two shards) and run the mesh phase alone, "
                         "and stop: no other path is driven")
    ap.add_argument("--lm-only", action="store_true",
                    help="run phase 6, the LM serving path, alone (no "
                         "kernel is built: the path launches none), and "
                         "stop: no other path is driven")
    ap.add_argument("--train-only", action="store_true",
                    help="run phase 7, the LM training path, alone (no "
                         "kernel is built: the path launches none), and "
                         "stop: no other path is driven")
    ap.add_argument("--recsys-only", action="store_true",
                    help="run phase 7b, the recsys path, alone (no kernel "
                         "is built: the path launches none), and stop: no "
                         "other path is driven")
    ap.add_argument("--gnn-only", action="store_true",
                    help="run phase 7c, the GNN path, alone (no kernel is "
                         "built: the path launches none), and stop: no "
                         "other path is driven")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="run phase 8, the dry run, alone (no kernel is "
                         "built: it launches none), and stop: no other "
                         "path is driven")
    ap.add_argument("--dryrun-all", action="store_true",
                    help="run the dry run over every cell and probe on "
                         "fake worlds, and stop: no other path is driven "
                         "(hours: the LM prefill_32k and train_4k cells "
                         "at full depth trace for minutes to an hour "
                         "each)")
    ap.add_argument("--fused-only", type=Path, metavar="PT",
                    help="time the fused kernel alone on the main path's "
                         "prepared batches, read from PT (written there "
                         "first from a Const engine of --docs documents "
                         "where it does not exist), then check it, and "
                         "stop: no path is driven")
    args = ap.parse_args()
    planner_docs = args.docs or PLANNER_DOCS
    args.docs = args.docs or CONST_DOCS
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    # float32 products in full float32 (TF32 would drift 1e-3 from the
    # kernels): the two-tower towers and the plain versions run cuBLAS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch is missing: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    say(f"[card] {card_line()}")
    if args.term_ab:
        term_ab(args.term_ab, args.docs)
        say(f"[card] {card_line()}")
        say("[done] --term-ab: no path was driven")
        return 0
    if args.tier_only:
        build.build_all(["fused_query"])
        tier_only(args.docs)
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --tier-only: no other path was driven")
        return 0
    if args.planner_only:
        build.build_all(["fused_query"])
        c = const_engine(planner_docs, np.random.default_rng(2024))
        planner_phase(c["eng"], c["names"], c["probs"])
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --planner-only: no other path was driven")
        return 0
    if args.fleet_only:
        build.build_all(["fused_query"])
        fleet_phase(None)
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --fleet-only: no other path was driven")
        return 0
    if args.sanitize_only:
        build.build_all(["fused_query"])
        sanitize_phase()
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --sanitize-only: no other path was driven")
        return 0
    if args.lm_only:
        lm_phase()
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --lm-only: no other path was driven")
        return 0
    if args.train_only:
        train_phase()
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --train-only: no other path was driven")
        return 0
    if args.recsys_only:
        recsys_phase()
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --recsys-only: no other path was driven")
        return 0
    if args.gnn_only:
        gnn_phase()
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --gnn-only: no other path was driven")
        return 0
    if args.dryrun_only or args.dryrun_all:
        dryrun_phase(everything=args.dryrun_all)
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --dryrun-only/--dryrun-all: no other path was driven")
        return 0
    if args.mesh_only:
        build.build_all(["dvbyte_decode"])
        m2 = const_frozen(args.docs,
                          Path(tempfile.mkdtemp(prefix="mesh-m2-")))
        gc.collect()
        mesh_phase(fleet_indexes(), m2)
        if "jax" in sys.modules:
            fail("jax was imported")
        say(f"[card] {card_line()}")
        say("[done] --mesh-only: no other path was driven")
        return 0
    if args.fused_only:
        build.build_all(["fused_query"])
        for line in build.build_log("fused_query").splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] fused_query: {line.strip()}")
        fused_only(args.fused_only, args.docs)
        say(f"[card] {card_line()}")
        say("[done] --fused-only: no path was driven")
        return 0
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
    gpu_tests()
    term_errs = term_kernel_parity(*small)
    if args.kernels:
        kernel_shapes(small[0].device)
        say(f"[card] {card_line()}")
        say("[done] --kernels: no path was driven")
        return 0
    row = main_path(args.docs)
    gc.collect()       # the Const engine's host index goes before the fleet
    fleet = fleet_phase(row)
    sanitized = sanitize_phase()
    mesh = mesh_phase(fleet, row.pop("frozen"))
    fleet_launches = fleet["launches"]
    del fleet
    gc.collect()       # and the fleet's and the mesh's before the LM's
    lm_phase()
    train_phase()
    recsys_phase()
    gnn_phase()
    dryrun_phase()
    tri = triangle_path(TRIANGLE_DOCS, row["index"])
    if "jax" in sys.modules:
        fail("jax was imported")
    exact = "kernel == plain version bit for bit, rerun bit-identical"
    rows = {
        "fused_query": dict(row, max_abs_err=max(small_err,
                                                 row["max_abs_err"]),
                            fleet_phase_launches=fleet_launches,
                            sanitize_phase_launches=sanitized["launches"],
                            parity=f"kernel == plain version (rtol "
                                   f"{PARITY_RTOL}), rerun bit-identical"),
        "intersect": dict(tri["intersect"], bound_by="bytes", parity=exact),
        "topk_score": dict(tri["topk_score"], bound_by="bytes",
                           parity=exact),
        "dvbyte_decode": dict(row["split"], parity=exact,
                              mesh_phase_launches=mesh["launches"]),
        "retrieval_dot": dict(row["hybrid"], parity=f"kernel within "
                              f"{DENSE_ATOL} of the plain version, rerun "
                              f"bit-identical"),
    }
    rows["intersect"]["max_abs_err"] = max(
        rows["intersect"]["max_abs_err"], term_errs["intersect"])
    rows["topk_score"]["max_abs_err"] = max(
        rows["topk_score"]["max_abs_err"], term_errs["topk_score"])
    for name in ("dvbyte_decode", "retrieval_dot"):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        term_errs[name])
    kernels = []
    for name, r in rows.items():
        entry = {"name": name, "route": "cuda",
                 "source": str(build.SOURCES[name].relative_to(ROOT)),
                 "replaces": REPLACES[name]}
        for key in ("launches", "max_abs_err", "parity", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms"):
            entry[key] = r[key]
        for key in ("retrieval_cand", "off_path", "nonempty_rows",
                    "bound_ms_every_row", "decode_share", "floor_ms",
                    "path_query", "tier_phase_launches",
                    "planner_phase_launches",
                    "fleet_phase_launches", "sanitize_phase_launches",
                    "mesh_phase_launches"):
            if key in r:
                entry[key] = r[key]
        kernels.append(entry)
    say(json.dumps({"kernels": kernels}))
    say(f"[card] {card_line()}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
