#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Reads the card's name and power limit, builds the CUDA sources in
   ``src/repro_torch/csrc`` with ``nvcc`` (one process each, started
   together) and prints the build seconds and the ``-Xptxas -v`` reports,
   then each K3 body's registers, spills and shared memory (failing where
   a wgmma instantiation spills or asks for more than 232,448 bytes), and
   the same for K5's GEMM and reduction (failing where one spills or asks
   for more than 232,448 bytes).
2. Holds each truss kernel (``peel_wave``, ``bitmap_support``) bitwise
   against its plain PyTorch version on the card: at the unit-test shapes
   (row and word slabs, words with bit 31 set), where the digest body of
   the gathered entries also runs with its capacity forced to 1, 2 and 8
   against the plain version and the direct body; then at the slice's
   width: the slashdot-like bitmap's
   nonzero words a row (p50, p99, max, total; rows over the capacity and
   edges with both rows over it), the digest body against the plain
   version and the direct body on a 65,536-slot chunk and on the whole
   wave, both bodies timed in turns (CUDA events, median) on a full wave
   of each kernel and on K1 at seeded 10% and 1% alive subsets, beside
   their bounds, the plain version and each body's host microseconds a
   call (the id check's alone too); and one full wave of each under the
   profiler (time by pass).
3. Holds the attention kernel (``flash_attention``, two bodies: ``wgmma``
   for bf16 at head dims 64, 128 and 256, ``simt`` for the rest) against
   its plain version: the reference's sweep, a non-causal case whose length
   is no multiple of the tile, the wgmma body at head dims 64, 128 and 256
   with ragged lengths, a window and a V whose columns differ, the slice's
   shapes, ``[64, 4096, 128]`` bf16 (without and with a 1,024 window) and
   the prefill's GQA layout, the SIMT body against the wgmma body there,
   and both bodies at ``gemma-2b``'s MQA layout (head dim 256), each
   against the plain version and against each other.
4. Drives the truss path: ``DynamicGraph(support_method="bitmap")`` on the
   slashdot-like power-law graph (77,360 nodes, 980,614 edges), checked
   against the pure-Python oracle; three fused 2,000-update batches, a few
   progressive single updates, one batch with ``engine="recompute"``, one
   more batch of each engine under ``torch.profiler`` (each must show the
   digest body's ``digest_rows`` among its device ops, and every K1 and K2
   call of the path must have run the digest body), then
   ``max_truss``/``k_truss``/``index.query`` checked against a host
   connected-components pass, and a final from-scratch oracle check.
5. Drives the WAL-backed truss service on the same graph:
   ``TrussService(support_method="bitmap")`` tracking the slashdot
   config's ``query_ks`` (34, 30, 25, 15) over a ``TrussStore`` in a
   temporary directory (removed at the end).  The constructor (decompose,
   K2, and the baseline snapshot: seconds and bytes); four serial
   generations of 1,000 writes (500 deletes, 500 inserts; each flush one
   fused batch, K1: seconds, median ack µs a write, peel stats); the four
   query kinds at the committed generation (``max_k`` on 1,000 edges
   against phi, the members of each level against phi and their
   components against the index's and a host pass, communities and
   representatives against those components; median ms per kind); one
   generation under ``PeelChaos`` whose delta dispatch fails, so the
   ladder reruns it on the recompute engine (K2 must launch, the fallback
   counter rise); a snapshot, two more generations and
   ``TrussService.restore`` (load and replay seconds; the restored state
   bitwise equal to the live one, the WAL holding every acked write in
   order with its generation, phi equal to the oracle); a pipelined
   restore losing one generation's landing, which must self-heal from the
   store and end bitwise equal to a serial replay of the same log and phi
   equal to the oracle (heal seconds); and one serial flush under
   ``torch.profiler`` (device-busy share).  Every K1 and K2 call of this
   path must run the digest body.
6. Drives the replica cluster on the same graph: a ``bitmap`` primary and
   two ``Replica(support_method="bitmap")`` on the card tailing its store
   (a temporary directory, removed at the end) behind a ``QueryRouter``,
   with ``MixedWorkloadStream`` traffic (read fraction 0.9, zipf 1.1,
   levels 3, 5 and the max truss) for four generations of 1,000 writes
   through a ``Session``.  One read record in 60 goes out ``bounded``
   (bound 2) mid-generation and must be served within 2 generations; at
   each boundary replica-0 applies the generation (K1) and must equal the
   primary bitwise, 40 reads go out ``strong`` (the primary) and
   ``read_your_writes`` (replica-0) with the same answers, and the
   session reads its own last insert and delete.  Replica-1 stays parked
   (so bounded reads must pass it over once it lags 3), then steps up one
   group at a time, bitwise equal to the primary's state at each
   generation.  Then the primary drops with 500 writes acked and
   unflushed; ``router.promote()`` must pick replica-0, whose state must
   equal a fresh replay of the whole WAL bitwise, whose WAL must hold
   every acked write in order and whose phi must equal the oracle; and
   replica-1 tails it bitwise.  Logs replica install (snapshot load) and
   apply seconds, the lag of every read, read ms p50/p99 by level, the ack
   µs, the promotion seconds and K1's launches by path; every K1 and K2
   call must run the digest body.
7. Runs ``python -m repro_torch.launch.serve_truss`` as a subprocess whose
   path holds ``repro_torch`` alone, at 20,000 nodes (``LAUNCHER_REDUCED``
   says why): a primary with ``--store``, ``--metrics-port 0`` (scraped
   and parsed with ``expo.parse`` while it lingers), ``--trace-out``,
   ``--trace-jsonl`` and ``--profile-dir``; then ``--restore``, which must
   continue from the generation it stopped at; then ``--router
   --replicas 2 --pipeline``.  Every exit code must be 0, every profiled
   region's trace must hold each launch's and copy's device record, and
   the merged trace (``python -m repro_torch.obs.merge``) must join the
   replicas' applies to the router's writes.
8. Drives the sharded substrate at full width on ``make_shard_mesh(S)``
   (every shard on the one card) for S = 2 and 4: ``DynamicGraph(...,
   mesh=..., partition=...)`` with ``partition="replicated"`` (K1 on each
   shard's row block) and ``"nodes"`` (K2 on each shard's word slab, one
   partial support a slab summed each wave), each decompose bitwise equal
   (phi and ``PeelStats``) to phase 4's and one fused batch of 2,000
   updates bitwise equal (every state array, the stats, the bitmap) to a
   mesh=None graph given the same batch; at S = 4 a recompute-engine
   decompose (K2) against mesh=None's, the per-wave decision read and bit
   exchange timed (beside the reference's summed partial bitmaps);
   ``distributed_decompose`` against phase 4's phi (the oracle's); one
   ``TrussService(mesh=..., partition="nodes")`` generation of 1,000
   writes bitwise equal to a mesh=None service fed the same writes; a
   wave-profiled re-peel under the mesh observing the decision's share of
   each wave.  Logs seconds, waves, launches by body, bitmap bytes a
   device and peak device memory of each run; every K1 and K2 call must
   run the digest body.
9. Times the attention kernel's bodies at ``[64, 4096, 128]`` bf16, at the
   prefill's GQA layout and at ``gemma-2b``'s layout (the wgmma body and
   the SIMT body asked for by name, in turns), each beside its bound, its
   plain version and ``scaled_dot_product_attention``.
10. Drives the LM serving path at the full width and depth of
   ``qwen3-0.6b`` with seeded random weights: prefill of 4 x 4,096 tokens
   (K3's wgmma body 28 times a call, its SIMT body never), one more under
   ``torch.profiler``, then
   ``DecodeEngine`` serving four 512-token prompts with 16 new tokens each,
   checked against prefill's argmax within a tolerance measured from a
   ``decode_step`` replay of the prompts.  Then prefill of ``gemma-2b``
   (head dim 256: K3's wgmma body 18 times a call, its SIMT body never) at
   full width and depth on 1 x 4,096 tokens, its logits held against the
   plain route; and the SIMT body's path, prefill of ``gemma-2b``'s smoke
   config (head dim 32, bf16: the SIMT body once a layer) on 4 x 1,024
   tokens, the kernel at that shape and the logits held against the plain
   versions.
11. Holds the recsys kernels against their plain versions on the
   reference's sweeps: the segment sum (``segment_matmul``, fp32 and fp16,
   ids outside the range, gathered entry; on the same ids sorted, the
   declared-sorted entry bitwise against the sorting entry and the mean
   entry against the plain mean; runs of up to 30,000 rows against a
   float64 sum; indices outside the table giving NaN bags; unsorted ids
   declared sorted giving an all-NaN output) and the CIN layer (``cin``).
12. Drives the xDeepFM serving path at full width (39 fields of 1,000,000
   rows, embed 10, CIN 200-200-200, MLP 400-400; about 433M parameters
   from a seed, on the card) through the reference's three traffic shapes:
   serve_p99 (batch 512, 200 synchronised calls: p50/p99 ms, rows/s),
   serve_bulk (batch 262,144, three calls: s/call, rows/s) and
   retrieval_cand (batch 1 against 1,000,000 candidates, top 100: ms),
   with the device-busy share of one p99 and one bulk call, each of which
   must show K4's kernels and no sort kernel among its device ops; K4 must
   launch once per serve or retrieval call.  Before it, both kernels are
   held against their plain versions at the path's shapes (the p99 and the
   whole bulk bag sum, where K4's declared-sorted entry must equal its
   sorting entry and its mean entry the two-call mean, bitwise; the first
   and last 4,096 rows of each bulk CIN layer); after it, the p99 scores
   against
   ``ops.use_kernels(False)`` and 64 rows against the CPU, and both
   kernels are timed beside their bounds, plain versions and yardsticks:
   K4's sum, mean and sorting entries at the p99 and bulk bag sums, in
   turns with their plain versions and ``F.embedding_bag`` (sum and mean),
   and with the sum entry on the reference's batch-major bag order; K5 at
   a p99 layer 2 beside ``torch.einsum`` and cuBLAS's SGEMM
   (``torch.matmul``) of the outer product materialised before the timing,
   and on one whole bulk layer-2 call (TFLOP/s and share of the bound).
   K5's plan (grid and k slices) is printed for each layer of the path.
13. Drives truss-filtered GCN training (``examples/evolving_graph_training
    .py``) at ``gcn-cora``'s full width on the slashdot-like graph:
    ``DynamicGraph(support_method="bitmap", tracked_ks=(5,))``, two
    rounds of a ``GraphUpdateStream`` chunk of 2,000 updates (K1 in every
    round's fused batch, digest body), each followed by the k = 5 truss
    community batched by ``sampler.make_gnn_batch`` (d_feat 1,433, edges
    padded to 4 x 980,614) and 5 AdamW steps (K4 three times a step: the
    degree count and each layer's aggregation; the backward a plain row
    gather; the last step of the last round under ``torch.profiler``).
    Logs each round's apply seconds, community edges, batch-build seconds,
    step ms and losses.  Then ``launch.train.main --full --steps 6`` for
    gcn-cora, gin-tu, meshgraphnet and dimenet, each against 3 steps of
    the launcher's setup cut by the preemption flag and resumed to 6 by
    ``main`` (bitwise), and gcn-cora once more as a subprocess whose path
    holds ``repro_torch`` alone.  The launch counts are read there.  Then
    a step's loss and gradients through K4 against ``use_kernels(False)``
    (loss within 1e-5 of itself, each gradient leaf within 1e-4 of its
    largest magnitude), with K4's rows entry against its plain version on
    every input the step handed it: each arch at full config on the
    launcher's first batch, gin-tu's graph readout on the molecule cell,
    and the truss-filtered step on the last round's batch, whose K4
    inputs ([3,922,456, 1], [.., 16], [.., 7]) are then timed in turns
    with the plain version and ``index_add_`` beside the byte bound, and
    on the community's own rows alone.
14. Trains ``qwen3-0.6b`` at full width and depth and xDeepFM at the full
    config through ``launch.train.main --full`` (``LM_TRAIN``: train_4k
    with its batch cut to 4, ``[4, 4096]``; ``RS_TRAIN``: train_batch's
    65,536 rows), 3 steps each, the kernel counts set to 0 just before
    each run and read just after: qwen3 must launch K3's wgmma body 56
    times a step (each of 28 layers forward and again in its remat) and
    no SIMT body, xDeepFM K4 once and K5 three times a step.  Logs the
    step seconds, losses (qwen3's first near ln 151,936), peak device
    memory and the final checkpoint's host copy and write seconds and
    bytes (deleted after).  Then each card step against
    ``use_kernels(False)`` on the card (qwen3: loss 5e-3 relative, leaves
    5e-2 relative Frobenius, beside the plain route's own spread with its
    attention blocks halved; xDeepFM on 4,096 rows: loss 1e-5, leaves 1e-4
    of their largest magnitude, with the plain route's K5 backwards taking
    the kernel route's relu decisions, which may differ only within
    ``K5_TOL`` of 0), the restart check of phase 13 at both
    smoke configs, and the plain backwards timed: attention's at the
    training layer beside K3's forward, K5's at each of the step's CIN
    layers (and its share of the step) and K4's gathered one.
15. Serves the two MoE archs at full width, each with its depth cut to
    fit one card in fp32 and the cut printed (``MOE_RUNS``: mixtral-8x7b 8
    of 32 layers, 47.5 GB; llama4-scout-17b-a16e 4 of 48, 41.5 GB), seeded
    random weights, each built and freed in turn: two timed prefill calls
    (mixtral ``[1, 8192]``, where K3's 4,096 window masks; llama4
    ``[4, 4096]``, a GQA group of 5), K3's wgmma body once a layer a call
    and its SIMT body never, logits finite, one more call profiled; the
    logits against the plain route (chunked attention) replaying the
    kernel route's expert choices (within ``LOGIT_RTOL`` of the largest
    |logit|), each route's own choices at those matched inputs differing
    only within ``ROUTE_TIE_GAP`` of a tie, the dropped slots by layer;
    ``DecodeEngine`` serving 4 requests of 64 + 16 tokens, each wave
    timed, and ``decode_step``'s replay of the prompts against prefill's
    logits on every row whose prefill dropped no token and routed as
    decode did (decode never drops: its capacity is 1); on mixtral's
    engine cache after serving, ``kv_quant``'s int8 cache and
    ``attend_quant`` on every layer against the bf16 decode attention
    (``KV_QUANT_TOL``), bytes and ms of both.  Then ``launch.serve`` and
    ``launch.train --steps 3`` of both MoE archs as four subprocesses at
    once (smoke configs, exit 0, finite losses), ``launch.train`` in
    process on the card and the CPU from the same parameters (first loss
    within ``MOE_LAUNCH_RTOL``; the aux loss nonzero), and K3 at both MoE
    prefill layouts and mixtral's training layout ``[4, 4096]`` (llama4's
    is its prefill's) against its plain version and timed beside its bound
    and ``scaled_dot_product_attention``.
16. The cell plans (``launch/specs.py``, ``launch/dryrun.py``).  The
    dry-run of all 36 cells on both production meshes, started as a
    subprocess before phase 13 on a path holding ``repro_torch`` alone,
    with no card visible: exit 0 with 72/72 cells traced, each cell's
    per-device argument GB on both meshes (computed from shapes), matmul
    flops and trace seconds logged.  Three plans run on the card at
    ``make_test_mesh((1, 1))``, each cell's global shape and full config
    (``PLAN_CELLS``): ``qwen3-0.6b/prefill_32k`` (K3's wgmma body once a
    layer, rows 0-1 against a direct ``prefill`` of those rows within
    ``LOGIT_RTOL`` of the largest |logit|), ``xdeepfm/serve_bulk`` (K4
    once, K5 three times) and ``gcn-cora/full_graph_sm``'s train step (K4
    three times; the batch from ``make_gnn_batch``, padded to the plan's
    edge count), those two bitwise against the model's own entry point on
    the same tensors; each plan's arguments equal to its meta trace's
    shapes, dtypes and ``argument_size_in_bytes``, its outputs to the
    trace's shapes and dtypes, finite; seconds and peak memory logged.
    Then one MoE layer of each MoE arch at full width on ``[1, 8192]``
    over ``make_test_mesh((1, 16))``: mixtral's model-sharded branch (16
    ``d_ff`` slices of 896) within ``BRANCH_FRO`` of ``mesh=None``,
    llama4-scout's expert-parallel branch bitwise, and the same for the
    layer's gradients (``x``, the router, each expert stack); forward and
    backward timed.
17. Trains the two MoE archs at full width (``MOE_TRAIN_RUNS``), each
    depth cut to the deepest whose step's fp32 copies of the parameters
    fit in ``MOE_TRAIN_FIT`` of the card (the reckoning printed), the
    batch of ``train_4k`` cut to ``[4, 4096]``: mixtral-8x7b (1 of 32
    layers) three AdamW steps through ``loop.run`` with
    ``launch.train._lm_setup``'s stream, loss and initialiser (step
    seconds, losses, peak memory, the last step under ``torch.profiler``,
    the final checkpoint's host copy and write seconds and bytes, deleted
    after); llama4-scout-17b-a16e (1 of 48) loss and gradients only (its
    AdamW step holds ~8 fp32 copies, 133 GB at depth 1), profiled once.
    The counts are set to 0 just before each arch's run and read just
    after: K3's wgmma body twice a layer a step (each layer and its
    recompute), its SIMT body, K4 and K5 never.  Each arch's step is then
    held against ``use_kernels(False)`` at matched routing, keyed by layer
    (``layer_routes``: the plain route replays the kernel route's expert
    choices in its forward and its recompute; every kernel-route recompute
    must choose what its forward chose): loss within
    ``LM_STEP_LOSS_RTOL``, leaves within ``LM_STEP_GRAD_FRO`` relative
    Frobenius, beside the plain route's own spread with its attention
    blocks halved, each route's own choices differing only within
    ``ROUTE_TIE_GAP`` of a tie; mixtral's once more at ``[1, 8192]``,
    where its 4,096 window masks.
18. Fails unless every kernel was launched by its path (K1 and K2 on the
    truss path, on the service path and on the sharded path, K1 on the
    cluster path and the training rounds, K4 on the recsys and training
    paths, K3 and K5 on the LM and recsys training paths too, K3 on the
    MoE prefills and the MoE training, K3, K4 and K5 on the cell plans),
    prints the smoke's total seconds, the kernels line, the card line,
    and last the device line.

Every failed check raises, so the exit code is non-zero.  The script needs
a CUDA device, ``nvcc`` and the rest of this checkout; it imports no JAX.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_NODES, M_PER_NODE, N_EDGES = 77_360, 12, 980_614   # configs SLASHDOT analogue
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12   # the card's non-tensor-core peak (fp32 table row)
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
TEST_SHAPES = ((1, 1), (7, 3), (64, 32), (130, 37), (513, 129))
PROBE_LANES_REASON = ("8 lanes a slot (kProbeLanes, csrc/bitmap_popcount"
                      ".cu): the mean sparser row has 25 nonzero words, "
                      "one sweep of 8 lanes with four entries each in "
                      "flight; 4, 8 and 16 lanes came within 6% of each "
                      "other on full waves of K1 and K2 by device time, "
                      "32 up to 21% slower on K2 (PERF.md section 6, "
                      "PR 20)")
CHUNK_ROWS = 65_536
SOURCES = ("bitmap_popcount", "flash_attention", "segment_sum", "cin")
K3_SWEEP = ((1, 64, 16), (2, 300, 32), (4, 128, 64))
K3_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
K3_PATH_RTOL, K3_PATH_ATOL = 1.6e-2, 1e-3   # about one bf16 step of each value
LOGIT_RTOL = 3e-2    # prefill vs decode_step, of max |logit| (bf16 paths)
K3_SHAPE = (64, 4096, 128)    # [BH, S, Dh]: 4 prompts x 16 heads at 4,096
K3_WGMMA_CASES = ((64, 300), (64, 4096), (128, 300), (128, 1000),
                  (256, 300), (256, 4096))                          # (Dh, S)
LM_ARCH = "qwen3-0.6b"
GEMMA_ARCH = "gemma-2b"       # head dim 256: K3's wgmma body with 64-key tiles
GEMMA_BATCH, GEMMA_SEQ = 1, 4096
GEMMA_HEADS = (8, 1, 256)     # gemma-2b: query heads, KV heads, head dim
SIMT_BATCH, SIMT_SEQ = 4, 1024   # gemma-2b's smoke config: K3's SIMT body
SMEM_LIMIT = 232_448          # dynamic shared memory a block may use
PREFILL_BATCH, PREFILL_SEQ = 4, 4096
PARAM_COUNT = 596_041_728     # transformer.param_count of qwen3-0.6b
SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_SEQ = 4, 512, 16, 640
RECSYS_ARCH = "xdeepfm"
RECSYS_PARAMS = 432_841_945   # table, wide weights, CIN, MLP of xdeepfm
K4_SWEEP = ((10, 4, 3), (100, 16, 17), (1000, 64, 77), (513, 32, 128),
            (257, 8, 1))
# the reference's sweep tolerances, absolute plus relative (assert_allclose)
K4_TOL = {torch.float32: 1e-5, torch.float16: 2e-2}
K5_SWEEP = ((8, 5, 7, 11, 6), (64, 40, 40, 200, 10), (130, 8, 8, 16, 16),
            (3, 2, 1, 70, 5))
K5_TOL = 2e-5
K5_CHUNK = 4096               # rows of a bulk batch held to the plain version
SCORE_TOL = 1e-5              # click probabilities, fp32 sums reordered
P99_CALLS, BULK_CALLS, RETRIEVAL_CALLS, TOP_K = 200, 3, 10, 100
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core peak
# Phase 13: the truss-filtered GCN loop of examples/evolving_graph_training.py
# at gcn-cora's full width on the slashdot-like graph (the example's AdamW
# settings), then every GNN arch at full config through the launcher; two
# rounds (the example runs 6 of 8): each round repeats the same work, and
# with four beside phase 17 the smoke took 1,042 s on an H100
TRAIN_ARCH, TRAIN_K, TRAIN_ROUNDS, TRAIN_STEPS = "gcn-cora", 5, 2, 5
TRAIN_CHUNK = 2_000                # updates a round (GraphUpdateStream)
TRAIN_D_FEAT = 1_433               # full_graph_sm's d_feat (GNN_SHAPES)
TRAIN_PAD_EDGES = 4 * N_EDGES      # directed edges padded as the example pads
TRAIN_OPT = {"lr": 1e-2, "total_steps": 60, "warmup_steps": 5}
# the card's step through K4 against the plain route: the loss within
# 1e-5 of itself, each gradient leaf within 1e-4 of the leaf's largest
# magnitude (fp32 sums in another order, over runs of up to ~2M rows)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
GNN_ARCHS = ("gcn-cora", "gin-tu", "meshgraphnet", "dimenet")
# Phase 14: qwen3-0.6b and xDeepFM training through the launcher.  qwen3 at
# full width and depth on train_4k's [256, 4096] with only the batch cut,
# to 4 (prefill's [4, 4096], whose K3 time is on record); xDeepFM's
# train_batch at the full config and its own 65,536 rows, not cut
LM_TRAIN = ["--batch", "4", "--seq", "4096", "--steps", "3"]
RS_TRAIN = ["--batch", "65536", "--steps", "3"]
LM_TRAIN_STEPS = RS_TRAIN_STEPS = 3
RS_CHECK_ROWS = 4096     # the rows of the batch held to the plain route
# qwen3's card step against use_kernels(False) on the card: the loss within
# 5e-3 relative and each gradient leaf within 5e-2 relative Frobenius
# error.  The bf16 forward differs by K3's roundings (its P as hi + lo bf16
# terms, fp32 sums in another order), a bf16 step that the remat and 28
# layers carry into every gradient; on the CPU the same bf16 paths measured
# up to 2.3e-2 against the reference (tests/test_torch_lm_training.py)
LM_STEP_LOSS_RTOL, LM_STEP_GRAD_FRO = 5e-3, 5e-2
RESTART_STEPS, RESTART_AT = 6, 3   # 3 steps, preempted, resumed to 6
# Phase 15: MoE serving.  Each arch at full width with its depth cut to fit
# one H100 in fp32 (47.5 / 41.5 GB of parameters); mixtral's prefill at
# 8,192 positions, so K3's 4,096 window masks half of the late queries' keys
MOE_RUNS = (("mixtral-8x7b", 8, 1, 8192),            # arch, layers, batch, seq
            ("llama4-scout-17b-a16e", 4, 4, 4096))
MOE_ARCHS = tuple(r[0] for r in MOE_RUNS)
MOE_SERVE_SLOTS, MOE_SERVE_PROMPT, MOE_SERVE_NEW = 4, 64, 16
MOE_SERVE_MAX_SEQ = 640
KV_QUANT_ARCH, KV_QUANT_TOL = "mixtral-8x7b", 1e-2   # the reference's bound
# A routing decision that differs between two routes (kernel vs plain
# attention, decode vs prefill) must be a near-tie: the two experts'
# probabilities on the first route within 2e-2.  The router's logits are
# rounded to bf16 (COMPUTE_DTYPE) before the fp32 softmax: one bf16 step of
# a logit near 2-4 is 2**-6 = 0.016, two logits may each round one step
# apart, and p_a - p_b ~ p_a (l_a - l_b) with p_a < 1 then stays under 0.03
ROUTE_TIE_GAP = 2e-2
MOE_LAUNCH_RTOL = 5e-3       # the launcher's first loss, card vs CPU
MOE_LAUNCH_TIMEOUT = 600
MOE_K3_LAYOUTS = {"mixtral": (1, 8192, 32, 8, 128, 4096),   # b, s, hq, hkv, dh,
                  "llama4": (4, 4096, 40, 8, 128, None),    # window; llama4's
                  "mixtral_train": (4, 4096, 32, 8, 128, 4096)}  # training too
MOLECULE_GRAPHS = 128            # GNN_SHAPES' molecule cell: 128 x 30 nodes
# Phase 16: the cell plans.  The dry-run of all 36 cells on both production
# meshes as a subprocess (started before phase 13, it runs beside phases
# 13-15), then three plans on the card at each cell's global shape and full
# config, at make_test_mesh((1, 1)), and one MoE layer of each MoE arch at
# full width on phase 15's mixtral shape over a model axis of 16
DRYRUN_CELLS, DRYRUN_TIMEOUT = 72, 900
PLAN_CELLS = (("qwen3-0.6b", "prefill_32k"), ("xdeepfm", "serve_bulk"),
              ("gcn-cora", "full_graph_sm"))
PLAN_SEED, PLAN_LM_ROWS = 0, 2
BRANCH_SHAPE, BRANCH_MESH = (1, 8192), (1, 16)
# the model-sharded branch's bf16 output against mesh=None: relative
# Frobenius error, the bound tests/test_torch_specs.py sets (BRANCH_FRO).
# Its gradients (x, router, expert stacks) are held to the same bound: on
# one card the d_ff slices run as one batched call, so each expert leaf's
# gradient is its own columns' products and x's one GEMM over every slice;
# only the gates' gradient reads the combined bf16 partials, as the
# forward's sum does
BRANCH_FRO = 2e-2
# Phase 17: MoE training at full width.  Each arch's depth is cut to the
# deepest whose step holds in MOE_TRAIN_FIT of the card's memory: mixtral's
# AdamW step through loop.run holds ~8 fp32 copies of its parameters
# (params, grads, mu, nu, the clipped grads, and the new params, mu and nu
# that adamw_update returns as fresh tensors); llama4-scout's gradient
# against the plain route holds 3 (params and two gradient trees), and its
# AdamW step would need 8 at any depth.  train_4k's [256, 4096] is cut to
# [4, 4096]
MOE_TRAIN_RUNS = (("mixtral-8x7b", "adamw", 8, 4, 4096),   # arch, step,
                  ("llama4-scout-17b-a16e", "grad", 3, 4, 4096))  # copies, b, s
MOE_TRAIN_FIT = 0.8
MOE_TRAIN_STEPS = 3
# mixtral's extra step: at 4,096 positions its 4,096 window never masks a
# key; at 8,192 the band reaches K3's forward and attention_vjp_ref's
# windowed query blocks
MOE_WINDOW_STEP = (1, 8192)
# the first loss of a run from seeded weights: the untied unembedding gives
# logits of unit scale, ~0.5 above ln(vocab) (tests/test_torch_moe.py)
MOE_FIRST_LOSS_GAP = 1.0


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check_equal(got, exp, what: str) -> int:
    """Bitwise equality of integer/bool tensors; returns max |difference|."""
    if got.shape != exp.shape or got.dtype != exp.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{exp.dtype}{tuple(exp.shape)}")
    err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if err:
        raise AssertionError(f"{what}: max |kernel - plain| = {err}")
    return err


def random_words(rng, shape, device):
    """uint32 words as int32, with bit 31 forced on in a quarter of them."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    w[rng.random(shape) < 0.25] |= np.uint32(1 << 31)
    return torch.from_numpy(w.view(np.int32)).to(device)


def check_test_shapes(ops, ref, dev) -> int:
    """Kernels vs plain versions at the unit-test shapes, with slabs."""
    err = 0
    rng = np.random.default_rng(0)
    for e, w in TEST_SHAPES:
        a, b = random_words(rng, (e, w), dev), random_words(rng, (e, w), dev)
        alive = torch.from_numpy(rng.random(e) < 0.8).to(dev)
        err = max(err, check_equal(ops.bitmap_support(a, b),
                                   ref.bitmap_support_ref(a, b), f"K2 {e}x{w}"))
        for k in (2, 3, 7):
            kk = torch.tensor(k, dtype=torch.int32, device=dev)
            got, exp = ops.peel_wave(a, b, alive, kk), ref.peel_wave_ref(a, b, alive, kk)
            for g, x, name in zip(got, exp, ("sup", "kill")):
                err = max(err, check_equal(g, x, f"K1 {name} {e}x{w} k={k}"))
        ro, rc = e // 3, max(1, e // 2)
        sl = slice(min(ro, e - rc), min(ro, e - rc) + rc)
        got = ops.peel_wave(a, b, alive, 3, row_offset=ro, row_count=rc)
        exp = ref.peel_wave_ref(a[sl], b[sl], alive[sl], 3)
        for g, x in zip(got, exp):
            err = max(err, check_equal(g, x, f"K1 row slab {e}x{w}"))
        wo, wc = w // 3, max(1, w // 2)
        ws = slice(min(wo, w - wc), min(wo, w - wc) + wc)
        err = max(err, check_equal(
            ops.bitmap_support(a, b, row_offset=ro, row_count=rc,
                               word_offset=wo, word_count=wc),
            ref.bitmap_support_ref(a[sl, ws], b[sl, ws]), f"K2 slabs {e}x{w}"))
    # gathered entries against the rows entries on gathered rows
    bm = random_words(rng, (300, 37), dev)
    eu = torch.from_numpy(rng.integers(0, 300, 777).astype(np.int32)).to(dev)
    ev = torch.from_numpy(rng.integers(0, 300, 777).astype(np.int32)).to(dev)
    alive = torch.from_numpy(rng.random(777) < 0.7).to(dev)
    ra, rb = bm[eu.long()], bm[ev.long()]
    for g, x in zip(ops.peel_wave_gathered(bm, eu, ev, alive, 5),
                    ops.peel_wave(ra, rb, alive, 5)):
        err = max(err, check_equal(g, x, "K1 gathered vs rows"))
    err = max(err, check_equal(ops.bitmap_support_gathered(bm, eu, ev),
                               ops.bitmap_support(ra, rb), "K2 gathered vs rows"))
    err = max(err, check_equal(
        ops.bitmap_support_gathered(bm, eu, ev, word_offset=5, word_count=20),
        ref.bitmap_support_ref(ra[:, 5:25], rb[:, 5:25]), "K2 gathered slab"))
    return max(err, check_digest_shapes(ref, rng, dev))


def check_digest_shapes(ref, rng, dev) -> int:
    """The digest body at the unit-test widths, its capacity forced to 1,
    2 and 8 (both branches) and left to ``digest_capacity``: bitwise
    against the plain version and the direct body,
    on a bitmap 60% zero words whose base is 4 bytes past an 8-byte
    boundary, with u == v slots and a word slab."""
    from repro_torch.kernels import bitmap_support as bs, peel_wave as pw
    err = 0
    for e, w in TEST_SHAPES:
        n = max(e, 2)
        bm = random_words(rng, (n * w + 1,), dev)[1:].view(n, w)
        bm[torch.from_numpy(rng.random((n, w)) < 0.6).to(dev)] = 0
        eu = torch.from_numpy(rng.integers(0, n, 3 * e).astype(np.int32)).to(dev)
        ev = torch.from_numpy(rng.integers(0, n, 3 * e).astype(np.int32)).to(dev)
        ev[:e] = eu[:e]
        alive = torch.from_numpy(rng.random(3 * e) < 0.7).to(dev)
        wo, wc = w // 3, max(1, w // 2)
        exp2 = ref.bitmap_support_gathered_ref(bm, eu, ev)
        exp_slab = ref.bitmap_support_gathered_ref(bm[:, wo:wo + wc], eu, ev)
        exp1 = ref.peel_wave_gathered_ref(bm, eu, ev, alive, 3)
        direct1 = pw.peel_wave_cuda(bm, bm, alive, 3, eu, ev, body="direct")
        err = max(err, check_equal(bs.bitmap_support_cuda(
            bm, bm, eu, ev, body="direct"), exp2, f"K2 direct {e}x{w}"))
        for g, x in zip(direct1, exp1):
            err = max(err, check_equal(g, x, f"K1 direct {e}x{w}"))
        for cap in (1, 2, 8, None):
            what = f"{e}x{w} C={cap}"
            err = max(err, check_equal(bs.bitmap_support_cuda(
                bm, bm, eu, ev, capacity=cap), exp2, f"K2 digest {what}"))
            err = max(err, check_equal(bs.bitmap_support_cuda(
                bm, bm, eu, ev, wo, wc, capacity=cap), exp_slab,
                f"K2 digest slab {what}"))
            for g, x in zip(pw.peel_wave_cuda(bm, bm, alive, 3, eu, ev,
                                              capacity=cap), exp1):
                err = max(err, check_equal(g, x, f"K1 digest {what}"))
    return err


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls with no sync
    between them, after warm-up (what a host-bound caller pays)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def bound_ms(bitmap, rows_used: int, slot_bytes: int, n_slots: int,
             word_pairs: int):
    """Least time for the work: bitmap rows the inputs touch read once plus
    the per-slot inputs and outputs, over device-memory bandwidth; or one
    AND, one POPC and one add per word pair over the peak rate.  Returns
    (ms, 'bytes' | 'operations', bytes)."""
    n_bytes = rows_used * bitmap.shape[1] * 4 + slot_bytes * n_slots
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 3 * word_pairs / CUDA_CORE_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", n_bytes)


def host_us_in_turns(calls: dict, samples: int = 200) -> dict:
    """Median host microseconds a call of each of ``calls`` that starts on
    an idle device (what a wave loop that syncs every wave pays on the
    host, the wrapper's own host sync included): one warm-up call each,
    then ``samples`` rounds of one call each, the order reversed every
    round."""
    for fn in calls.values():
        fn()
    keys, got = list(calls), {k: [] for k in calls}
    for i in range(samples):
        for key in (keys if i % 2 == 0 else keys[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[key]()
            got[key].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {k: 1e6 * float(np.median(v)) for k, v in got.items()}


def launch_only(name: str, body: str, bm, eu, ev, alive, k):
    """K1 (``name`` "peel_wave") or K2 bound by the wrapper's own launcher
    (``peel_wave_launcher``, ``bitmap_support_launcher``): checked and
    allocated once, then its C entry alone, which the wrapper launches
    after its id check's host sync.  Returns a function that launches it
    ``n`` times back to back, so CUDA events around it time the kernels
    alone.  These launches are not counted."""
    from repro_torch.kernels import bitmap_support as bs, peel_wave as pw
    if name == "peel_wave":
        _, launch, _ = pw.peel_wave_launcher(bm, bm, alive, k, eu, ev,
                                             body=body)
    else:
        _, launch, _ = bs.bitmap_support_launcher(bm, bm, eu, ev, body=body)

    def launches(times: int = 1):
        for _ in range(times):
            launch()
    return launches


def kernel_ms(launch, reps: int = 10) -> float:
    """Median CUDA-event ms of one launch of ``launch_only``'s function,
    timed over ten back-to-back launches."""
    return time_ms(lambda: launch(10), reps) / 10


def in_turns(calls: dict, reps: int = 10, timer=None) -> dict:
    """``timer(fn, reps)`` of each call (default: the median CUDA-event
    ms), timed in turns in one order and then the reverse; each time the
    mean of the two."""
    timer = timer or time_ms
    turns = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            turns[k].append(timer(calls[k], reps))
    return {k: float(np.mean(v)) for k, v in turns.items()}


def nonzero_stats(bm, eu, ev, alive, cap: int) -> dict:
    """Nonzero words per bitmap row, and what the digest body's plan makes
    of them at capacity ``cap`` for the slots in ``alive``."""
    nnz = (bm != 0).sum(1)
    q = torch.quantile(nnz.double(), torch.tensor([0.5, 0.99], device=nnz.device,
                                                  dtype=torch.float64))
    na, nb = nnz[eu.long()][alive], nnz[ev.long()][alive]
    sparse = torch.minimum(na, nb)
    return {"rows": bm.shape[0], "words": bm.numel(),
            "nonzero_words": int(nnz.sum()),
            "nonzero_share": float(nnz.sum()) / bm.numel(),
            "p50": float(q[0]), "p99": float(q[1]), "max": int(nnz.max()),
            "capacity": cap, "rows_over_capacity": int((nnz > cap).sum()),
            "edges": int(alive.sum()),
            "edges_both_over_capacity": int(((na > cap) & (nb > cap)).sum()),
            "sparser_mean": float(sparse.double().mean()),
            "sparser_p99": float(torch.quantile(sparse.double(), 0.99)),
            "probes": int(torch.where(sparse > cap, 0, sparse).sum())}


def full_width_checks(core, ops, ref, edges, dev):
    """At the slice's width: the nonzero-word statistics of the bitmap; the
    digest body bitwise against the plain version and the direct body on a
    65,536-row chunk and on the whole wave; both bodies timed in turns on a
    full wave of K1 and K2 and on K1 at 10% and 1% alive, around the
    wrapper call and as their C entry alone, with their host cost a call
    and the id check's; one wave of each under the profiler."""
    from repro_torch.kernels import bitmap_support as bs, peel_wave as pw
    spec = core.GraphSpec(N_NODES, d_max=2 * int(np.bincount(
        edges.reshape(-1)).max()), e_cap=2 * len(edges))
    st = core.from_edge_list(spec, edges, dev)
    bm = core.build_bitmap(spec, st, st.active)
    eu = torch.clamp(st.edges[:, 0], max=N_NODES - 1).contiguous()
    ev = torch.clamp(st.edges[:, 1], max=N_NODES - 1).contiguous()
    alive = st.active.clone()
    k = torch.tensor(3, dtype=torch.int32, device=dev)
    w = bm.shape[1]
    cap = bs.digest_capacity(w)
    log(f"bitmap {tuple(bm.shape)} int32 = {bm.numel() * 4 / 1e6:.0f} MB, "
        f"e_cap {spec.e_cap}, alive {int(alive.sum())}")
    stats = nonzero_stats(bm, eu, ev, alive, cap)
    log(f"nonzero words: {json.dumps(stats)}")
    log(f"probe mapping kept: {PROBE_LANES_REASON}")

    # the digest body against the plain version and the direct body
    c = slice(0, CHUNK_ROWS)
    err1 = err2 = 0
    for name, sl in (("chunk", c), ("whole wave", slice(None))):
        a_, u_, v_ = alive[sl], eu[sl], ev[sl]
        digest = pw.peel_wave_cuda(bm, bm, a_, k, u_, v_, body="digest")
        direct = pw.peel_wave_cuda(bm, bm, a_, k, u_, v_, body="direct")
        plain = ref.peel_wave_gathered_ref(bm, u_, v_, a_, k, chunk=CHUNK_ROWS)
        for g, x, y, part in zip(digest, plain, direct, ("sup", "kill")):
            err1 = max(err1, check_equal(g, x, f"K1 {name} {part}"),
                       check_equal(g, y, f"K1 {name} {part} vs direct"))
        digest = bs.bitmap_support_cuda(bm, bm, u_, v_, body="digest")
        err2 = max(err2, check_equal(
            digest, ref.bitmap_support_gathered_ref(bm, u_, v_, CHUNK_ROWS),
            f"K2 {name}"), check_equal(
            digest, bs.bitmap_support_cuda(bm, bm, u_, v_, body="direct"),
            f"K2 {name} vs direct"))
        log(f"full-width {name} ({len(u_)} slots, W {w}): the digest body == "
            f"the plain version == the direct body (tolerance: bitwise; max "
            f"abs err {max(err1, err2)})")

    # subsets of the alive edges, seeded
    rng = np.random.default_rng(2)
    live = alive.nonzero().flatten()
    subsets = {"full": alive}
    for name, share in (("alive_10pct", 0.10), ("alive_1pct", 0.01)):
        pick = torch.from_numpy(rng.random(len(live)) < share).to(dev)
        sub = torch.zeros_like(alive)
        sub[live[pick]] = True
        subsets[name] = sub
    n_bodies = {"peel_wave": {}, "bitmap_support": {}}
    for name, al in subsets.items():
        for g, x in zip(pw.peel_wave_cuda(bm, bm, al, k, eu, ev),
                        pw.peel_wave_cuda(bm, bm, al, k, eu, ev,
                                          body="direct")):
            err1 = max(err1, check_equal(g, x, f"K1 {name} digest vs direct"))
        calls = {body: (lambda b=body, a_=al: pw.peel_wave_cuda(
            bm, bm, a_, k, eu, ev, body=b)) for body in ("direct", "digest")}
        ms = in_turns(calls)
        host = host_us_in_turns(calls)
        dev_ms = in_turns({b: launch_only("peel_wave", b, bm, eu, ev, al, k)
                           for b in calls}, timer=kernel_ms)
        n_alive = int(al.sum())
        rows = int(torch.unique(torch.cat([eu[al], ev[al]])).numel())
        bound = bound_ms(bm, rows, 4 + 4 + 1 + 4 + 1, spec.e_cap, n_alive * w)
        n_bodies["peel_wave"][name] = {"ms": ms, "kernels_ms": dev_ms,
                                       "host_us": host, "alive": n_alive,
                                       "bound": bound[:2]}
        log(f"peel_wave {name} ({n_alive} alive): digest {ms['digest']:.4f} "
            f"ms, direct {ms['direct']:.4f} ms (CUDA events around the call, "
            f"in turns, each the mean of two medians); the kernels alone "
            f"(the C entry, in turns): digest {dev_ms['digest']:.4f} ms, direct "
            f"{dev_ms['direct']:.4f} ms; bound {bound[0]:.4f} ms by "
            f"{bound[1]} ({rows} rows); host us a call from an idle device "
            f"(median, in turns): digest {host['digest']:.1f}, direct "
            f"{host['direct']:.1f}")
    calls = {body: (lambda b=body: bs.bitmap_support_cuda(bm, bm, eu, ev,
                                                          body=b))
             for body in ("direct", "digest")}
    ms = in_turns(calls)
    dev_ms = in_turns({b: launch_only("bitmap_support", b, bm, eu, ev, None,
                                      0) for b in calls}, timer=kernel_ms)
    # the id check (one reduction, one host sync) in the same turns
    host = host_us_in_turns(calls | {"id_check": lambda: bs.row_pair_args(
        bm, bm, eu, ev, 0, None)})
    id_check_us = host.pop("id_check")
    log(f"bitmap_support full ({spec.e_cap} slots): digest "
        f"{ms['digest']:.4f} ms, direct {ms['direct']:.4f} ms; the kernels "
        f"alone: digest {dev_ms['digest']:.4f} ms, direct "
        f"{dev_ms['direct']:.4f} ms; host us a call (median, in turns): "
        f"digest {host['digest']:.1f}, direct {host['direct']:.1f}, the id "
        f"check alone {id_check_us:.1f}")
    n_bodies["bitmap_support"]["full"] = {"ms": ms, "kernels_ms": dev_ms,
                                          "host_us": host}

    # where a full wave's time goes, pass by pass
    for name, fn in (("peel_wave", lambda: pw.peel_wave_cuda(
            bm, bm, alive, k, eu, ev)),
            ("bitmap_support", lambda: bs.bitmap_support_cuda(bm, bm, eu,
                                                              ev))):
        log(f"{name}, one full wave of the digest body under the profiler:")
        profiled(fn, require="probe_pairs", detail=DIGEST_PASSES)

    timings = {}
    for name, call in (
            ("peel_wave",
             lambda: ops.peel_wave_gathered(bm, eu, ev, alive, k,
                                            chunk=CHUNK_ROWS)),
            ("bitmap_support",
             lambda: ops.bitmap_support_gathered(bm, eu, ev,
                                                 chunk=CHUNK_ROWS))):
        ops.use_kernels(False)       # the same call through the plain version
        try:
            timings[name] = time_ms(call, 3)
        finally:
            ops.use_kernels(True)
    # data-dependent bounds: K1 loads rows of alive edges only; K2 (no
    # mask) loads every slot's pair, sentinel slots reading node n-1
    n_alive = int(alive.sum())
    rows1 = int(torch.unique(torch.cat([eu[alive], ev[alive]])).numel())
    rows2 = int(torch.unique(torch.cat([eu, ev])).numel())
    b1 = bound_ms(bm, rows1, 4 + 4 + 1 + 4 + 1, spec.e_cap, n_alive * w)
    b2 = bound_ms(bm, rows2, 4 + 4 + 4, spec.e_cap, spec.e_cap * w)
    stream = 2 * n_alive * w * 4
    log(f"streaming both rows of every alive edge instead: {stream / 1e9:.2f} "
        f"GB = {1e3 * stream / HBM_BYTES_PER_S:.2f} ms at device bandwidth")
    out = {}
    for name, (bms, by, nb), err_k in (("peel_wave", b1, err1),
                                       ("bitmap_support", b2, err2)):
        ms = n_bodies[name]["full"]["ms"]
        dev = n_bodies[name]["full"]["kernels_ms"]
        log(f"{name}: one full wave, digest body {ms['digest']:.4f} ms "
            f"({100 * bms / ms['digest']:.1f}% of the bound; its kernels "
            f"alone {dev['digest']:.4f} ms, "
            f"{100 * bms / dev['digest']:.1f}%), direct body "
            f"{ms['direct']:.4f} ms ({100 * bms / ms['direct']:.1f}%; alone "
            f"{dev['direct']:.4f} ms); bound {bms:.4f} ms by {by}: "
            f"{nb / 1e6:.1f} MB; plain {timings[name]:.1f} ms")
        out[name] = {"err": err_k, "ms": ms["digest"],
                     "plain_ms": timings[name], "bound_ms": bms,
                     "bound_by": by,
                     "bodies": n_bodies[name]}
    out["nonzero"] = stats
    out["id_check_host_us"] = id_check_us
    del st, bm
    torch.cuda.empty_cache()
    return out


def host_components(edges: np.ndarray) -> set:
    """Connected components (as frozensets of nodes) of an edge list."""
    parent: dict[int, int] = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges.tolist():
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    groups: dict[int, set] = {}
    for x in list(parent):
        groups.setdefault(find(x), set()).add(x)
    return {frozenset(s) for s in groups.values()}


def label_components(g, k: int) -> set:
    """Components of ``index.query(k)``'s labels as frozensets of nodes."""
    lab = g.index.query(g.state, k).cpu().numpy()
    edges = g.state.edges.cpu().numpy()
    member = lab < 2**30
    groups: dict[int, set] = {}
    for l, (a, b) in zip(lab[member].tolist(), edges[member].tolist()):
        s = groups.setdefault(l, set())
        s.add(a)
        s.add(b)
    return {frozenset(s) for s in groups.values()}


def update_batch(rng, present: set, n_del: int, n_ins: int):
    """(op, a, b) updates: deletions of present edges, insertions of absent
    pairs, drawn from ``rng``."""
    pres = sorted(present)
    dels = [pres[i] for i in rng.choice(len(pres), n_del, replace=False)]
    ins: set = set()
    while len(ins) < n_ins:
        a, b = (int(x) for x in rng.integers(0, N_NODES, 2))
        key = (min(a, b), max(a, b))
        if a != b and key not in present and key not in ins:
            ins.add(key)
    return [(0, a, b) for a, b in dels] + [(1, a, b) for a, b in sorted(ins)]


DIGEST_PASSES = ("mark_rows", "digest_rows", "probe_pairs", "stream_pairs")
# A profiler session's trace can lack the device records of the first
# launches made in it.  On an H100: in scripts/torch_profiler_window.py,
# plain sessions lost records in 6 of 2,428 sessions, sessions behind a
# scheduled warm-up step in 13, sessions that idled 5 ms first in none;
# here, sessions that idled 50 ms first still lost up to 14 records, every
# one among the launches of the work's first 4.4 ms.  So each session
# launches small kernels for PROFILE_WARMUP_S first, then idles
# PROFILE_GAP_S, and only the calls inside the work's annotation count.
PROFILE_WARMUP_S = 0.02
PROFILE_GAP_S = 0.002
WORK_SPAN = "chip_smoke.work"


def work_records(prof):
    """The runtime calls made inside ``WORK_SPAN`` that launch a kernel, a
    copy or a fill, and their device records (matched by correlation id).
    Returns ``(records, issued, lost, lead_ms)``: each record as ``(name,
    start_ns, end_ns)``; the count of calls; each call without a device
    record as ``(name, ms after the work's first call)``; and the least
    lead of a record's start over its call's (below 0 where the device's
    clock reads behind the host's)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    span = next(e for e in events if e.name() == WORK_SPAN
                and e.device_type() == DeviceType.CPU)
    on_card = {e.correlation_id(): e for e in events
               if e.device_type() == DeviceType.CUDA
               and e.name() != WORK_SPAN}    # not the span's device copy
    calls = [e for e in events if e.device_type() == DeviceType.CPU
             and span.start_ns() <= e.start_ns() <= span.end_ns()
             and any(s in e.name() for s in ("LaunchKernel", "Memcpy",
                                             "Memset"))]
    first = min((e.start_ns() for e in calls), default=0)
    records, lost, leads = [], [], []
    for e in calls:
        r = on_card.get(e.correlation_id())
        if r is None:
            lost.append((e.name(), (e.start_ns() - first) / 1e6))
            continue
        records.append((r.name(), r.start_ns(), r.end_ns()))
        leads.append(r.start_ns() - e.start_ns())
    return records, len(calls), lost, min(leads, default=0) / 1e6


def profile_open():
    """Open ``profiled``'s session by hand, for work that a caller
    delimits itself (a training loop's last step, between two of its
    hooks): the warm-up launches, the gap, then ``WORK_SPAN`` and the
    clock.  ``profile_close`` ends it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync("cuda")
    warm = torch.zeros(1, device="cuda")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    end = time.perf_counter() + PROFILE_WARMUP_S
    while time.perf_counter() < end:
        warm.add_(1)
        sync("cuda")
    time.sleep(PROFILE_GAP_S)
    span = record_function(WORK_SPAN)
    span.__enter__()
    return prof, span, time.perf_counter()


def profiled(fn, forbid: str | None = None, require: str | None = None,
             detail: tuple = (), top: list | None = None) -> float:
    """Run ``fn`` under ``torch.profiler``; log the device's busy share of
    the wall time and the device ops that took the most time.  Busy is the
    union of the intervals in which a kernel, copy or fill of ``fn`` ran
    on the card, over the host's wall time; a lower bound, since the
    profiler slows the host.  Raises if a launch, copy or fill of ``fn``
    lacks its device record (see ``PROFILE_WARMUP_S``), if a device op's
    name holds ``forbid`` or if none holds ``require`` (case ignored);
    logs the device time of the ops whose names hold each string of
    ``detail``; appends the top ops (name, ms, count) to ``top``.  Returns
    the busy share."""
    session = profile_open()
    fn()
    return profile_close(session, forbid, require, detail, top)


def profile_close(session, forbid: str | None = None,
                  require: str | None = None, detail: tuple = (),
                  top: list | None = None) -> float:
    """End a session of ``profile_open`` and read it as ``profiled``
    does."""
    prof, span, t0 = session
    sync("cuda")
    wall = time.perf_counter() - t0
    span.__exit__(None, None, None)
    time.sleep(PROFILE_GAP_S)
    prof.__exit__(None, None, None)
    records, issued, lost, lead = work_records(prof)
    if lost:
        raise AssertionError(
            f"the trace lacks the device records of {len(lost)} of the "
            f"{issued} launches and copies issued: "
            f"{[(n, round(ms, 3)) for n, ms in lost[:20]]} (name, ms after "
            f"the first call); least lead of a record {lead:.3f} ms")
    by_name = {}
    for name, a, b in records:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + (b - a) / 1e3, n + 1)
    busy_ns, last = 0, None
    for _, a, b in sorted(records, key=lambda r: r[1]):
        busy_ns += max(b - (a if last is None else max(a, last)), 0)
        last = b if last is None else max(last, b)
    busy = busy_ns / 1e9
    log(f"profile: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%) over {len(records)} device ops (every "
        f"one of {issued} launches and copies recorded; least lead of a "
        f"record over its call {lead:.3f} ms); top device time:")
    for key, (us, n) in sorted(by_name.items(), key=lambda r: -r[1][0])[:8]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<6d} {key[:90]}")
        if top is not None:
            top.append((key[:90], us / 1e3, n))
    if detail:
        parts = []
        for part in detail:
            hits = [v for k, v in by_name.items() if part in k]
            parts.append(f"{part} {sum(us for us, _ in hits) / 1e3:.3f} ms "
                         f"x{sum(n for _, n in hits)}")
        log(f"profile: " + ", ".join(parts))
    if forbid is not None:
        hits = [k for k in by_name if forbid.lower() in k.lower()]
        if hits:
            raise AssertionError(f"device ops named {forbid!r}: {hits}")
        log(f"profile: no device op named {forbid!r} among "
            f"{len(by_name)} kinds")
    if require is not None and not any(require.lower() in k.lower()
                                       for k in by_name):
        raise AssertionError(f"no device op named {require!r} among "
                             f"{sorted(k[:60] for k in by_name)}")
    return busy / wall


def drive_main_path(core, edges: np.ndarray, dev):
    """The port's main path at full width; returns the graph, the seconds
    of each phase and the initial decomposition (spec, phi, stats), which
    phase 8 holds its sharded decompositions against."""
    sec = {}
    rng = np.random.default_rng(1)
    t = time.perf_counter()
    g = core.DynamicGraph(N_NODES, edges, support_method="bitmap", device=dev)
    sync(dev)
    sec["decompose"] = time.perf_counter() - t
    stats = core.stats_dict(g.last_peel_stats)
    initial = (g.spec, g.state.phi.clone(), stats)
    log(f"initial decomposition: {sec['decompose']:.2f} s, {stats}, "
        f"max truss {g.max_truss()}")
    present = set(map(tuple, edges.tolist()))
    t = time.perf_counter()
    if g.phi_dict() != core.oracle.scratch_phi(N_NODES, present):
        raise AssertionError("initial phi differs from the oracle")
    log(f"initial phi == oracle ({time.perf_counter() - t:.1f} s)")

    def apply(name, ups, profile=False, **kw):
        t0 = time.perf_counter()
        if profile:     # K1/K2 ran their digest body
            profiled(lambda: g.apply_batch(ups, **kw), require="digest_rows",
                     detail=DIGEST_PASSES)
        else:
            g.apply_batch(ups, **kw)
        sync(dev)
        sec[name] = time.perf_counter() - t0
        for op, a, b in ups:
            (present.add if op == 1 else present.discard)((min(a, b), max(a, b)))
        log(f"{name}: {len(ups)} updates, {sec[name]:.2f} s, "
            f"{core.stats_dict(g.last_peel_stats)}")

    for i in range(3):
        apply(f"fused_{i}", update_batch(rng, present, 1000, 1000))
    apply("progressive", update_batch(rng, present, 3, 3))
    apply("recompute", update_batch(rng, present, 1000, 1000),
          engine="recompute")
    # one more batch of each engine under the profiler (times inflated)
    apply("fused_profiled", update_batch(rng, present, 1000, 1000),
          profile=True)
    apply("recompute_profiled", update_batch(rng, present, 1000, 1000),
          profile=True, engine="recompute")

    t = time.perf_counter()
    kmax = g.max_truss()
    for k in sorted({3, 5, kmax}):
        kt = g.k_truss(k)
        comps = label_components(g, k)
        if comps != host_components(kt):
            raise AssertionError(f"k={k}: index components differ from host")
        log(f"k={k}: {len(kt)} edges, {len(comps)} components == host")
    sec["queries"] = time.perf_counter() - t
    return g, sec, initial


SERVICE_WRITES = 1000         # a generation: 500 deletes, 500 inserts
SERVICE_GENS = 4              # serial generations before the queries
SERVICE_AFTER_SNAPSHOT = 2    # generations between the snapshot and restore
SERVICE_HEAL_GENS = 2         # pipelined generations, one landing lost
MAX_K_QUERIES = 1000          # present edges asked for their phi
COMMUNITY_SEEDS = 5           # nodes asked for their community, a level


def span_seconds(tracer, name: str, after: int) -> list:
    """Seconds of each recorded ``name`` span created after sequence
    number ``after`` (the service's own trace)."""
    return [e.dur_ns / 1e9 for e in tracer.events()
            if e.name == name and e.seq > after]


def last_seq(tracer) -> int:
    ev = tracer.events()
    return ev[-1].seq if ev else -1


def median_ms(xs) -> float:
    return 1e3 * float(np.median(xs))


def same_state(a, b, what: str) -> None:
    """Fail unless two graph states are bitwise equal, field by field."""
    for name, x, y in zip(a._fields, a, b):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: GraphState.{name} differs")


def service_gen(svc, rng, present: set, acked: list) -> dict:
    """One generation of writes through ``svc.submit``: deletes of present
    edges, inserts of absent pairs; the last write fills the generation
    (serial: it flushes).  Returns seconds and the ack µs of the writes
    that did not flush."""
    ups = update_batch(rng, present, SERVICE_WRITES // 2, SERVICE_WRITES // 2)
    ack_us = []
    t0 = time.perf_counter()
    for op, a, b in ups:
        t = time.perf_counter()
        ack = svc.submit(op, a, b)
        ack_us.append(1e6 * (time.perf_counter() - t))
        if not hasattr(ack, "wal_index"):
            raise AssertionError(f"write ({op}, {a}, {b}) not acked: {ack}")
        acked.append((ack.gen, op, a, b, ack.wal_index))
        (present.add if op == 1 else present.discard)((a, b))
    sync(svc.graph.device)
    return {"s": time.perf_counter() - t0, "flush_s": ack_us[-1] / 1e6,
            "ack_us": ack_us[:-1]}


def check_queries(svc, service) -> dict:
    """The four query kinds at the committed generation, each checked
    against the state or a host connected-components pass.  The levels
    are the tracked ones and, since the slashdot config's levels can lie
    above this graph's max truss, 3, 5 and the max truss (the truss
    path's levels); the index tracks each level it is asked.  Returns
    ``max_k``'s median ms and, for each level, its edges, components and
    ms of ``members`` and ``representatives`` and the median of
    ``community`` (asked after ``representatives``, so from the index's
    cached labels)."""
    phi = svc.graph.phi_dict()
    rng = np.random.default_rng(3)
    keys = sorted(phi)
    picks = [keys[i] for i in rng.choice(len(keys), MAX_K_QUERIES,
                                         replace=False)]
    max_k = []
    for a, b in picks:
        t = time.perf_counter()
        v = svc.handle(service.QueryRequest(service.MAX_K, edge=(b, a))).value
        max_k.append(time.perf_counter() - t)
        if v != phi[(a, b)]:
            raise AssertionError(f"max_k({a}, {b}) = {v}, phi {phi[(a, b)]}")
    absent = next((0, b) for b in range(1, N_NODES) if (0, b) not in phi)
    if svc.max_k(*absent) != 0:
        raise AssertionError(f"max_k of absent edge {absent} is not 0")
    levels = {}
    for k in sorted(set(svc.graph.index.tracked)
                    | {3, 5, svc.stats()["max_truss"]}, reverse=True):
        t = time.perf_counter()
        members = svc.handle(service.QueryRequest(service.MEMBERS, k=k)).edges
        members_ms = 1e3 * (time.perf_counter() - t)
        if {tuple(e) for e in members.tolist()} != {
                e for e, p in phi.items() if p >= k}:
            raise AssertionError(f"k={k}: members differ from phi >= k")
        t = time.perf_counter()
        reps = svc.handle(service.QueryRequest(
            service.REPRESENTATIVES, k=k)).edges
        reps_ms = 1e3 * (time.perf_counter() - t)
        comps = sorted(host_components(members), key=min)
        if label_components(svc.graph, k) != set(comps):
            raise AssertionError(f"k={k}: the index's components differ "
                                 f"from the host's")
        owner = {x: i for i, comp in enumerate(comps) for x in comp}
        if sorted(owner[a] for a, _ in reps.tolist()) != list(range(len(comps))):
            raise AssertionError(f"k={k}: not one representative a component")
        community = []
        for comp in comps[:COMMUNITY_SEEDS]:
            t = time.perf_counter()
            got = svc.handle(service.QueryRequest(
                service.COMMUNITY, k=k, node=min(comp))).edges
            community.append(time.perf_counter() - t)
            if set(got.reshape(-1).tolist()) != comp:
                raise AssertionError(f"k={k}: community of {min(comp)} "
                                     f"differs from its component")
        levels[k] = {"edges": len(members), "components": len(comps),
                     "members_ms": members_ms, "representatives_ms": reps_ms,
                     "community_ms": median_ms(community) if community
                     else None}
    if not any(lv["components"] for lv in levels.values()):
        raise AssertionError(f"no level has a k-truss to query: {levels}")
    log(f"service queries at gen {svc.gen}: max_k on {MAX_K_QUERIES} edges "
        f"== phi; members, communities and representatives == host at "
        f"levels {sorted(levels, reverse=True)}")
    return {"max_k_ms": median_ms(max_k), "levels": levels}


def drive_service_path(edges: np.ndarray, dev) -> dict:
    """The WAL-backed ``TrussService`` at full width, in a temporary store
    removed at the end; returns its readings."""
    from repro_torch import core, service
    from repro_torch.configs.truss_paper import SLASHDOT
    from repro_torch.faults import PeelChaos
    from repro_torch.kernels import bitmap_support, peel_wave
    from repro_torch.obs import trace as obs_trace

    tracer = obs_trace.TRACER
    out = {"writes_per_gen": SERVICE_WRITES}
    root = tempfile.mkdtemp(prefix="chip_smoke_service_")
    log(f"service store {root}: "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB free")
    kw = dict(flush_every=SERVICE_WRITES, support_method="bitmap", device=dev)
    try:
        # 1. construct: decompose (K2) plus the baseline snapshot
        seq = last_seq(tracer)
        t = time.perf_counter()
        svc = service.TrussService(N_NODES, edges, store=service.TrussStore(root),
                                   tracked_ks=SLASHDOT.query_ks, **kw)
        sync(dev)
        total = time.perf_counter() - t
        snap_s = span_seconds(tracer, "store.snapshot", seq)[0]
        out["construct"] = {"decompose_s": total - snap_s,
                            "snapshot_s": snap_s,
                            "snapshot_bytes": os.path.getsize(svc.store.snap_path)}
        log(f"service construct: {json.dumps(out['construct'])}, "
            f"stats peel {svc.stats()['peel']}")

        # 2. serial ingest: each flush one fused batch (K1)
        rng = np.random.default_rng(5)
        present = set(map(tuple, edges.tolist()))
        acked: list = []
        gens, ack_us = [], []
        k1 = peel_wave.LAUNCHES
        for _ in range(SERVICE_GENS):
            r = service_gen(svc, rng, present, acked)
            ack_us += r["ack_us"]
            st = svc.stats()
            if st["gen"] != len(gens) + 1 or st["pending"]:
                raise AssertionError(f"generation did not commit: {st}")
            gens.append({"s": r["s"], "flush_s": r["flush_s"],
                         "peel": st["peel"]})
            log(f"service gen {st['gen']}: {r['s']:.3f} s ({r['flush_s']:.3f} s "
                f"the flush), peel {st['peel']}")
        if peel_wave.LAUNCHES == k1:
            raise AssertionError("the service's fused flushes launched no K1")
        out["serial"] = {"gens": gens, "ack_us_median": float(np.median(ack_us)),
                         "k1_launches": peel_wave.LAUNCHES - k1}

        # 3. queries at the committed generation
        out["queries"] = check_queries(svc, service)

        # 4. the ladder's recompute fallback (K2)
        k2, fb = bitmap_support.LAUNCHES, svc.stats()["counters"]["engine_fallbacks"]
        svc.chaos = PeelChaos(dispatch_gens={svc.gen + 1})
        r = service_gen(svc, rng, present, acked)
        svc.chaos = None
        st = svc.stats()
        if (st["counters"]["engine_fallbacks"] != fb + 1 or st["degraded"]
                or st["gen"] != SERVICE_GENS + 1):
            raise AssertionError(f"no clean recompute fallback: {st}")
        if bitmap_support.LAUNCHES == k2:
            raise AssertionError("the recompute fallback launched no K2")
        out["fallback"] = {"s": r["s"], "peel": st["peel"],
                           "k2_launches": bitmap_support.LAUNCHES - k2}
        log(f"service recompute fallback: {json.dumps(out['fallback'])}")

        # 5. snapshot, two more generations, restore
        seq = last_seq(tracer)
        t = time.perf_counter()
        svc.snapshot()
        out["snapshot"] = {"s": time.perf_counter() - t,
                           "store_s": span_seconds(tracer, "store.snapshot", seq)[0],
                           "bytes": os.path.getsize(svc.store.snap_path)}
        for _ in range(SERVICE_AFTER_SNAPSHOT):
            service_gen(svc, rng, present, acked)
        svc.store.close()
        seq = last_seq(tracer)
        t = time.perf_counter()
        back = service.TrussService.restore(service.TrussStore(root), **kw)
        sync(dev)
        total = time.perf_counter() - t
        replay = sum(span_seconds(tracer, "gen.replay", seq))
        out["restore"] = {"load_s": total - replay, "replay_s": replay,
                          "replayed_records": back.replayed_records}
        log(f"service snapshot {json.dumps(out['snapshot'])}; restore "
            f"{json.dumps(out['restore'])}")
        same_state(svc.graph.state, back.graph.state, "restore vs live")
        if back.gen != svc.gen or back.replayed_records != (
                SERVICE_AFTER_SNAPSHOT * SERVICE_WRITES):
            raise AssertionError(f"restore at gen {back.gen}, replayed "
                                 f"{back.replayed_records}")
        wal = back.store.read_wal()
        if wal != [x[:4] for x in acked] or [x[4] for x in acked] != list(
                range(len(acked))):
            raise AssertionError("the WAL does not hold every acked write "
                                 "in order with its generation")
        t = time.perf_counter()
        if back.graph.phi_dict() != core.oracle.scratch_phi(N_NODES, present):
            raise AssertionError("restored phi differs from the oracle")
        log(f"service restore == live bitwise; WAL == the {len(acked)} acked "
            f"writes; phi == oracle ({time.perf_counter() - t:.1f} s)")
        back.store.close()
        del svc, back
        torch.cuda.empty_cache()

        # 6. pipelined, one landing lost: self-heal from the store
        g = SERVICE_GENS + 1 + SERVICE_AFTER_SNAPSHOT + 1
        heal = service.TrussService.restore(
            service.TrussStore(root), pipeline=True,
            chaos=PeelChaos(land_gens={g}), **kw)
        heals = heal.stats()["counters"]["self_heals"]
        seq = last_seq(tracer)
        for _ in range(SERVICE_HEAL_GENS):
            service_gen(heal, rng, present, acked)
        heal.flush()
        st = heal.stats()
        heal_s = span_seconds(tracer, "service.self_heal", seq)
        if st["counters"]["self_heals"] <= heals or not heal_s or st["degraded"]:
            raise AssertionError(f"no self-heal: {st}")
        if st["gen"] != g + SERVICE_HEAL_GENS - 1 or st["pending"]:
            raise AssertionError(f"healed service not drained: {st}")
        heal.store.close()
        replay = service.TrussService.restore(service.TrussStore(root), **kw)
        same_state(heal.graph.state, replay.graph.state, "healed vs replay")
        if replay.store.read_wal() != [x[:4] for x in acked]:
            raise AssertionError("the WAL does not hold every acked write")
        t = time.perf_counter()
        if heal.graph.phi_dict() != core.oracle.scratch_phi(N_NODES, present):
            raise AssertionError("healed phi differs from the oracle")
        out["heal"] = {"heal_s": heal_s, "gen": st["gen"]}
        log(f"service heal: {json.dumps(out['heal'])}; healed == replay "
            f"bitwise; phi == oracle ({time.perf_counter() - t:.1f} s)")
        del heal
        torch.cuda.empty_cache()

        # 7. one profiled serial flush
        ups = update_batch(rng, present, SERVICE_WRITES // 2,
                           SERVICE_WRITES // 2)
        for op, a, b in ups[:-1]:
            replay.submit(op, a, b)
        busy = profiled(replay.flush, require="digest_rows",
                        detail=DIGEST_PASSES)
        if replay.stats()["pending"]:
            raise AssertionError("the profiled flush left writes pending")
        out["profiled_flush"] = {"busy": busy,
                                 "peel": replay.stats()["peel"]}
        replay.store.close()
        del replay
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


CLUSTER_WRITES = 1000         # a generation of the mixed workload's writes
CLUSTER_GENS = 4              # generations the router drives
CLUSTER_BOUND = 2             # staleness bound of the bounded reads
CLUSTER_READ_STRIDE = 60      # one read record in this many goes out bounded
CLUSTER_BOUNDARY_READS = 40   # read records asked at each boundary, strong
                              # and read-your-writes each
CLUSTER_PARKED_UNTIL = 3      # replica-1 steps up to this generation only
CLUSTER_TAIL_WRITES = 500     # acked and unflushed when the primary drops


def _counted(launches: dict, path: str, fn):
    """Run ``fn`` and add the K1/K2 launches it made, by body, to
    ``launches[path]``."""
    from repro_torch.kernels import bitmap_support, peel_wave
    mods = {"peel_wave": peel_wave, "bitmap_support": bitmap_support}
    before = {k: (m.LAUNCHES, dict(m.LAUNCHES_BY_BODY)) for k, m in mods.items()}
    out = fn()
    acc = launches.setdefault(path, {})
    for k, m in mods.items():
        n0, by0 = before[k]
        a = acc.setdefault(k, {"launches": 0, "digest": 0, "direct": 0})
        a["launches"] += m.LAUNCHES - n0
        for body in ("digest", "direct"):
            a[body] += m.LAUNCHES_BY_BODY[body] - by0[body]
    return out


def _answer(resp):
    """What a read returned, comparable across nodes."""
    edges = None if resp.edges is None else resp.edges.tolist()
    return resp.gen, resp.value, edges


def _percentiles(ms: list) -> dict:
    return {"n": len(ms), "p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99))} if ms else {"n": 0}


def drive_cluster_path(edges: np.ndarray, dev) -> dict:
    """A ``bitmap`` primary and two replicas on the card behind a
    ``QueryRouter``, driven by the mixed workload at full width, then the
    primary's loss and a promotion; returns the readings and the K1/K2
    launches by path (``primary``, ``replica``, ``promotion``,
    ``replay_check``)."""
    from repro_torch import cluster, core, service
    from repro_torch.data.streams import READ, MixedWorkloadStream

    out: dict = {"writes_per_gen": CLUSTER_WRITES, "bound": CLUSTER_BOUND}
    launches: dict = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    log(f"cluster store {root}: "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB free")
    kw = dict(flush_every=CLUSTER_WRITES, support_method="bitmap", device=dev)
    try:
        t = time.perf_counter()
        primary = _counted(launches, "primary", lambda: service.TrussService(
            N_NODES, edges, store=service.TrussStore(root), tracked_ks=(3, 5),
            **kw))
        sync(dev)
        out["primary_construct_s"] = time.perf_counter() - t
        kmax = primary.stats()["max_truss"]
        ks = tuple(sorted({3, 5, kmax}))
        installs, reps = [], []
        for i in range(2):
            t = time.perf_counter()
            reps.append(_counted(launches, "replica", lambda: cluster.Replica(
                root, f"replica-{i}", support_method="bitmap", device=dev)))
            sync(dev)
            installs.append(time.perf_counter() - t)
            same_state(primary.graph.state, reps[-1].svc.graph.state,
                       f"replica-{i} install vs primary")
        out["install_s"] = installs
        log(f"cluster: primary {out['primary_construct_s']:.2f} s; replica "
            f"installs (snapshot load) {[round(s, 2) for s in installs]} s; "
            f"workload levels {ks}")
        r0, r1 = reps
        router = cluster.QueryRouter(primary, reps, poll_on_miss=False)
        sess = router.session()
        wl = MixedWorkloadStream(edges, N_NODES, chunk=CLUSTER_WRITES,
                                 read_frac=0.9, zipf_s=1.1, ks=ks, seed=7)

        def records():
            while True:
                yield from wl.next()
        recs = records()
        present = set(map(tuple, edges.tolist()))
        acked: list = []
        snap = lambda: type(primary.graph.state)(  # noqa: E731
            *(x.clone() for x in primary.graph.state))
        states = {}
        reads = {"strong": [], "bounded": [], "read_your_writes": []}
        lags: dict = {}
        ack_us, gens = [], []
        n_read = 0

        def submit(op, a, b):
            t = time.perf_counter()
            ack = sess.submit(op, a, b)
            dt = time.perf_counter() - t
            if not hasattr(ack, "wal_index"):
                raise AssertionError(f"write ({op}, {a}, {b}) not acked: {ack}")
            acked.append((ack.gen, op, a, b))
            (present.add if op == 1 else present.discard)((a, b))
            return dt

        def route(rec, consistency):
            req = cluster.query_from_record(rec, consistency=consistency,
                                            bound=CLUSTER_BOUND)
            t = time.perf_counter()
            resp = sess.query(req)
            reads[consistency].append(1e3 * (time.perf_counter() - t))
            lag = primary.gen - resp.gen
            key = f"{consistency} {resp.served_by}"
            lags.setdefault(key, {}).setdefault(lag, 0)
            lags[key][lag] += 1
            return resp

        for g in range(1, CLUSTER_GENS + 1):
            writes, held, last = 0, [], {}
            t0 = time.perf_counter()
            while writes < CLUSTER_WRITES:
                rec = next(recs)
                if rec[0] == READ:
                    n_read += 1
                    if n_read % CLUSTER_READ_STRIDE:
                        held = (held + [rec])[-CLUSTER_BOUNDARY_READS:]
                        continue
                    resp = route(rec, "bounded")
                    if primary.gen - resp.gen > CLUSTER_BOUND:
                        raise AssertionError(
                            f"bounded read served at gen {resp.gen} by "
                            f"{resp.served_by}, primary at {primary.gen}")
                    continue
                _, op, a, b = rec
                dt = _counted(launches, "primary", lambda: submit(op, a, b))
                writes += 1
                last[op] = (a, b)
                if writes < CLUSTER_WRITES:
                    ack_us.append(1e6 * dt)
                else:
                    flush_s = dt
            sync(dev)
            gen_s = time.perf_counter() - t0
            st = primary.stats()
            if st["gen"] != g or st["pending"]:
                raise AssertionError(f"generation {g} did not commit: {st}")
            if g <= CLUSTER_PARKED_UNTIL:
                states[g] = snap()
            # the heartbeat polls replica-0 only: replica-1 stays parked
            t = time.perf_counter()
            _counted(launches, "replica", r0.poll)
            sync(dev)
            apply_s = time.perf_counter() - t
            if r0.gen != g:
                raise AssertionError(f"replica-0 at gen {r0.gen}, not {g}")
            same_state(primary.graph.state, r0.svc.graph.state,
                       f"replica-0 vs primary at gen {g}")
            # at the boundary: strong reads (the primary) against
            # read-your-writes reads (replica-0, caught up), the same
            # answers; then the session's own last insert and delete
            for rec in held:
                s = route(rec, "strong")
                r = route(rec, "read_your_writes")
                if s.served_by != "primary" or r.served_by != "replica-0":
                    raise AssertionError(f"served by {s.served_by} / "
                                         f"{r.served_by}")
                if _answer(s) != _answer(r):
                    raise AssertionError(f"{rec}: replica-0 answered "
                                         f"{_answer(r)[:2]}, the primary "
                                         f"{_answer(s)[:2]}")
            for op, (a, b) in sorted(last.items()):
                r = sess.query(service.QueryRequest(
                    service.MAX_K, edge=(a, b),
                    consistency=service.READ_YOUR_WRITES))
                if r.gen < sess.token or (r.value >= 2) != (op == 1):
                    raise AssertionError(
                        f"session read of its own {'insert' if op else 'delete'}"
                        f" ({a}, {b}): max_k {r.value} at gen {r.gen}, token "
                        f"{sess.token}")
            gens.append({"gen_s": gen_s, "flush_s": flush_s,
                         "replica_apply_s": apply_s, "peel": st["peel"],
                         "reads_held": len(held)})
            log(f"cluster gen {g}: {gen_s:.2f} s ({flush_s:.2f} s the "
                f"flush), replica-0 apply {apply_s:.2f} s == primary "
                f"bitwise; {len(held)} strong == read-your-writes reads; "
                f"session reads its own writes; replica-1 at gen {r1.gen}")
        out["gens"] = gens
        out["ack_us_median"] = float(np.median(ack_us))

        # replica-1 steps up one generation group at a time, each boundary
        # bitwise equal to the primary's at that generation
        steps = []
        for g in range(1, CLUSTER_PARKED_UNTIL + 1):
            t = time.perf_counter()
            _counted(launches, "replica", lambda: r1.poll(max_gens=1))
            sync(dev)
            steps.append(time.perf_counter() - t)
            if r1.gen != g:
                raise AssertionError(f"replica-1 at gen {r1.gen}, not {g}")
            same_state(states.pop(g), r1.svc.graph.state,
                       f"replica-1 vs primary at gen {g}")
        out["replica1_step_s"] = steps
        states.clear()
        out["reads_ms"] = {k: _percentiles(v) for k, v in reads.items()}
        out["lag_gens"] = {k: {str(lag): n for lag, n in sorted(v.items())}
                           for k, v in sorted(lags.items())}
        out["served"] = router.stats()["served"]
        log(f"cluster: replica-1 steps {[round(s, 2) for s in steps]} s, "
            f"bitwise at gens 1-{CLUSTER_PARKED_UNTIL}; primary ack "
            f"{out['ack_us_median']:.1f} us (median); reads ms "
            f"{json.dumps(out['reads_ms'])}; lag in generations by level "
            f"and node {json.dumps(out['lag_gens'])}")

        # the primary drops with a tail acked but unflushed
        tail = 0
        while tail < CLUSTER_TAIL_WRITES:
            rec = next(recs)
            if rec[0] != READ:
                _counted(launches, "primary", lambda: submit(*rec[1:]))
                tail += 1
        if primary.stats()["pending"] != CLUSTER_TAIL_WRITES:
            raise AssertionError("the tail was flushed before the drop")
        primary.store.close()
        router.primary = None
        del primary
        torch.cuda.empty_cache()
        t = time.perf_counter()
        new = _counted(launches, "promotion", router.promote)
        sync(dev)
        out["promotion_s"] = time.perf_counter() - t
        if (router.primary is not new or router.replicas != [r1]
                or new.gen != CLUSTER_GENS + 1):
            raise AssertionError(f"promotion picked the wrong replica or "
                                 f"gen: {router.stats()}")
        wal = new.store.read_wal()
        if wal != acked:
            raise AssertionError("the promoted WAL does not hold every "
                                 "acked write in order")
        t = time.perf_counter()
        chk = _counted(launches, "replay_check", lambda: cluster.Replica(
            root, "check", support_method="bitmap", device=dev))
        _counted(launches, "replay_check", chk.poll)
        sync(dev)
        out["replay_check_s"] = time.perf_counter() - t
        same_state(new.graph.state, chk.svc.graph.state,
                   "promoted vs a replay of the whole WAL")
        del chk
        t = time.perf_counter()
        if new.graph.phi_dict() != core.oracle.scratch_phi(N_NODES, present):
            raise AssertionError("promoted phi differs from the oracle")
        oracle_s = time.perf_counter() - t
        # replica-1 tails the promoted primary
        _counted(launches, "replica", r1.poll)
        same_state(new.graph.state, r1.svc.graph.state,
                   "replica-1 vs the promoted primary")
        log(f"cluster promotion: {out['promotion_s']:.2f} s, replica-0 "
            f"(most caught up) at gen {new.gen}; == a replay of the whole "
            f"WAL bitwise ({out['replay_check_s']:.1f} s); WAL == the "
            f"{len(acked)} acked writes; phi == oracle ({oracle_s:.1f} s); "
            f"replica-1 tails it bitwise")
        new.store.close()
        del new, r0, r1, reps, router, sess
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for path, by in launches.items():
        for name, a in by.items():
            if a["direct"]:
                raise AssertionError(f"{name} on the cluster's {path} path "
                                     f"ran the direct body: {a}")
    if not launches.get("replica", {}).get("peel_wave", {}).get("launches"):
        raise AssertionError("the replicas' applies launched no K1")
    if not launches.get("promotion", {}).get("peel_wave", {}).get("launches"):
        raise AssertionError("the promotion's replay launched no K1")
    out["launches"] = launches
    log(f"cluster launches by path: {json.dumps(launches)}")
    return out


LAUNCHER_TICKS = 3
# The launcher runs its own (and the reference's) default support method,
# ``sorted``, whose waves hold [E_cap, d_max] int64 intermediates: 57 GB each
# at full width (``sorted_sizing`` logs it), several at once, so this phase
# runs at 20,000 nodes (PERF.md, section 6).
LAUNCHER_NODES = 20_000
LAUNCHER_REDUCED = ("--nodes 20000 of 77,360: the sorted support's "
                    "[E_cap, d_max] int64 intermediates are 57 GB each at "
                    "full width; phase 6 holds the full-width path")
LAUNCHER_TIMEOUT_S = 300


def _launcher_env(pkg_dir: str) -> dict:
    """The environment of a launcher subprocess: ``PYTHONPATH`` holds a
    directory with ``repro_torch`` alone (a link to ``src/repro_torch``),
    so the reference package cannot be imported."""
    os.symlink(os.path.join(ROOT, "src", "repro_torch"),
               os.path.join(pkg_dir, "repro_torch"))
    env = dict(os.environ, PYTHONPATH=pkg_dir)
    probe = subprocess.run(
        [sys.executable, "-c", "import importlib.util, sys; sys.exit("
         "importlib.util.find_spec('repro') is not None or "
         "importlib.util.find_spec('repro_torch') is None)"], env=env)
    if probe.returncode:
        raise AssertionError("the launcher's path is not repro_torch alone")
    return env


def _stats_after(text: str, tag: str) -> dict:
    """The stats dict the launcher printed after ``tag`` (last one)."""
    import ast
    line = [x for x in text.splitlines() if x.startswith(tag)][-1]
    body = line[len(tag):]
    return ast.literal_eval(body[:body.rindex("}") + 1])


def run_launcher(args: list, env: dict, timeout: float,
                 on_linger=None) -> tuple:
    """Run ``python -m repro_torch.launch.serve_truss`` with ``args``;
    ``on_linger(url)`` is called with the ``/metrics`` URL once the
    launcher lingers.  Returns ``(exit code, stdout, seconds)``."""
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_truss"] + args,
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, url = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("metrics: "):
                url = line.split()[1]
            if line.startswith("linger:") and on_linger is not None:
                on_linger(url)
            if time.perf_counter() - t > timeout:
                raise AssertionError(f"launcher {args} ran past {timeout} s")
        rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    if rc != 0:
        raise AssertionError(f"launcher {args} exited {rc}:\n{text[-4000:]}")
    return rc, text, time.perf_counter() - t


def sorted_sizing(edges: np.ndarray, dev) -> dict:
    """The ``sorted`` support's [E_cap, d_max] int64 intermediate at full
    width (from the spec ``DynamicGraph`` would build), and a sorted
    decompose at ``LAUNCHER_NODES``: seconds and peak device bytes."""
    from repro_torch import core
    from repro_torch.data.synthetic import powerlaw_graph

    deg = np.bincount(edges.ravel(), minlength=N_NODES)
    e_cap, d_max = 2 * len(edges), max(8, 2 * int(deg.max()))
    out = {"full_width_intermediate_bytes": e_cap * d_max * 8}
    small = powerlaw_graph(LAUNCHER_NODES, M_PER_NODE, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    g = core.DynamicGraph(LAUNCHER_NODES, small, device=dev)
    sync(dev)
    out.update(decompose_s=time.perf_counter() - t,
               peak_bytes=torch.cuda.max_memory_allocated(),
               edges=len(small))
    del g
    torch.cuda.empty_cache()
    log(f"sorted support: one [E_cap {e_cap}, d_max {d_max}] int64 "
        f"intermediate is {out['full_width_intermediate_bytes'] / 1e9:.1f} GB "
        f"at full width; at {LAUNCHER_NODES} nodes ({len(small)} edges) a "
        f"sorted decompose takes {out['decompose_s']:.2f} s, peak "
        f"{out['peak_bytes'] / 1e9:.1f} GB")
    return out


def drive_launcher(dev) -> dict:
    """``python -m repro_torch.launch.serve_truss`` as a subprocess on the
    card: a primary with ``--store``, ``--metrics-port 0`` (scraped while it
    lingers), ``--trace-out``, ``--trace-jsonl`` and ``--profile-dir``;
    then ``--restore``; then ``--router --replicas 2 --pipeline``.  Checks
    the exit codes, the restored generation, every profiled region's
    device records and the merged trace's joins."""
    import urllib.error
    import urllib.request
    from repro_torch.obs import expo, profiling

    out = {"nodes": LAUNCHER_NODES, "reduced": LAUNCHER_REDUCED}
    work = tempfile.mkdtemp(prefix="chip_smoke_launcher_")
    try:
        pkg = os.path.join(work, "path")
        os.makedirs(pkg)
        env = _launcher_env(pkg)
        common = ["--nodes", str(LAUNCHER_NODES), "--degree",
                  str(M_PER_NODE), "--device", str(dev)]
        store, prof = os.path.join(work, "store"), os.path.join(work, "prof")
        jsonl = [os.path.join(work, f"{n}.jsonl") for n in ("primary", "router")]
        scraped = {}

        def scrape(url):
            with urllib.request.urlopen(url, timeout=10) as r:
                scraped["metrics"] = expo.parse(r.read().decode())
            try:    # 200 while every objective is ok, 503 otherwise
                with urllib.request.urlopen(
                        url.replace("/metrics", "/healthz"), timeout=10) as r:
                    scraped["health"] = (r.status, json.loads(r.read()))
            except urllib.error.HTTPError as exc:
                scraped["health"] = (exc.code, json.loads(exc.read()))

        _, text, out["primary_s"] = run_launcher(
            common + ["--store", store, "--ticks", str(LAUNCHER_TICKS),
                      "--metrics-port", "0", "--linger", "2",
                      "--trace-out", os.path.join(work, "trace.json"),
                      "--trace-jsonl", jsonl[0], "--profile-dir", prof],
            env, LAUNCHER_TIMEOUT_S, on_linger=scrape)
        gen = _stats_after(text, "final: ")["gen"]
        fams = scraped.get("metrics", {})
        for fam in ("truss_flush_total", "truss_committed_gen",
                    "truss_peel_seconds", "truss_query_seconds"):
            if fam not in fams:
                raise AssertionError(f"/metrics lacks {fam}")
        code, health = scraped["health"]
        if health.get("status") not in ("ok", "burning", "violated") or (
                code == 200) != (health["status"] == "ok"):
            raise AssertionError(f"/healthz answered {code} {health}")
        log(f"launcher primary: {out['primary_s']:.1f} s, gen {gen}; "
            f"/metrics scraped while lingering ({len(fams)} families, "
            f"committed gen {fams['truss_committed_gen']['values']}), "
            f"/healthz {code} {json.dumps(health)}")

        _, text, out["restore_s"] = run_launcher(
            common + ["--store", store, "--restore", "--ticks", "2"],
            env, LAUNCHER_TIMEOUT_S)
        restored = _stats_after(text, "restored: ")["gen"]
        final = _stats_after(text, "final: ")["gen"]
        if restored != gen or final <= gen:
            raise AssertionError(f"--restore at gen {restored} -> {final}, "
                                 f"the first run ended at {gen}")
        log(f"launcher --restore: {out['restore_s']:.1f} s, continued from "
            f"gen {restored} to {final}")

        _, text, out["router_s"] = run_launcher(
            common + ["--store", os.path.join(work, "store2"), "--router",
                      "--replicas", "2", "--pipeline", "--ticks",
                      str(LAUNCHER_TICKS), "--chunk", "64", "--flush-every",
                      "8", "--trace-jsonl", jsonl[1]],
            env, LAUNCHER_TIMEOUT_S)
        log(f"launcher --router --replicas 2 --pipeline: "
            f"{out['router_s']:.1f} s; "
            f"{[x for x in text.splitlines() if 'reads: p50' in x]}")

        merged = os.path.join(work, "merged.json")
        m = subprocess.run([sys.executable, "-m", "repro_torch.obs.merge",
                            merged] + jsonl, env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        if m.returncode:
            raise AssertionError(f"merge exited {m.returncode}: {m.stderr}")
        names: dict = {}
        with open(merged) as f:
            for ev in json.load(f)["traceEvents"]:
                tid = (ev.get("args") or {}).get("trace_id")
                if ev.get("ph") == "X" and tid is not None:
                    names.setdefault(tid, set()).add(ev["name"])
        joined = sum(1 for n in names.values() if "gen.replay" in n
                     and any(x.startswith("router.write") for x in n))
        if not joined:
            raise AssertionError("no replica apply joined a write's trace")
        log(f"launcher traces merged: {m.stdout.strip()}; {joined} trace "
            f"ids join replica applies to the router's writes")

        traces = {}
        for name in sorted(os.listdir(prof)):
            issued, lost = profiling.lost_records(os.path.join(prof, name))
            if lost or not issued:
                raise AssertionError(f"{name}: {issued} launches and copies, "
                                     f"lost {lost[:10]}")
            traces[name] = issued
        if not any(n.startswith("decompose-") for n in traces) or not any(
                n.startswith("flush-") for n in traces):
            raise AssertionError(f"profiled regions: {sorted(traces)}")
        out["profiled"] = traces
        log(f"launcher profiled regions (launches and copies, each with its "
            f"device record): {json.dumps(traces)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# Phase 8: the sharded substrate at full width.  A ShardMesh's shards cycle
# over the visible cards (ROADMAP R6), so on one H100 every shard is cuda:0:
# the phase holds the sharded engines bitwise against mesh=None and counts
# their launches; it measures no multi-card speed-up.  The sorted method
# under a mesh holds [E/S, d_max] int64 intermediates (14 GB a shard at
# S = 4 and full width), so it runs in the CPU tests only.
SHARD_COUNTS = (2, 4)
SHARD_BATCH = 1000            # deletes and inserts: one fused batch of 2,000
SHARD_WRITES = 500            # deletes and inserts: a generation of 1,000
PROFILED_REPEEL = 2000        # edges of the profiled re-peel under the mesh


def _record(core, g):
    """Clones of a graph's state arrays and its last PeelStats."""
    return [x.clone() for x in g.state], core.stats_dict(g.last_peel_stats)


def _same_record(core, g, rec, what: str) -> None:
    arrays, stats = rec
    for name, x, y in zip(g.state._fields, g.state, arrays):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: GraphState.{name} differs from "
                                 f"mesh=None")
    got = core.stats_dict(g.last_peel_stats)
    if got != stats:
        raise AssertionError(f"{what}: PeelStats {got} != mesh=None {stats}")


def _launches_by_body(mods) -> dict:
    return {m.__name__.rsplit(".", 1)[-1]: dict(m.LAUNCHES_BY_BODY)
            for m in mods}


def _diff(after: dict, before: dict) -> dict:
    return {k: {b: after[k][b] - before[k][b] for b in after[k]}
            for k in after}


def time_wave_parts(core, mesh, g, n_dead: int, dev) -> dict:
    """Per-wave costs of the edge-sharded delta engine on this graph: the
    decision (a 4-lane int32 tensor a shard, one ``pmin``, one host read;
    host µs, median of 200) and the bit exchange for a seeded dead set of a
    mean wave's size (the shards' dead masks gathered, one
    ``update_bitmap`` clear of the bitmap copy; ms, median of 20, each
    clear undone outside the timing), beside the reference's literal form
    (each shard's zero-filled ``[N, W]`` partial bitmap of its dead edges,
    summed, then subtracted)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.peel import _decision

    devs = mesh.shard_devices("shard")
    lanes = [torch.tensor([5, 7, 1, 0], dtype=torch.int32, device=d)
             for d in devs]
    for _ in range(20):
        _decision(lanes)
    ts = []
    for _ in range(200):
        t0 = time.perf_counter()
        _decision(lanes)
        ts.append(time.perf_counter() - t0)
    spec, st, bm = g.spec, g.state, g._bitmap
    act = st.active.nonzero().reshape(-1).cpu().numpy()
    rng = np.random.default_rng(5)
    dead = torch.zeros_like(st.active)
    dead[torch.from_numpy(rng.choice(act, n_dead, replace=False)).to(dev)] = True
    blk = spec.e_cap // len(devs)
    parts = [dead[s * blk:(s + 1) * blk] for s in range(len(devs))]
    u, v = st.edges[:, 0], st.edges[:, 1]
    before = bm.clone()

    def exchange():
        gone = dist.all_gather(parts)[0]
        core.update_bitmap(spec, bm, u, v, gone, set_bits=False)

    def literal():
        return bm - dist.psum([core.partial_bitmap(
            spec, st.edges[s * blk:(s + 1) * blk], p)
            for s, p in enumerate(parts)])[0]

    times = {"exchange": [], "literal": []}
    for _ in range(22):
        for name, fn in (("exchange", exchange), ("literal", literal)):
            sync(dev)
            t0 = time.perf_counter()
            res = fn()
            sync(dev)
            times[name].append(time.perf_counter() - t0)
            if name == "exchange":
                core.update_bitmap(spec, bm, u, v, dead, set_bits=True)
            else:
                cleared = res
    exchange()
    if not torch.equal(bm, cleared):
        raise AssertionError("the gathered-mask exchange and the summed "
                             "partial bitmaps clear different bits")
    core.update_bitmap(spec, bm, u, v, dead, set_bits=True)
    if not torch.equal(bm, before):
        raise AssertionError("the bitmap did not come back after the timing")
    return {"decision_host_us": 1e6 * float(np.median(ts)),
            "exchange_ms": 1e3 * float(np.median(times["exchange"][2:])),
            "literal_psum_ms": 1e3 * float(np.median(times["literal"][2:])),
            "dead_edges": n_dead}


def drive_sharded_path(core, edges: np.ndarray, dev, initial, mods) -> dict:
    """Phase 8 (see the module docstring): the mesh=None references first,
    then, with the launch counts set to 0, every sharded run."""
    from repro_torch.core.distributed import distributed_decompose
    from repro_torch.core.peel import set_wave_profile
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.service import TrussService

    spec0, phi0, stats0 = initial
    out = {"card": card_line(), "runs": {}}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(8)
    present = set(map(tuple, edges.tolist()))
    batch = update_batch(rng, present, SHARD_BATCH, SHARD_BATCH)
    writes = update_batch(rng, present, SHARD_WRITES, SHARD_WRITES)

    # mesh=None references (not the sharded path: counted nowhere), timed
    # as the sharded runs are
    ref = {}

    def timed(name, fn):
        t = time.perf_counter()
        res = fn()
        sync(dev)
        ref[name] = time.perf_counter() - t
        return res

    base = core.from_edge_list(spec0, edges, dev)._replace(phi=phi0.clone())
    g0 = core.DynamicGraph.from_state(spec0, [x.clone() for x in base],
                                      support_method="bitmap", device=dev)
    g0._bitmap_cache()   # as a constructed graph holds it
    timed("batch_s", lambda: g0.apply_batch(batch, strategy="fused"))
    want_batch, want_bitmap = _record(core, g0), g0._bitmap.clone()
    del g0
    re0 = timed("recompute_decompose_s", lambda: core.decompose_with_stats(
        spec0, base, "bitmap", engine="recompute", device=dev))
    re0 = (re0[0].clone(), core.stats_dict(re0[1]))
    svc0 = timed("service_construct_s", lambda: TrussService(
        N_NODES, edges, support_method="bitmap",
        flush_every=2 * SHARD_WRITES, device=dev))
    timed("service_generation_s",
          lambda: [svc0.submit(*w) for w in writes])
    if svc0.gen != 1:
        raise AssertionError(f"the mesh=None service is at gen {svc0.gen}")
    want_svc = _record(core, svc0.graph)
    del svc0, base
    out["mesh_none"] = ref
    torch.cuda.empty_cache()

    reset_counts(*mods)
    mesh4 = None
    for n_shards in SHARD_COUNTS:
        mesh = make_shard_mesh(n_shards, device="cuda")
        if n_shards == 4:
            mesh4 = mesh
        for partition in ("replicated", "nodes"):
            tag = f"S={n_shards} {partition}"
            torch.cuda.reset_peak_memory_stats()
            counts = _launches_by_body(mods)
            # the mesh=None references stay resident: the run's own peak is
            # max_memory_allocated - memory_allocated_before
            run = {"memory_allocated_before": torch.cuda.memory_allocated()}
            t = time.perf_counter()
            g = core.DynamicGraph(N_NODES, edges, support_method="bitmap",
                                  mesh=mesh, partition=partition, device=dev)
            sync(dev)
            run["decompose_s"] = time.perf_counter() - t
            if g.spec.e_cap != spec0.e_cap or not torch.equal(g.state.phi,
                                                              phi0):
                raise AssertionError(f"{tag}: decompose phi differs from "
                                     f"phase 4's")
            stats = core.stats_dict(g.last_peel_stats)
            if stats != stats0:
                raise AssertionError(f"{tag}: PeelStats {stats} != phase 4's "
                                     f"{stats0}")
            run["waves"] = stats["waves"]
            run["bitmap_bytes_per_device"] = g.spec.bitmap_bytes_per_device
            if partition == "nodes" and [tuple(s.shape) for s in g._bitmap] \
                    != [(N_NODES, g.spec.word_block)] * n_shards:
                raise AssertionError(f"{tag}: slabs {g._bitmap}")
            if n_shards == 4 and partition == "replicated":
                t = time.perf_counter()
                phi, ps = core.decompose_with_stats(
                    g.spec, g.state, "bitmap", engine="recompute", mesh=mesh,
                    device=dev)
                sync(dev)
                run["recompute_decompose_s"] = time.perf_counter() - t
                if not torch.equal(phi, re0[0]) or \
                        core.stats_dict(ps) != re0[1]:
                    raise AssertionError(f"{tag}: the recompute decompose "
                                         f"differs from mesh=None's")
                run["recompute_waves"] = re0[1]["waves"]
                out["wave_parts"] = time_wave_parts(
                    core, mesh, g, max(1, stats0["kills"] // stats0["waves"]),
                    dev)
            t = time.perf_counter()
            g.apply_batch(batch, strategy="fused")
            sync(dev)
            run["batch_s"] = time.perf_counter() - t
            _same_record(core, g, want_batch, f"{tag} batch")
            bm = core.join_slabs(g._bitmap) if partition == "nodes" \
                else g._bitmap
            w = want_bitmap.shape[1]
            if not torch.equal(bm[:, :w], want_bitmap) or bm[:, w:].any():
                raise AssertionError(f"{tag}: the bitmap after the batch "
                                     f"differs from mesh=None's")
            run["batch_waves"] = want_batch[1]["waves"]
            run["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            run["launches_by_body"] = _diff(_launches_by_body(mods), counts)
            out["runs"][tag] = run
            log(f"phase 8 {tag} ({out['card']}): {json.dumps(run)}")
            del g, bm
            torch.cuda.empty_cache()

    t = time.perf_counter()
    dmesh = make_shard_mesh(4, axis="data", device="cuda")
    phi = distributed_decompose(core.GraphSpec(N_NODES, spec0.d_max,
                                               len(edges)),
                                dmesh, edges, delta=True)
    out["distributed_decompose_s"] = time.perf_counter() - t
    if not np.array_equal(phi, phi0[:len(edges)].cpu().numpy()):
        raise AssertionError("distributed_decompose phi differs from the "
                             "oracle's (phase 4)")

    t = time.perf_counter()
    svc = TrussService(N_NODES, edges, support_method="bitmap",
                       flush_every=2 * SHARD_WRITES, mesh=mesh4,
                       partition="nodes", device=dev)
    out["service_construct_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for w in writes:
        svc.submit(*w)
    sync(dev)
    out["service_generation_s"] = time.perf_counter() - t
    if svc.gen != 1:
        raise AssertionError(f"the sharded service is at gen {svc.gen}")
    _same_record(core, svc.graph, want_svc, "service generation")
    out["service_memory"] = svc.stats()["memory"]

    # the wave profiler under the mesh: the decision's share of each wave
    def share_hist():
        h = obs_metrics.REGISTRY.snapshot()[
            "truss_peel_wave_collective_share"]["values"][()]
        return h["count"], h["sum"]

    n0, s0 = share_hist()
    st = svc.graph.state
    act = st.active.nonzero().reshape(-1).cpu().numpy()
    mask = torch.zeros_like(st.active)
    mask[torch.from_numpy(np.random.default_rng(9).choice(
        act, PROFILED_REPEEL, replace=False)).to(dev)] = True
    plain = core.peel(svc.graph.spec, st, mask, method="bitmap", mesh=mesh4,
                      device=dev)
    set_wave_profile(True)
    try:
        prof = core.peel(svc.graph.spec, st, mask, method="bitmap",
                         mesh=mesh4, device=dev)
    finally:
        set_wave_profile(False)
    if not torch.equal(plain[0], prof[0]):
        raise AssertionError("the profiled re-peel's phi differs")
    n1, s1 = share_hist()
    if n1 - n0 != int(prof[1].waves) or n1 == n0:
        raise AssertionError(f"{n1 - n0} collective-share observations for "
                             f"{int(prof[1].waves)} profiled waves")
    out["collective_share"] = {"waves": n1 - n0,
                               "mean": (s1 - s0) / (n1 - n0)}
    del svc, st, mask
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def build_all(_build) -> None:
    """Compile every CUDA source at once (one ``nvcc`` each, started
    together); log the build seconds and each compiler report."""
    t = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(_build.build, SOURCES))
    log(f"kernels built in {time.perf_counter() - t:.1f} s (in parallel)")
    for name, path in zip(SOURCES, paths):
        _build.library(name)
        log(f"--- {name} -> {path}")
        log((path.parent / "build.log").read_text().strip())


def k3_compile_report(_build, fa) -> None:
    """Each K3 body's registers and spills from ``build.log`` (``-Xptxas
    -v``) and the dynamic shared memory its launch asks for; raises where a
    wgmma instantiation spills or needs more shared memory than a block
    may use, or where one of its head dims is missing from the report."""
    import re
    log_text = (_build.library_path("flash_attention").parent
                / "build.log").read_text()
    lib = _build.library("flash_attention")
    entry = re.compile(r"Compiling entry function '\S*?(flash_attention_wgmma|"
                       r"flash_attention_fwd)I(f|13__nv_bfloat16)?Li(\d+)E")
    spill = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
    regs = re.compile(r"Used (\d+) registers")
    cur, wgmma_dims = None, set()
    for line in log_text.splitlines():
        m = entry.search(line)
        if m:
            wg = m.group(1) == "flash_attention_wgmma"
            bf16 = wg or m.group(2) != "f"
            cur = {"body": "wgmma" if wg else "simt",
                   "dtype": "bf16" if bf16 else "fp32", "d": int(m.group(3))}
        elif cur is not None and spill.search(line):
            cur["spill"] = spill.search(line).groups()
        elif cur is not None and regs.search(line):
            smem = lib.flash_attention_smem_bytes(
                int(cur["body"] == "wgmma"), cur["d"],
                int(cur["dtype"] == "bf16"))
            note = (" (the consumer warpgroups raise theirs to 240 with "
                    "setmaxnreg, the producer drops to 24)"
                    if cur["body"] == "wgmma" else "")
            spills = cur.get("spill", ("?", "?"))
            log(f"K3 {cur['body']} body, {cur['dtype']} D={cur['d']}: "
                f"{regs.search(line).group(1)} registers at launch{note}, "
                f"spill stores/loads {'/'.join(spills)} "
                f"bytes, dynamic shared memory {smem:,} bytes")
            if cur["body"] == "wgmma":
                if spills != ("0", "0") or not 0 < smem <= SMEM_LIMIT:
                    raise AssertionError(
                        f"K3 wgmma body D={cur['d']}: spills {spills}, "
                        f"shared memory {smem} (limit {SMEM_LIMIT})")
                wgmma_dims.add(cur["d"])
            cur = None
    if wgmma_dims != set(fa.WGMMA_HEAD_DIMS):
        raise AssertionError(f"compile report has the wgmma body at "
                             f"{sorted(wgmma_dims)}, expected "
                             f"{fa.WGMMA_HEAD_DIMS}")


def cin_compile_report(_build) -> dict:
    """K5's registers, spills and shared memory per kernel from
    ``build.log`` (``-Xptxas -v``) and the GEMM's dynamic shared memory;
    raises where a kernel spills or needs more shared memory than a block
    may use, or where the GEMM is missing from the report.  Returns the
    GEMM's numbers."""
    import re
    log_text = (_build.library_path("cin").parent / "build.log").read_text()
    dynamic = _build.library("cin").cin_layer_smem_bytes()
    entry = re.compile(r"Compiling entry function '\S*?(cin_gemm|"
                       r"cin_reduceILi(\d+)E)")
    spill = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
    regs = re.compile(r"Used (\d+) registers")
    static_smem = re.compile(r"(\d+) bytes smem")
    cur, gemm = None, None
    for line in log_text.splitlines():
        m = entry.search(line)
        if m:
            cur = {"name": "cin_gemm" if m.group(2) is None
                   else f"cin_reduce<{m.group(2)}>"}
        elif cur is not None and spill.search(line):
            cur["spill"] = tuple(map(int, spill.search(line).groups()))
        elif cur is not None and regs.search(line):
            sm = static_smem.search(line)
            shared = (int(sm.group(1)) if sm else 0) + (
                dynamic if cur["name"] == "cin_gemm" else 0)
            spills = cur.get("spill", (-1, -1))
            log(f"K5 {cur['name']}: {regs.search(line).group(1)} registers, "
                f"spill stores/loads {spills[0]}/{spills[1]} bytes, shared "
                f"memory {shared:,} bytes")
            if spills != (0, 0) or shared > SMEM_LIMIT:
                raise AssertionError(f"K5 {cur['name']}: spills {spills}, "
                                     f"shared memory {shared} (limit "
                                     f"{SMEM_LIMIT})")
            if cur["name"] == "cin_gemm":
                gemm = {"registers": int(regs.search(line).group(1)),
                        "spill_bytes": sum(spills), "shared_bytes": shared}
            cur = None
    if gemm is None:
        raise AssertionError("compile report has no cin_gemm")
    return gemm


def _normal(rng, shape, dtype, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=dev, dtype=dtype)


def check_close(got, exp, tol: float, what: str,
                rtol: float | None = None) -> float:
    """Max |kernel - plain| in fp32; raises where an element is off by more
    than ``tol`` (absolute) or, with ``rtol``, by more than ``tol + rtol *
    |plain|`` (``torch.testing.assert_close``), or on a shape, type or
    finiteness mismatch."""
    if got.shape != exp.shape or got.dtype != exp.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{exp.dtype}{tuple(exp.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = float((got.float() - exp.float()).abs().max())
    if rtol is not None:
        try:
            torch.testing.assert_close(got.float(), exp.float(), rtol=rtol,
                                       atol=tol)
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}") from None
    elif not err <= tol:
        raise AssertionError(f"{what}: max |kernel - plain| = {err} > {tol}")
    return err


def check_flash_attention(ops, ref, fa, dev) -> dict:
    """K3 against its plain version on the card; returns, per body, the max
    abs error of each group of cases that body ran."""
    errs, mean_abs = {"wgmma": {}, "simt": {}}, {}

    def ran(before) -> str:
        """The one body launched since ``before`` (a copy of the counts)."""
        diff = {b: n - before[b] for b, n in fa.LAUNCHES_BY_BODY.items()}
        bodies = [b for b, n in diff.items() if n]
        if len(bodies) != 1:
            raise AssertionError(f"expected one body, launches {diff}")
        return bodies[0]

    def keep(body, name, e):
        errs[body][name] = max(errs[body].get(name, 0.0), e)

    for dtype in (torch.float32, torch.bfloat16):
        for bh, sq, dh in K3_SWEEP:
            rng = np.random.default_rng(bh * sq)
            q, k, v = (_normal(rng, (bh, sq, dh), dtype, dev) for _ in range(3))
            for window in (None, 32):
                n = dict(fa.LAUNCHES_BY_BODY)
                got = ops.flash_attention(q, k, v, window=window)
                keep(ran(n), f"sweep {str(dtype)[6:]}", check_close(
                    got, ref.attention_ref(q, k, v, window=window),
                    K3_TOL[dtype], f"K3 sweep {bh}x{sq}x{dh} w={window} "
                    f"{dtype}"))
    rng = np.random.default_rng(100)
    q, k, v = (_normal(rng, (3, 100, 64), torch.float32, dev) for _ in range(3))
    n = dict(fa.LAUNCHES_BY_BODY)
    got = ops.flash_attention(q, k, v, causal=False)
    keep(ran(n), "causal=False S=100", check_close(
        got, ref.attention_ref(q, k, v, causal=False), 2e-5,
        "K3 causal=False"))

    # the wgmma body at each head dim: ragged lengths, a window, and a V
    # whose columns differ (a swapped or transposed V operand would show)
    for dh, sq in K3_WGMMA_CASES:
        rng = np.random.default_rng(dh + sq)
        q, k = (_normal(rng, (2, sq, dh), torch.bfloat16, dev) for _ in range(2))
        v = (_normal(rng, (2, sq, dh), torch.float32, dev)
             + torch.linspace(-2.0, 3.0, dh, device=dev)).to(torch.bfloat16)
        for window in (None, 40):
            n = dict(fa.LAUNCHES_BY_BODY)
            got = ops.flash_attention(q, k, v, window=window)
            if ran(n) != "wgmma":
                raise AssertionError(f"bf16 D={dh} did not run the wgmma body")
            keep("wgmma", "D 64/128/256, S 300/1000/4096, V columns differ",
                 check_close(got, ref.attention_ref(q, k, v, window=window),
                             K3_PATH_ATOL, f"K3 wgmma D={dh} S={sq} "
                             f"w={window}", K3_PATH_RTOL))

    # the path's shapes: |o| is about 0.03 at a median causal row (a row
    # averages ~S/2 values of v), so these are held to about one bf16 step
    # of each value, not to the sweep's absolute 3e-2
    bh, s, dh = K3_SHAPE
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, K3_SHAPE, torch.bfloat16, dev) for _ in range(3))
    for window in (None, 1024):
        name = f"{list(K3_SHAPE)} bf16 window={window}"
        n = dict(fa.LAUNCHES_BY_BODY)
        got = ops.flash_attention(q, k, v, window=window)
        body = ran(n)
        mean_abs[name] = 0.0
        for c in range(0, bh, 8):      # plain version 8 heads at a time
            exp = ref.attention_ref(q[c:c + 8], k[c:c + 8], v[c:c + 8],
                                    window=window)
            keep(body, name, check_close(
                got[c:c + 8], exp, K3_PATH_ATOL, f"K3 {K3_SHAPE} w={window}",
                K3_PATH_RTOL))
            mean_abs[name] += float(exp.float().abs().mean()) / (bh // 8)
        if window is None:             # the SIMT body, asked for by name
            simt = fa.flash_attention_cuda(q[:, :, None], k[:, :, None],
                                           v[:, :, None], body="simt")[:, :, 0]
            keep("simt", "SIMT vs wgmma at " + name, check_close(
                simt, got, K3_PATH_ATOL, "K3 SIMT vs wgmma", K3_PATH_RTOL))
    hq = bh // PREFILL_BATCH
    qh = _normal(rng, (PREFILL_BATCH, s, hq, dh), torch.bfloat16, dev)
    kh, vh = (_normal(rng, (PREFILL_BATCH, s, hq // 2, dh), torch.bfloat16, dev)
              for _ in range(2))
    name = f"prefill GQA {list(qh.shape)} q / {kh.shape[2]} kv heads bf16"
    exp = ref.chunked_attention_ref(
        qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
        causal=True, window=None).transpose(1, 2)
    n = dict(fa.LAUNCHES_BY_BODY)
    got = ops.flash_attention_heads(qh, kh, vh)
    keep(ran(n), name, check_close(got, exp, K3_PATH_ATOL, "K3 GQA prefill",
                                   K3_PATH_RTOL))
    mean_abs[name] = float(exp.float().abs().mean())
    del qh, kh, vh, exp

    # gemma-2b's MQA layout at head dim 256: the default body (wgmma) and
    # the SIMT body asked for by name, each against the plain version and
    # against each other
    rng = np.random.default_rng(3)
    hq, hkv, dg = GEMMA_HEADS
    qg = _normal(rng, (GEMMA_BATCH, GEMMA_SEQ, hq, dg), torch.bfloat16, dev)
    kg, vg = (_normal(rng, (GEMMA_BATCH, GEMMA_SEQ, hkv, dg), torch.bfloat16,
                      dev) for _ in range(2))
    name = f"{GEMMA_ARCH} MQA {list(qg.shape)} q / {hkv} kv head bf16"
    exp = ref.chunked_attention_ref(
        qg.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
        causal=True, window=None).transpose(1, 2)
    mean_abs[name] = float(exp.float().abs().mean())
    n = dict(fa.LAUNCHES_BY_BODY)
    got = ops.flash_attention_heads(qg, kg, vg)
    if ran(n) != "wgmma":
        raise AssertionError(f"{GEMMA_ARCH}'s layout did not run the wgmma "
                             f"body")
    keep("wgmma", name, check_close(got, exp, K3_PATH_ATOL, "K3 gemma MQA",
                                    K3_PATH_RTOL))
    simt = fa.flash_attention_cuda(qg, kg, vg, body="simt")
    keep("simt", name, check_close(simt, exp, K3_PATH_ATOL,
                                   "K3 SIMT gemma MQA", K3_PATH_RTOL))
    keep("simt", "SIMT vs wgmma at " + name, check_close(
        simt, got, K3_PATH_ATOL, "K3 SIMT vs wgmma, gemma MQA", K3_PATH_RTOL))
    del qg, kg, vg, exp, got, simt

    # the SIMT body's path: the prefill of gemma-2b's smoke config (head dim
    # 32, bf16) at its shape
    from repro_torch.configs import get_config
    sm = get_config(GEMMA_ARCH).smoke
    qs = _normal(rng, (SIMT_BATCH, SIMT_SEQ, sm.n_heads, sm.head_dim),
                 torch.bfloat16, dev)
    ks, vs = (_normal(rng, (SIMT_BATCH, SIMT_SEQ, sm.n_kv, sm.head_dim),
                      torch.bfloat16, dev) for _ in range(2))
    name = (f"{sm.name} prefill {list(qs.shape)} q / {sm.n_kv} kv head "
            f"bf16")
    exp = ref.chunked_attention_ref(
        qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
        causal=True, window=None).transpose(1, 2)
    mean_abs[name] = float(exp.float().abs().mean())
    n = dict(fa.LAUNCHES_BY_BODY)
    got = ops.flash_attention_heads(qs, ks, vs)
    if ran(n) != "simt":
        raise AssertionError(f"{sm.name}'s layout did not run the SIMT body")
    keep("simt", name, check_close(got, exp, K3_PATH_ATOL,
                                   "K3 SIMT gemma smoke", K3_PATH_RTOL))
    for body, groups in errs.items():
        for name, e in groups.items():
            held = (f" (mean |plain| {mean_abs[name]:.3g}; held to atol "
                    f"{K3_PATH_ATOL:g} + rtol {K3_PATH_RTOL:g} x |plain|)"
                    if name in mean_abs else "")
            log(f"K3 {body} body vs plain, {name}: max abs err {e:.3g}{held}")
    return errs


def attention_pairs(s: int, causal: bool, window) -> int:
    """Unmasked (q, k) pairs of one head with Sq == Skv == s."""
    q = np.arange(s)
    hi = q + 1 if causal else np.full(s, s)
    lo = np.zeros(s, np.int64) if window is None else np.maximum(q - window + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def k3_bound(q, k, flops: float):
    """Least time of one K3 call: q and k/v read once and o written once
    (bytes), or ``flops`` at the bf16 tensor-core peak (operations).
    Returns (ms, 'bytes' | 'operations', bytes)."""
    n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", n_bytes)


def time_flash_attention(ops, ref, fa, dev) -> dict:
    """K3 at ``[64, 4096, 128]`` bf16 causal, at the prefill's GQA layout
    ``[4, 4096, 16 q / 8 kv, 128]`` and at ``gemma-2b``'s layout ``[1, 4096,
    8 q / 1 kv, 256]``: the wgmma body and the SIMT body (asked for by
    name), timed in turns (wgmma, SIMT, SIMT, wgmma), the plain version and
    ``scaled_dot_product_attention`` (the yardstick; the port never calls
    it).  CUDA events, median of 10 after warm-up (the plain version and
    the SIMT body at the 128 head-dim layouts: median of 3); the bounds from
    this run's inputs.  Returns {"flat" | "gqa" | "gemma": {"wgmma",
    "simt", "plain", "sdpa": ms, "bound": (ms, by, bytes)}}."""
    import torch.nn.functional as F

    def plain_ms(call) -> float:
        ops.use_kernels(False)
        try:
            return time_ms(call, 3)
        finally:
            ops.use_kernels(True)

    out = {}
    bh, s, dh = K3_SHAPE
    rng = np.random.default_rng(2)
    q, k, v = (_normal(rng, K3_SHAPE, torch.bfloat16, dev) for _ in range(3))
    hq = bh // PREFILL_BATCH
    qh = _normal(rng, (PREFILL_BATCH, s, hq, dh), torch.bfloat16, dev)
    kh, vh = (_normal(rng, (PREFILL_BATCH, s, hq // 2, dh), torch.bfloat16, dev)
              for _ in range(2))
    pairs = attention_pairs(s, True, None)
    for key, name, args in (
            ("flat", f"{list(K3_SHAPE)}", (q[:, :, None], k[:, :, None],
                                           v[:, :, None])),
            ("gqa", f"prefill GQA {list(qh.shape)} q / {kh.shape[2]} kv",
             (qh, kh, vh))):
        wg = lambda: fa.flash_attention_cuda(*args)                # noqa: E731
        simt = lambda: fa.flash_attention_cuda(*args, body="simt")  # noqa: E731
        t = [time_ms(wg, 10), time_ms(simt, 3), time_ms(simt, 3),
             time_ms(wg, 10)]
        if key == "flat":
            pm = plain_ms(lambda: ops.flash_attention(q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True), 10)
        else:
            pm = plain_ms(lambda: ops.flash_attention_heads(qh, kh, vh))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
                is_causal=True, enable_gqa=True), 10)
        n_heads = args[0].shape[0] * args[0].shape[2]
        flops = 4 * dh * n_heads * pairs
        bound = k3_bound(args[0], args[1], flops)
        r = out[key] = {"wgmma": (t[0] + t[3]) / 2, "simt": (t[1] + t[2]) / 2,
                        "plain": pm, "sdpa": lib, "bound": bound}
        log(f"K3 {name} bf16 causal: wgmma body {t[0]:.4f} / {t[3]:.4f} ms "
            f"({flops / r['wgmma'] / 1e9:.1f} TFLOP/s, "
            f"{bound[0] / r['wgmma']:.1%} of the bound), SIMT body "
            f"{t[1]:.3f} / {t[2]:.3f} ms ({flops / r['simt'] / 1e9:.1f}"
            f" TFLOP/s), plain {pm:.3f} ms, scaled_dot_product_attention "
            f"{lib:.4f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({flops / 1e9:.1f} GFLOP at {BF16_FLOPS_PER_S / 1e12:.0f} "
            f"TFLOP/s bf16; {bound[2] / 1e6:.1f} MB = "
            f"{1e3 * bound[2] / HBM_BYTES_PER_S:.4f} ms); fp32 CUDA-core "
            f"floor {1e3 * flops / CUDA_CORE_OPS_PER_S:.3f} ms")
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()

    hq, hkv, dg = GEMMA_HEADS
    qg = _normal(rng, (GEMMA_BATCH, GEMMA_SEQ, hq, dg), torch.bfloat16, dev)
    kg, vg = (_normal(rng, (GEMMA_BATCH, GEMMA_SEQ, hkv, dg), torch.bfloat16,
                      dev) for _ in range(2))
    name = f"{GEMMA_ARCH} MQA {list(qg.shape)} q / {hkv} kv"
    wg = lambda: ops.flash_attention_heads(qg, kg, vg)                  # noqa: E731
    simt = lambda: fa.flash_attention_cuda(qg, kg, vg, body="simt")     # noqa: E731
    t = [time_ms(wg, 10), time_ms(simt, 10), time_ms(simt, 10),
         time_ms(wg, 10)]
    pm = plain_ms(wg)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qg.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
        is_causal=True, enable_gqa=True), 10)
    flops = 4 * dg * GEMMA_BATCH * hq * attention_pairs(GEMMA_SEQ, True, None)
    bound = k3_bound(qg, kg, flops)
    r = out["gemma"] = {"wgmma": (t[0] + t[3]) / 2, "simt": (t[1] + t[2]) / 2,
                        "plain": pm, "sdpa": lib, "bound": bound}
    log(f"K3 {name} bf16 causal: wgmma body {t[0]:.4f} / {t[3]:.4f} ms "
        f"({flops / r['wgmma'] / 1e9:.1f} TFLOP/s, "
        f"{bound[0] / r['wgmma']:.1%} of the bound), SIMT body "
        f"{t[1]:.4f} / {t[2]:.4f} ms ({flops / r['simt'] / 1e9:.1f} "
        f"TFLOP/s; {r['simt'] / r['wgmma']:.2f}x the wgmma body's time), "
        f"plain {pm:.3f} ms, scaled_dot_product_attention {lib:.4f} ms; "
        f"bound {bound[0]:.4f} ms by {bound[1]} ({flops / 1e9:.1f} GFLOP; "
        f"{bound[2] / 1e6:.1f} MB)")
    del qg, kg, vg
    torch.cuda.empty_cache()
    return out


def drive_lm_path(fa, dev) -> dict:
    """Prefill and serving of ``qwen3-0.6b`` at full width and depth, seeded
    random weights on the card; returns the path's metrics."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serving import DecodeEngine, Request

    cfg = get_config(LM_ARCH).model
    out = {}
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(dev).manual_seed(0))
    sync(dev)
    n_total = sum(x.numel() for x in _leaves(params))
    uncounted = (cfg.n_layers * 2 * cfg.head_dim * cfg.qk_norm) + cfg.d_model
    if not n_total - uncounted == transformer.param_count(cfg) == PARAM_COUNT:
        raise AssertionError(f"{n_total} parameters - {uncounted} (qk-norm, "
                             f"final norm) != param_count "
                             f"{transformer.param_count(cfg)}")
    log(f"{LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"param_count {transformer.param_count(cfg):,} (+ {uncounted:,} "
        f"qk-norm and final-norm scales = {n_total:,} tensors' elements), "
        f"init {time.perf_counter() - t:.1f} s")

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ))).to(dev)

    def prefill(toks):
        n, by_body = fa.LAUNCHES, dict(fa.LAUNCHES_BY_BODY)
        t0 = time.perf_counter()
        logits = transformer.prefill(cfg, params, toks)
        sync(dev)
        dt = time.perf_counter() - t0
        if fa.LAUNCHES - n != cfg.n_layers:
            raise AssertionError(f"prefill launched K3 {fa.LAUNCHES - n} "
                                 f"times, expected {cfg.n_layers}")
        ran = {b: c - by_body[b] for b, c in fa.LAUNCHES_BY_BODY.items()}
        if ran != {"wgmma": cfg.n_layers, "simt": 0}:
            raise AssertionError(f"prefill launched K3's bodies {ran}, "
                                 f"expected the wgmma body {cfg.n_layers} "
                                 f"times and the SIMT body never")
        if logits.shape != (toks.shape[0], cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"not finite or of the wrong shape")
        return logits, dt

    n_tok = PREFILL_BATCH * PREFILL_SEQ
    for i in range(2):
        _, dt = prefill(tokens)
        log(f"prefill [{PREFILL_BATCH}, {PREFILL_SEQ}] call {i}: {dt:.3f} s, "
            f"{n_tok / dt:,.0f} tokens/s, logits finite, K3's wgmma body "
            f"launched {cfg.n_layers} times, its SIMT body never")
    out["prefill_s"], out["prefill_tok_s"] = dt, n_tok / dt
    out["prefill_busy"] = profiled(lambda: prefill(tokens))
    del tokens
    torch.cuda.empty_cache()

    prompts = rng.integers(1, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT))
    eng = DecodeEngine(cfg, params, batch_slots=SERVE_SLOTS,
                       max_seq=SERVE_MAX_SEQ, device=dev)
    cache_mb = sum(t.numel() * t.element_size() for t in eng.cache.values()) / 1e6
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.tolist(), max_new=SERVE_NEW))
    t = time.perf_counter()
    done = sorted(eng.run(), key=lambda r: r.rid)
    sync(dev)
    dt = time.perf_counter() - t
    waves = SERVE_PROMPT - 1 + SERVE_NEW
    if len(done) != SERVE_SLOTS or any(len(r.out) != SERVE_NEW for r in done):
        raise AssertionError("the engine did not finish every request")
    out["serve_s"] = dt
    out["decode_tok_s"] = SERVE_SLOTS * SERVE_NEW / dt
    out["wave_ms"] = 1e3 * dt / waves
    log(f"serve: {SERVE_SLOTS} requests x ({SERVE_PROMPT} prompt + "
        f"{SERVE_NEW} new) tokens, cache {tuple(eng.cache['k'].shape)} bf16 "
        f"x2 = {cache_mb:.0f} MB: {dt:.2f} s, {waves} waves "
        f"({out['wave_ms']:.2f} ms each), {out['decode_tok_s']:.1f} new "
        f"tokens/s, {SERVE_SLOTS * waves / dt:.0f} tokens/s through "
        f"decode_step")

    # consistency: the engine's first token against prefill's argmax
    ptoks = torch.from_numpy(prompts).to(dev)
    logits_p, _ = prefill(ptoks)                    # s = 512: K3 runs
    cache = transformer.init_cache(cfg, SERVE_SLOTS, SERVE_PROMPT, device=dev)
    logits_d = None

    def replay(positions):
        nonlocal logits_d
        for pos in positions:
            logits_d, _ = transformer.decode_step(cfg, params, cache,
                                                  ptoks[:, pos], pos)

    replay(range(SERVE_PROMPT - 8))
    out["decode_busy"] = profiled(                  # the last 8 waves
        lambda: replay(range(SERVE_PROMPT - 8, SERVE_PROMPT)))
    dmax = float((logits_d - logits_p).abs().max())
    lmax = float(logits_p.abs().max())
    tol = 2 * dmax
    top2 = logits_p.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    argmax_p = logits_p.argmax(-1).tolist()
    first = [r.out[0] for r in done]
    agree = sum(a == b for a, b in zip(first, argmax_p))
    log(f"consistency: max |prefill - decode_step replay| logit = {dmax:.4g} "
        f"(largest |logit| {lmax:.4g}; limit {LOGIT_RTOL:g} x that = "
        f"{LOGIT_RTOL * lmax:.4g}); argmax tolerance 2x the gap = {tol:.4g}; "
        f"prefill top-2 margins {[round(m, 4) for m in margins]}; first "
        f"tokens {first}, prefill argmax {argmax_p}: {agree}/{SERVE_SLOTS} "
        f"agree; replay argmax {logits_d.argmax(-1).tolist()}")
    if not dmax <= LOGIT_RTOL * lmax:
        raise AssertionError(f"decode_step replay differs from prefill by "
                             f"{dmax} > {LOGIT_RTOL} x {lmax}")
    for f, a, m in zip(first, argmax_p, margins):
        if f != a and m >= tol:
            raise AssertionError(f"first token {f} != prefill argmax {a} at "
                                 f"top-2 margin {m} >= {tol}")
    out.update(dlogit=dmax, agree=agree, margins=margins)
    del params, eng, cache
    torch.cuda.empty_cache()
    return out


def drive_gemma_prefill(ops, fa, dev, smoke: bool) -> dict:
    """Prefill of ``gemma-2b`` with seeded random weights, two calls, the
    logits held against the same call through the plain route.  At full
    width and depth (8 query heads over one KV head of 256) on 1 x 4,096
    tokens it is the path of K3's wgmma body at head dim 256, once a layer,
    the SIMT body never.  With ``smoke``, gemma-2b's smoke config (4 query
    heads over one KV head of 32, bf16) on 4 x 1,024 tokens is the path of
    the SIMT body, once a layer, the wgmma body never."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    arch = get_config(GEMMA_ARCH)
    cfg = arch.smoke if smoke else arch.model
    batch, seq = (SIMT_BATCH, SIMT_SEQ) if smoke else (GEMMA_BATCH, GEMMA_SEQ)
    body = "simt" if smoke else "wgmma"
    if not smoke and (cfg.n_heads, cfg.n_kv, cfg.head_dim) != GEMMA_HEADS:
        raise AssertionError(f"{GEMMA_ARCH}: heads {cfg.n_heads}/{cfg.n_kv} "
                             f"of {cfg.head_dim}, expected {GEMMA_HEADS}")
    if fa.body_for(torch.bfloat16, cfg.head_dim) != body:
        raise AssertionError(f"{cfg.name}: bf16 at head dim {cfg.head_dim} "
                             f"does not pick the {body} body")
    expect = {b: cfg.n_layers if b == body else 0 for b in fa.LAUNCHES_BY_BODY}
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(dev).manual_seed(0))
    sync(dev)
    log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} q / {cfg.n_kv} kv heads of {cfg.head_dim}, "
        f"param_count {transformer.param_count(cfg):,}, init "
        f"{time.perf_counter() - t:.1f} s")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, seq))).to(dev)
    out = {}
    for i in range(2):
        by_body = dict(fa.LAUNCHES_BY_BODY)
        t0 = time.perf_counter()
        logits = transformer.prefill(cfg, params, tokens)
        sync(dev)
        dt = time.perf_counter() - t0
        ran = {b: c - by_body[b] for b, c in fa.LAUNCHES_BY_BODY.items()}
        if ran != expect:
            raise AssertionError(f"{cfg.name} prefill launched K3's bodies "
                                 f"{ran}, expected {expect}")
        if logits.shape != (batch, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name} logits not finite or of the "
                                 f"wrong shape")
        log(f"{cfg.name} prefill [{batch}, {seq}] call {i}: {dt:.3f} s, "
            f"{batch * seq / dt:,.0f} tokens/s, K3's bodies launched {ran}")
    out["prefill_s"], out["prefill_tok_s"] = dt, batch * seq / dt
    ops.use_kernels(False)
    try:
        plain = transformer.prefill(cfg, params, tokens)
    finally:
        ops.use_kernels(True)
    dmax = float((logits - plain).abs().max())
    lmax = float(plain.abs().max())
    log(f"{cfg.name} prefill vs the plain route: max |logit difference| "
        f"{dmax:.4g} (largest |logit| {lmax:.4g}; limit {LOGIT_RTOL:g} x "
        f"that = {LOGIT_RTOL * lmax:.4g}); argmax "
        f"{logits.argmax(-1).tolist()} vs {plain.argmax(-1).tolist()}")
    if not dmax <= LOGIT_RTOL * lmax:
        raise AssertionError(f"{cfg.name} prefill differs from the plain "
                             f"route by {dmax} > {LOGIT_RTOL} x {lmax}")
    out["dlogit"] = dmax
    del params, tokens
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _ids(rng, lo, hi, n, dev):
    return torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)


def check_recsys_kernels(ops, ref, dev) -> dict:
    """K4 and K5 against their plain versions on the reference's sweeps;
    returns the max abs error of each group."""
    errs = {}
    for dtype in (torch.float32, torch.float16):
        e_max = 0.0
        for e, d, n in K4_SWEEP:
            rng = np.random.default_rng(e + d + n)
            m = _normal(rng, (e, d), dtype, dev)
            seg = _ids(rng, -2, n + 2, e, dev)       # a few ids out of range
            e_max = max(e_max, check_close(
                ops.segment_matmul(m, seg, n), ref.segment_matmul_ref(m, seg, n),
                K4_TOL[dtype], f"K4 sweep {e}x{d}->{n} {dtype}", K4_TOL[dtype]))
            idx = _ids(rng, -e, e, e, dev)            # negative rows wrap
            got = ops.segment_matmul_gathered(m, idx, seg, n)
            e_max = max(e_max, check_close(
                got, ref.segment_matmul_gathered_ref(m, idx, seg, n),
                K4_TOL[dtype], f"K4 gathered sweep {e}x{d}->{n} {dtype}",
                K4_TOL[dtype]))
            if not torch.equal(got, ops.segment_matmul(m[idx.long()], seg, n)):
                raise AssertionError("K4 gathered entry != rows entry on the "
                                     "gathered rows")
            # the same ids sorted: the declared-sorted entry gives the
            # sorting entry's bits, the mean entry the plain mean's values
            seg = torch.sort(seg)[0]
            got = ops.segment_matmul_gathered(m, idx, seg, n, ids_sorted=True)
            check_same(got, ops.segment_matmul_gathered(m, idx, seg, n),
                       f"K4 sorted entry vs sorting entry {e}x{d}->{n} {dtype}")
            e_max = max(e_max, check_close(
                got, ref.segment_matmul_gathered_ref(m, idx, seg, n),
                K4_TOL[dtype], f"K4 sorted sweep {e}x{d}->{n} {dtype}",
                K4_TOL[dtype]))
            e_max = max(e_max, check_close(
                ops.segment_matmul_gathered(m, idx, seg, n, ids_sorted=True,
                                            mean=True),
                ref.segment_mean_gathered_ref(m, idx, seg, n), K4_TOL[dtype],
                f"K4 mean sweep {e}x{d}->{n} {dtype}", K4_TOL[dtype]))
        errs[f"segment_matmul sweep {str(dtype)[6:]}"] = e_max
    errs["long runs, K4 vs a float64 sum"] = check_k4_long_runs(ops, dev)
    check_k4_nan_cases(ops, ref, dev)
    e_max = 0.0
    for b, h, m, o, d in K5_SWEEP:
        rng = np.random.default_rng(b + h)
        xk, x0 = (_normal(rng, (b, f, d), torch.float32, dev) for f in (h, m))
        w = _normal(rng, (o, h, m), torch.float32, dev) * 0.1
        e_max = max(e_max, check_close(
            ops.cin_layer(xk, x0, w), ref.cin_layer_ref(xk, x0, w), K5_TOL,
            f"K5 sweep {(b, h, m, o, d)}", K5_TOL))
    errs["cin sweep"] = e_max
    for name, e in errs.items():
        log(f"recsys kernels vs plain, {name}: max abs err {e:.3g}")
    return errs


def check_same(got, exp, what: str) -> None:
    """Raise unless two outputs hold the same bits where they are numbers
    and NaN at the same places (NaN payloads are not compared)."""
    if not (torch.equal(got.isnan(), exp.isnan())
            and torch.equal(got.nan_to_num(0.0), exp.nan_to_num(0.0))):
        raise AssertionError(f"{what}: not bitwise equal")


def check_k4_long_runs(ops, dev) -> float:
    """K4's declared-sorted entry on runs of up to 30,000 rows (the kernel
    takes them 8 at a time, the sum carried in registers): the sorting
    entry's bits, and within 1e-2 of a float64 sum (the plain version's
    own fp32 sum drifts by ~1e-3 over such runs).  Returns the max abs
    error against the float64 sum."""
    rng = np.random.default_rng(9)
    seg = np.sort(np.concatenate([np.full(30_000, 2), rng.integers(0, 5, 10_000)]))
    seg = torch.from_numpy(seg.astype(np.int32)).to(dev)
    table = _normal(rng, (100_000, 10), torch.float32, dev)
    idx = _ids(rng, 0, 100_000, seg.shape[0], dev)
    got = ops.segment_matmul_gathered(table, idx, seg, 5, ids_sorted=True)
    check_same(got, ops.segment_matmul_gathered(table, idx, seg, 5),
               "K4 long runs, sorted entry vs sorting entry")
    exp = torch.zeros((5, 10), dtype=torch.float64, device=dev).index_add_(
        0, seg.long(), table.double()[idx.long()])
    err = float((got.double() - exp).abs().max())
    if not err <= 1e-2:
        raise AssertionError(f"K4 long runs: max |kernel - float64 sum| = "
                             f"{err} > 1e-2")
    return err


def check_k4_nan_cases(ops, ref, dev) -> None:
    """The declared-sorted entry's NaN: indices outside [-R, R) make their
    bags NaN as the sorting entry and the plain version do (jnp.take); and
    unsorted ids declared sorted make every output of the call NaN (the
    sorting entry's are finite)."""
    table = torch.arange(18, dtype=torch.float32, device=dev).reshape(6, 3)
    idx = torch.tensor([0, -1, 5, 6, -7, 2], dtype=torch.int32, device=dev)
    seg = torch.tensor([0, 0, 1, 2, 3, 4], dtype=torch.int32, device=dev)
    got = ops.segment_matmul_gathered(table, idx, seg, 5, ids_sorted=True)
    check_same(got, ops.segment_matmul_gathered(table, idx, seg, 5),
               "K4 out-of-range indices, sorted entry vs sorting entry")
    check_same(got, ref.segment_matmul_gathered_ref(table, idx, seg, 5),
               "K4 out-of-range indices, sorted entry vs plain")
    table = torch.ones((8, 10), device=dev)
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    seg = torch.tensor([0, 1, 1, 3, 2, 4, 5, 5], dtype=torch.int32, device=dev)
    bad = ops.segment_matmul_gathered(table, idx, seg, 6, ids_sorted=True,
                                      mean=True)
    sync(dev)
    if not bool(bad.isnan().all()):
        raise AssertionError("K4: a false sortedness declaration did not "
                             "poison the whole output")
    if bool(ops.segment_matmul_gathered(table, idx, seg, 6).isnan().any()):
        raise AssertionError("K4 sorting entry gave NaN on unsorted ids")
    log("K4 false declaration: unsorted ids declared sorted give an all-NaN "
        f"output ({bad.numel()} values); the sorting entry's are finite")


def recsys_setup(dev) -> dict:
    """Parameters of xdeepfm at full width from a seed, on the card, and
    one device-resident batch of each traffic shape."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import ClickStream
    from repro_torch.models import recsys

    arch = get_config(RECSYS_ARCH)
    cfg = arch.model
    shapes = {c.name: c.params for c in arch.shapes}
    t = time.perf_counter()
    params = recsys.init_params(cfg, torch.Generator(dev).manual_seed(0))
    sync(dev)
    n_params = sum(x.numel() for x in _leaves(params))
    if n_params != RECSYS_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {RECSYS_PARAMS}")
    table_mb = params["table"].numel() * 4 / 1e6
    log(f"{RECSYS_ARCH}: {cfg.n_sparse} fields x {cfg.vocab_per_field:,} rows, "
        f"embed {cfg.embed_dim}, CIN {cfg.cin_layers}, MLP {cfg.mlp_dims}; "
        f"{n_params:,} parameters (table {table_mb:.0f} MB) in "
        f"{time.perf_counter() - t:.1f} s")
    batches = {}
    for name in ("serve_p99", "serve_bulk"):
        nb = ClickStream(cfg, shapes[name]["batch"], seed=0).next()
        batches[name] = recsys.batch_to_torch(nb, dev)
    nb = ClickStream(cfg, 1, seed=1).next()
    retr = recsys.batch_to_torch(nb, dev)
    retr["candidate_ids"] = torch.arange(
        shapes["retrieval_cand"]["n_candidates"], dtype=torch.int32, device=dev)
    batches["retrieval_cand"] = retr
    return {"recsys": recsys, "cfg": cfg, "params": params,
            "batches": batches}


def check_recsys_path_shapes(ops, ref, rs) -> dict:
    """K4 and K5 against their plain versions at the path's shapes: the
    p99 and the whole bulk bag sum; every p99 CIN layer and the first and
    last ``K5_CHUNK`` rows of each bulk layer (the plain einsum would
    materialise [B, H, M, D], 84 GB at bulk)."""
    from repro_torch.kernels import cin

    recsys, cfg, params = rs["recsys"], rs["cfg"], rs["params"]
    errs = {}
    table = params["table"]
    for name in ("serve_p99", "serve_bulk"):
        batch = rs["batches"][name]
        rows, bags = recsys.multihot_bags(cfg, batch["multihot_ids"])
        nb = bags.shape[0] // cfg.bag_size
        # the path's entry (declared sorted, the mean fused) and the sum
        # entry, each bitwise against the sorting route and within the
        # tolerance of the plain version
        k4 = f"{name} [{rows.shape[0]}, {cfg.embed_dim}]"
        got = ops.segment_matmul_gathered(table, rows, bags, nb,
                                          ids_sorted=True)
        sorting = ops.segment_matmul_gathered(table, rows, bags, nb)
        check_same(got, sorting, f"K4 {name}: sorted entry vs sorting entry")
        errs[f"segment_matmul {k4} sum"] = check_close(
            got, ref.segment_matmul_gathered_ref(table, rows, bags, nb),
            K4_TOL[torch.float32], f"K4 {name}", K4_TOL[torch.float32])
        mean = ops.segment_matmul_gathered(table, rows, bags, nb,
                                           ids_sorted=True, mean=True)
        ones = torch.ones((rows.shape[0], 1), device=rows.device)
        check_same(mean, sorting / torch.clamp(
            ops.segment_matmul(ones, bags, nb), min=1.0),
            f"K4 {name}: mean entry vs the two-call mean")
        errs[f"segment_matmul {k4} mean"] = check_close(
            mean, ref.segment_mean_gathered_ref(table, rows, bags, nb),
            K4_TOL[torch.float32], f"K4 {name} mean", K4_TOL[torch.float32])
        log(f"K4 {name}: sorted entry == sorting entry and mean entry == sum "
            f"/ clamp(count, 1), bitwise, over {nb:,} bags")
        del got, sorting, mean, ones
        x0 = recsys._field_embeddings(cfg, params, batch).contiguous()
        xk = x0
        for i, w in enumerate(params["cin"]):
            got = ops.cin_layer(xk, x0, w)
            b = x0.shape[0]
            shape = (b, xk.shape[1], x0.shape[1], x0.shape[2], w.shape[0])
            grid = cin.plan(*shape, torch.cuda.get_device_properties(
                0).multi_processor_count)
            log(f"K5 plan, {name} layer {i + 1} (b, h, m, d, o) = {shape}: "
                f"grid {grid}, S = {grid[2]}, "
                f"{grid[0] * grid[1] * grid[2]:,} blocks")
            parts = ((slice(0, b),) if b <= 2 * K5_CHUNK else
                     (slice(0, K5_CHUNK), slice(b - K5_CHUNK, b)))
            e = 0.0
            for sl in parts:
                e = max(e, check_close(got[sl], ref.cin_layer_ref(
                    xk[sl], x0[sl], w), K5_TOL, f"K5 {name} layer {i + 1}",
                    K5_TOL))
            rows_note = "all rows" if len(parts) == 1 else \
                f"rows [0, {K5_CHUNK}) and [{b - K5_CHUNK}, {b})"
            errs[f"cin {name} layer {i + 1} {list(xk.shape)}, {rows_note}"] = e
            xk = got
        del x0, xk, got
    torch.cuda.empty_cache()
    for name, e in errs.items():
        log(f"recsys kernels vs plain at the path's shapes, {name}: max abs "
            f"err {e:.3g}")
    return errs


def drive_recsys_path(rs, dev) -> dict:
    """The xDeepFM serving path at full width through the reference's
    three traffic shapes; returns the path's metrics and the last p99
    scores."""
    recsys, cfg, params = rs["recsys"], rs["cfg"], rs["params"]
    out = {"calls": 0}

    def call(fn, *args):
        out["calls"] += 1
        t0 = time.perf_counter()
        res = fn(cfg, params, *args)
        sync(dev)
        return res, time.perf_counter() - t0

    p99 = rs["batches"]["serve_p99"]
    b = p99["sparse_ids"].shape[0]
    call(recsys.serve, p99)                                # warm-up
    times = []
    for _ in range(P99_CALLS):
        scores, dt = call(recsys.serve, p99)
        times.append(dt)
    ms = 1e3 * np.asarray(times)
    out["p99_p50_ms"] = float(np.percentile(ms, 50))
    out["p99_p99_ms"] = float(np.percentile(ms, 99))
    out["p99_rows_s"] = b / (np.median(ms) / 1e3)
    if scores.shape != (b,) or not bool(((scores > 0) & (scores < 1)).all()):
        raise AssertionError("serve_p99 scores not in (0, 1) or of the wrong "
                             "shape")
    log(f"serve_p99: batch {b}, {P99_CALLS} synchronised calls: p50 "
        f"{out['p99_p50_ms']:.3f} ms, p99 {out['p99_p99_ms']:.3f} ms, "
        f"{out['p99_rows_s']:,.0f} rows/s; mean ctr "
        f"{float(scores.mean()):.4f}")
    # K4 on the path: declared-sorted ids, so no sort kernel runs
    out["p99_busy"] = profiled(lambda: call(recsys.serve, p99), forbid="sort",
                               require="segment_sum")

    bulk = rs["batches"]["serve_bulk"]
    nb = bulk["sparse_ids"].shape[0]
    secs = []
    for i in range(BULK_CALLS):
        bs, dt = call(recsys.serve, bulk)
        secs.append(dt)
        log(f"serve_bulk call {i}: batch {nb:,}, {dt:.3f} s, "
            f"{nb / dt:,.0f} rows/s")
    if bs.shape != (nb,) or not bool(torch.isfinite(bs).all()):
        raise AssertionError("serve_bulk scores not finite or of the wrong shape")
    out["bulk_s"] = float(np.median(secs))
    out["bulk_rows_s"] = nb / out["bulk_s"]
    del bs
    out["bulk_busy"] = profiled(lambda: call(recsys.serve, bulk),
                                forbid="sort", require="segment_sum")

    retr = rs["batches"]["retrieval_cand"]
    ms = []
    for _ in range(RETRIEVAL_CALLS + 1):
        (top, idx), dt = call(recsys.retrieval_score, retr)
        ms.append(1e3 * dt)
    out["retrieval_ms"] = float(np.median(ms[1:]))
    if top.shape != (TOP_K,) or not bool((top[:-1] >= top[1:]).all()):
        raise AssertionError("retrieval top-k not sorted or of the wrong shape")
    log(f"retrieval_cand: 1 query x {retr['candidate_ids'].shape[0]:,} "
        f"candidates, top {TOP_K}: {out['retrieval_ms']:.3f} ms (median of "
        f"{RETRIEVAL_CALLS})")
    rs["p99_scores"], rs["top"] = scores, (top, idx)
    return out


def check_recsys_outputs(ops, rs, dev) -> dict:
    """The path's outputs against the plain route on the same card and
    against the CPU: p99 scores and the retrieval top-k."""
    recsys, cfg, params = rs["recsys"], rs["cfg"], rs["params"]
    p99, retr = rs["batches"]["serve_p99"], rs["batches"]["retrieval_cand"]
    ops.use_kernels(False)
    try:
        plain = recsys.serve(cfg, params, p99)
        ptop, pidx = recsys.retrieval_score(cfg, params, retr)
    finally:
        ops.use_kernels(True)
    errs = {"p99 scores vs use_kernels(False)": check_close(
        rs["p99_scores"], plain, SCORE_TOL, "p99 scores kernels vs plain")}
    top, idx = rs["top"]
    errs["retrieval top-k scores vs use_kernels(False)"] = check_close(
        top, ptop, SCORE_TOL, "retrieval scores kernels vs plain")
    gaps = (ptop[:-1] - ptop[1:]).abs()
    clear = torch.ones_like(ptop, dtype=torch.bool)
    clear[:-1] &= gaps > SCORE_TOL
    clear[1:] &= gaps > SCORE_TOL
    if not torch.equal(idx[clear], pidx[clear]):
        raise AssertionError("retrieval candidates differ where the score "
                             "gaps exceed the tolerance")
    # 64 rows on the CPU (plain versions throughout) against the card
    cpu_params = recsys.params_from_numpy(recsys.params_to_numpy(params),
                                          device="cpu")
    sub = {k: v[:64].cpu() for k, v in p99.items()}
    errs["64 p99 rows vs the CPU"] = check_close(
        rs["p99_scores"][:64].cpu(), recsys.serve(cfg, cpu_params, sub),
        SCORE_TOL, "p99 scores card vs CPU")
    for name, e in errs.items():
        log(f"recsys outputs, {name}: max abs err {e:.3g} (tolerance "
            f"{SCORE_TOL:g})")
    log(f"retrieval candidates equal to the plain route's at the "
        f"{int(clear.sum())}/{TOP_K} places whose score gaps exceed "
        f"{SCORE_TOL:g}")
    return errs


def time_recsys_kernels(ops, ref, rs, dev) -> dict:
    """K4 on the p99 and bulk bag sums and K5 on a p99 layer-2 call:
    kernel, plain version and one PyTorch call of the same function (the
    yardstick; the port never calls it), CUDA events, median; bounds from
    this run's inputs.  K4's entries and yardsticks are timed in turns, in
    one order and then the reverse, and each time is the mean of the two
    medians."""
    import torch.nn.functional as F

    recsys, cfg, params = rs["recsys"], rs["cfg"], rs["params"]
    table = params["table"]
    res = {}
    for name in ("serve_p99", "serve_bulk"):
        rows, bags = recsys.multihot_bags(
            cfg, rs["batches"][name]["multihot_ids"])
        nb, e, d = bags.shape[0] // cfg.bag_size, rows.shape[0], cfg.embed_dim
        rows64 = rows.long()
        offsets = torch.arange(0, e, cfg.bag_size, device=dev)
        # the reference's batch-major bag order, for the layout's share
        rows_bm = rows.reshape(cfg.n_multihot, -1, cfg.bag_size).transpose(
            0, 1).reshape(-1)
        rows_bm64 = rows_bm.long()
        g = ops.segment_matmul_gathered
        calls = {
            "sum": lambda: g(table, rows, bags, nb, ids_sorted=True),
            "mean": lambda: g(table, rows, bags, nb, ids_sorted=True,
                              mean=True),
            "sorting": lambda: g(table, rows, bags, nb),
            "plain": lambda: ref.segment_matmul_gathered_ref(table, rows,
                                                             bags, nb),
            "plain_mean": lambda: ref.segment_mean_gathered_ref(table, rows,
                                                                bags, nb),
            "embedding_bag_sum": lambda: F.embedding_bag(
                rows64, table, offsets, mode="sum"),
            "embedding_bag_mean": lambda: F.embedding_bag(
                rows64, table, offsets, mode="mean"),
            "sum_batch_major": lambda: g(table, rows_bm, bags, nb,
                                         ids_sorted=True),
            "embedding_bag_sum_batch_major": lambda: F.embedding_bag(
                rows_bm64, table, offsets, mode="sum"),
            "id_sort": lambda: torch.sort(bags, stable=True),
        }
        turns = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):
            for k in order:
                turns[k].append(time_ms(calls[k], 5 if "plain" in k else 10))
        ms = {k: float(np.mean(v)) for k, v in turns.items()}
        # bound: ids and indices read once, each distinct row once, the
        # output written once; diagnostic: the 32-byte sectors the gathered
        # rows touch (two per 40-byte row), each gather counted
        n_rows = int(torch.unique(rows).numel())
        n_bytes = 4 * e + 4 * e + 4 * d * n_rows + 4 * d * nb
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, e * d / CUDA_CORE_OPS_PER_S
        bound = 1e3 * max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        first = rows64 * (4 * d)
        sectors = int(((first + 4 * d - 1) // 32 - first // 32 + 1).sum())
        sector_ms = 1e3 * (8 * e + 32 * sectors + 4 * d * nb) / HBM_BYTES_PER_S
        log(f"K4 {name} bag sum [{e:,}, {d}] -> {nb:,} bags (in turns, ms, "
            f"each the mean of two medians): "
            + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
        log(f"K4 {name}: bound {bound:.4f} ms by {by} ({n_bytes / 1e6:.1f} MB: "
            f"{n_rows:,} distinct rows); the sum entry at "
            f"{100 * bound / ms['sum']:.1f}% of it, the mean entry at "
            f"{100 * bound / ms['mean']:.1f}%; sum vs embedding_bag "
            f"{ms['embedding_bag_sum'] / ms['sum']:.2f}x, mean vs "
            f"embedding_bag {ms['embedding_bag_mean'] / ms['mean']:.2f}x; "
            f"diagnostic, not the bound: {sectors / e:.2f} sectors a gathered "
            f"row, {sector_ms:.4f} ms at the full memory rate "
            f"({(8 * e + 32 * sectors + 4 * d * nb) / ms['sum'] / 1e6:.1f} "
            f"GB/s of such bytes in the sum entry)")
        res[f"segment_matmul {name}"] = {
            "ms": ms, "turns": turns, "bound_ms": bound, "bound_by": by,
            "sector_ms": sector_ms}
        if name == "serve_p99":      # a call of microseconds: the host's share
            host = {k: host_us(calls[k]) for k in
                    ("sum", "mean", "embedding_bag_sum", "embedding_bag_mean")}
            log(f"K4 serve_p99, host microseconds a call (2,000 calls, no "
                f"sync between): " + ", ".join(f"{k} {v:.2f}"
                                              for k, v in host.items()))
            res[f"segment_matmul {name}"]["host_us"] = host
        del rows64, rows_bm, rows_bm64, first

    x0 = recsys._field_embeddings(cfg, params, rs["batches"]["serve_p99"])
    x0 = x0.contiguous()
    xk = ops.cin_layer(x0, x0, params["cin"][0])
    w = params["cin"][1]
    b, h, d = xk.shape
    m, o = x0.shape[1], w.shape[0]
    ms = time_ms(lambda: ops.cin_layer(xk, x0, w), 20)
    plain_ms = time_ms(lambda: ref.cin_layer_ref(xk, x0, w), 10)
    lib_ms = time_ms(lambda: torch.einsum("bhd,bmd,ohm->bod", xk, x0, w), 10)
    flops = 2 * b * d * o * h * m
    n_bytes = 4 * (xk.numel() + x0.numel() + w.numel() + b * o * d)
    t_ops, t_bytes = flops / CUDA_CORE_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    bound = 1e3 * max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    layer1 = time_ms(lambda: ops.cin_layer(x0, x0, params["cin"][0]), 20)
    # cuBLAS's SGEMM on the same product, the outer product materialised
    # [B D, H M] before the timing (a second yardstick; fp32, no TF32)
    prod = (xk[:, :, None, :] * x0[:, None, :, :]).permute(0, 3, 1, 2)
    prod = prod.reshape(b * d, h * m)
    w_flat = w.reshape(o, h * m)
    sgemm_ms = time_ms(lambda: torch.matmul(prod, w_flat.t()), 20)
    del prod
    log(f"K5 p99 layer 2 xk {list(xk.shape)} x0 {list(x0.shape)} w "
        f"{list(w.shape)}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
        f"fp32, {100 * bound / ms:.1f}% of the bound), plain {plain_ms:.4f} "
        f"ms, torch.einsum {lib_ms:.4f} ms, cuBLAS SGEMM of the materialised "
        f"[{b * d}, {h * m}] x [{h * m}, {o}] {sgemm_ms:.4f} ms; bound "
        f"{bound:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP at "
        f"{CUDA_CORE_OPS_PER_S / 1e12:.0f} TFLOP/s fp32 CUDA cores; TF32 "
        f"tensor-core figure {1e3 * flops / TF32_FLOPS_PER_S:.4f} ms); layer 1 "
        f"{list(x0.shape)} x {list(params['cin'][0].shape)}: {layer1:.4f} ms")
    res["cin"] = (ms, plain_ms, lib_ms, bound, by)
    res["cin sgemm_ms"] = sgemm_ms

    # one whole bulk layer-2 call
    x0 = recsys._field_embeddings(cfg, params, rs["batches"]["serve_bulk"])
    x0 = x0.contiguous()
    xk = ops.cin_layer(x0, x0, params["cin"][0])
    b = xk.shape[0]
    bulk_ms = time_ms(lambda: ops.cin_layer(xk, x0, w), 3)
    flops = 2 * b * d * o * h * m
    n_bytes = 4 * (xk.numel() + x0.numel() + w.numel() + b * o * d)
    bulk_bound = 1e3 * max(flops / CUDA_CORE_OPS_PER_S,
                           n_bytes / HBM_BYTES_PER_S)
    log(f"K5 bulk layer 2 xk {list(xk.shape)} ({4 * xk.numel() / 1e9:.2f} "
        f"GB) x0 {list(x0.shape)}: kernel {bulk_ms:.3f} ms, "
        f"{flops / bulk_ms / 1e9:.1f} TFLOP/s fp32, "
        f"{100 * bulk_bound / bulk_ms:.1f}% of the {bulk_bound:.3f} ms bound "
        f"({flops / 1e12:.2f} TFLOP)")
    res["cin bulk layer 2"] = {"ms": bulk_ms, "bound_ms": bulk_bound,
                               "tflops": flops / bulk_ms / 1e9}
    del x0, xk
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def k4_inputs(ops):
    """Record what the path's segment sums hand K4's rows entry: each
    ``(messages, seg_ids, N)`` that ``SegmentSum.forward`` passes to
    ``ops.segment_matmul``, in call order."""
    seen, inner = [], ops.segment_matmul

    def record(messages, seg_ids, num_segments):
        seen.append((messages.detach(), seg_ids, num_segments))
        return inner(messages, seg_ids, num_segments)

    ops.segment_matmul = record
    try:
        yield seen
    finally:
        ops.segment_matmul = inner


def step_vs_plain(ops, ref, loss_fn, params, batch, what: str):
    """One step's loss and gradients through K4 against the same step under
    ``use_kernels(False)``: the loss within ``TRAIN_LOSS_RTOL`` of itself,
    each gradient leaf within ``TRAIN_GRAD_RTOL`` of its largest magnitude.
    Then K4's rows entry against its plain version on every input the
    step handed it.  Returns the errors and those inputs."""
    from repro_torch.training import optimizer as opt

    with k4_inputs(ops) as seen:
        loss_k, grads_k = opt.value_and_grad(loss_fn, params, batch)
    if not seen:
        raise AssertionError(f"{what}: the step handed K4 nothing")
    ops.use_kernels(False)
    try:
        loss_p, grads_p = opt.value_and_grad(loss_fn, params, batch)
    finally:
        ops.use_kernels(True)
    loss_err = abs(float(loss_k) - float(loss_p))
    loss_error(loss_k, loss_p, what, TRAIN_LOSS_RTOL)
    grad_errs = leaf_errors(grads_k, grads_p, what, TRAIN_GRAD_RTOL, "max")
    k4_errs = {}
    with torch.no_grad():
        for msgs, ids, n in seen:
            shape = f"[{msgs.shape[0]}, {msgs.shape[1]}] -> {n}"
            tol = K4_TOL[msgs.dtype]
            err = check_close(ops.segment_matmul(msgs, ids, n),
                              ref.segment_matmul_ref(msgs, ids, n), tol,
                              f"{what}: K4 rows entry {shape}", rtol=tol)
            k4_errs[shape] = max(err, k4_errs.get(shape, 0.0))
    return {"loss_abs_err": loss_err, "grad_rel_err": grad_errs,
            "k4_max_abs_err": k4_errs}, seen


def check_arch_steps(ops, ref, dev) -> dict:
    """``step_vs_plain`` for each GNN arch at full config on the launcher's
    first batch (``train.setup``), and gin-tu once more on its graph
    readout over the molecule cell (128 graphs of 30 nodes and 64 edges)."""
    from repro_torch.configs import get_config
    from repro_torch.data import sampler
    from repro_torch.launch import train
    from repro_torch.models import gnn

    out = {}
    for arch_id in GNN_ARCHS:
        s = train.setup(arch_id, steps=1, ckpt=os.devnull, full=True,
                        device=str(dev))
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in s.stream.next().items()}
        out[arch_id], _ = step_vs_plain(ops, ref, s.loss, s.init(), batch,
                                        f"{arch_id} --full")
    cfg = get_config("gin-tu").model
    mb = sampler.make_batched_graphs(MOLECULE_GRAPHS, 30, 64, 16,
                                     n_classes=cfg.n_classes, seed=0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in mb.items()}
    params = gnn.init_params(cfg, torch.Generator(dev).manual_seed(0), 16)
    out["gin-tu graph readout"], _ = step_vs_plain(
        ops, ref,
        lambda p, b: gnn.loss_fn(cfg, p, b, n_graphs=MOLECULE_GRAPHS),
        params, batch, "gin-tu graph readout")
    return out


def check_restart(arch_id: str, work: str, dev, full: bool = True) -> dict:
    """``launch.train.main [--full] --steps 6`` straight, against 3 steps of
    the launcher's own setup (``train.setup``) cut by the preemption flag,
    then ``main`` resumed from that checkpoint to 6: every parameter,
    optimizer state and loss bitwise equal (K4 and K5 sum in a fixed order,
    and the indexing backward sorts its indices)."""
    from repro_torch.launch import train
    from repro_torch.training import checkpoint, loop
    from repro_torch.training.optimizer import tree_leaves

    def launcher(tag):
        return train.main(["--arch", arch_id, "--steps", str(RESTART_STEPS),
                           "--device", str(dev), "--ckpt",
                           os.path.join(work, f"{arch_id}-{tag}.npz")]
                          + (["--full"] if full else []))

    def tensors(out):
        return tree_leaves([out["params"], out["opt_state"]])

    straight = launcher("straight")
    losses = [h["loss"] for h in straight["history"]]
    if len(losses) != RESTART_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"launcher {arch_id}: losses {losses}")
    s = train.setup(arch_id, steps=RESTART_STEPS, full=full, device=str(dev),
                    ckpt=os.path.join(work, f"{arch_id}-resumed.npz"))
    pre = checkpoint.PreemptionHandler()
    cut = loop.run(s.loop, s.opt, s.loss, s.init, s.stream, device=dev,
                   preemption=pre, hooks=[
                       lambda step, stats: setattr(pre, "preempted",
                                                   step + 1 == RESTART_AT)])
    if len(cut["history"]) != RESTART_AT:
        raise AssertionError(f"{arch_id}: the preempted run took "
                             f"{len(cut['history'])} steps, not {RESTART_AT}")
    resumed = launcher("resumed")
    if [h["step"] for h in resumed["history"]] != list(range(RESTART_AT,
                                                             RESTART_STEPS)):
        raise AssertionError(f"{arch_id}: the resume ran "
                             f"{[h['step'] for h in resumed['history']]}")
    resumed_losses = [h["loss"] for h in resumed["history"]]
    if resumed_losses != losses[RESTART_AT:] or not all(
            torch.equal(x, y) for x, y in zip(tensors(straight),
                                              tensors(resumed))):
        raise AssertionError(f"{arch_id}: the resumed run differs from the "
                             f"straight one (losses {resumed_losses} vs "
                             f"{losses[RESTART_AT:]})")
    return {"bitwise": True, "losses": losses}


def _k4_training_shapes(ops, ref, seen, errs: dict, n_real: int, dev) -> dict:
    """K4's rows entry on the inputs one training step handed it (the
    degree count and the two layers' messages, on the last round's
    batch), timed in turns with its plain version and ``index_add_``
    (CUDA events, median), beside its byte bound from these inputs; and
    on the community's own rows alone (the first ``n_real``, the padding
    being a suffix), beside theirs."""
    def bound(e, d, n):
        t_bytes = (4 * e * d + 4 * e + 4 * n * d) / HBM_BYTES_PER_S
        t_ops = e * d / CUDA_CORE_OPS_PER_S
        return 1e3 * max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"

    out = {}
    for msgs, ids, n in seen:
        e, d = msgs.shape
        shape = f"[{e}, {d}]"
        hub = int(torch.bincount(ids.long(), minlength=n).max())
        ms = in_turns({
            "kernel": lambda: ops.segment_matmul(msgs, ids, n),
            "plain": lambda: ref.segment_matmul_ref(msgs, ids, n),
            "index_add_": lambda: torch.zeros(
                (n, d), device=dev).index_add_(0, ids, msgs)}, reps=3)
        real_m, real_ids = msgs[:n_real].contiguous(), ids[:n_real]
        real_ms = in_turns({"kernel": lambda: ops.segment_matmul(
            real_m, real_ids, n)}, reps=10)["kernel"]
        b_ms, by = bound(e, d, n)
        out[shape] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                      "library_ms": ms["index_add_"], "bound_ms": b_ms,
                      "bound_by": by,
                      "max_abs_err": errs[f"{shape} -> {n}"],
                      "largest_run": hub,
                      "community_rows": n_real, "community_ms": real_ms,
                      "community_bound_ms": bound(n_real, d, n)[0]}
    return out


def drive_training_path(core, edges: np.ndarray, dev, card: str) -> dict:
    """Phase 13: the truss-filtered GCN rounds, then each GNN arch at full
    config through the launcher (in process, a restart check each, one as
    a subprocess whose path holds ``repro_torch`` alone); the launch counts
    are read just after them.  Then each arch's step and the truss-filtered
    step against the plain route, and K4 timed on the inputs that step
    handed it (launches not counted)."""
    from repro_torch.configs import get_config
    from repro_torch.data import sampler
    from repro_torch.data.streams import GraphUpdateStream
    from repro_torch.kernels import (bitmap_support, ops, peel_wave, ref,
                                     segment_matmul)
    from repro_torch.models import gnn
    from repro_torch.training import optimizer as opt

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).model
    out = {"arch": TRAIN_ARCH, "k": TRAIN_K, "chunk": TRAIN_CHUNK,
           "d_feat": TRAIN_D_FEAT, "pad_edges": TRAIN_PAD_EDGES}
    t = time.perf_counter()
    g = core.DynamicGraph(N_NODES, edges, support_method="bitmap",
                          tracked_ks=(TRAIN_K,), device=dev)
    sync(dev)
    out["decompose_s"] = time.perf_counter() - t
    stream = GraphUpdateStream(g.edge_list().astype(np.int64), N_NODES,
                               chunk=TRAIN_CHUNK, seed=1)
    params = gnn.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             TRAIN_D_FEAT)
    first = [p.clone() for p in opt.tree_leaves(params)]
    state = opt.adamw_init(params)
    loss_fn = lambda p, b: gnn.loss_fn(cfg, p, b)
    step = opt.make_train_step(loss_fn, opt.AdamWConfig(**TRAIN_OPT))
    per_step = cfg.n_layers + 1        # the degree count, then each layer
    reset_counts(peel_wave, bitmap_support, segment_matmul)
    rounds = []
    for rnd in range(TRAIN_ROUNDS):
        ups = [tuple(map(int, r)) for r in stream.next()]
        k1, k1d = peel_wave.LAUNCHES, peel_wave.LAUNCHES_BY_BODY["digest"]
        t = time.perf_counter()
        g.apply_batch(ups, strategy="auto")
        sync(dev)
        rec = {"apply_s": time.perf_counter() - t,
               "k1_launches": peel_wave.LAUNCHES - k1}
        if rec["k1_launches"] <= 0 or \
                peel_wave.LAUNCHES_BY_BODY["digest"] - k1d != rec["k1_launches"]:
            raise AssertionError(f"round {rnd}: K1 launched {rec['k1_launches']} "
                                 f"times, expected the digest body in every "
                                 f"one and at least one")
        t = time.perf_counter()
        community = g.k_truss(TRAIN_K)
        if len(community) == 0:
            community = g.edge_list()
        nb = sampler.make_gnn_batch(
            community.astype(np.int64), N_NODES, TRAIN_D_FEAT,
            n_classes=cfg.n_classes, pad_nodes=N_NODES,
            pad_edges=TRAIN_PAD_EDGES, seed=rnd)
        batch = gnn.batch_to_torch(nb, dev)
        del nb
        sync(dev)
        rec.update(community_edges=len(community),
                   batch_s=time.perf_counter() - t, step_ms=[], loss=[])
        for i in range(TRAIN_STEPS):
            n4 = segment_matmul.LAUNCHES
            t = time.perf_counter()
            if rnd == TRAIN_ROUNDS - 1 and i == TRAIN_STEPS - 1 \
                    and dev.type == "cuda":
                # the last step under the profiler: busy share, top ops
                box = []
                out["profiled_step_busy"] = profiled(
                    lambda: box.append(step(params, state, batch)),
                    require="segment_sum")
                params, state, stats = box[0]
            else:
                params, state, stats = step(params, state, batch)
            loss = float(stats["loss"])
            sync(dev)
            rec["step_ms"].append(1e3 * (time.perf_counter() - t))
            rec["loss"].append(loss)
            if segment_matmul.LAUNCHES - n4 != per_step:
                raise AssertionError(f"round {rnd}: K4 launched "
                                     f"{segment_matmul.LAUNCHES - n4} times "
                                     f"in a step, expected {per_step}")
            if not np.isfinite(loss):
                raise AssertionError(f"round {rnd}: loss {loss}")
        log(f"training round {rnd} ({card}): {json.dumps(rec)}")
        rounds.append(rec)
    out["rounds"] = rounds
    if not any(not torch.equal(a, b)
               for a, b in zip(opt.tree_leaves(params), first)):
        raise AssertionError("the truss-filtered rounds left the params as "
                             "they were")
    rounds_k4 = segment_matmul.LAUNCHES

    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        out["launcher"] = {}
        for arch_id in GNN_ARCHS:
            n4 = segment_matmul.LAUNCHES
            t = time.perf_counter()
            rec = check_restart(arch_id, work, dev)
            rec.update(s=time.perf_counter() - t,
                       k4_launches=segment_matmul.LAUNCHES - n4)
            if rec["k4_launches"] <= 0:
                raise AssertionError(f"launcher {arch_id}: {rec}")
            log(f"launcher {arch_id} --full ({card}): {json.dumps(rec)}")
            out["launcher"][arch_id] = rec
        out["launches"] = {"peel_wave": peel_wave.LAUNCHES,
                           "bitmap_support": bitmap_support.LAUNCHES,
                           "segment_matmul": segment_matmul.LAUNCHES,
                           "segment_matmul_rounds": rounds_k4}
        out["by_body"] = {"peel_wave": dict(peel_wave.LAUNCHES_BY_BODY),
                          "bitmap_support": dict(
                              bitmap_support.LAUNCHES_BY_BODY)}
        pkg = os.path.join(work, "pkg")
        os.makedirs(pkg)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             TRAIN_ARCH, "--full", "--steps", "3", "--device", str(dev),
             "--ckpt", os.path.join(work, "sub.npz")],
            env=_launcher_env(pkg), cwd=ROOT, capture_output=True, text=True,
            timeout=LAUNCHER_TIMEOUT_S)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
        if proc.returncode != 0 or not line.endswith(f"on {dev}"):
            raise AssertionError(f"launch.train subprocess exited "
                                 f"{proc.returncode}: {proc.stdout[-2000:]}"
                                 f"{proc.stderr[-4000:]}")
        out["subprocess"] = {"s": time.perf_counter() - t, "line": line}
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # each arch's step (K4) against the plain route at full config, then
    # the truss-filtered step on the last batch, and K4 timed on what
    # that step handed it
    t = time.perf_counter()
    out["arch_vs_plain"] = check_arch_steps(ops, ref, dev)
    out["arch_vs_plain_s"] = time.perf_counter() - t
    log(f"each arch's step vs plain ({card}): "
        f"{json.dumps(out['arch_vs_plain'])}")
    out["vs_plain"], seen = step_vs_plain(ops, ref, loss_fn, params, batch,
                                          "truss-filtered step")
    if len(seen) != per_step:
        raise AssertionError(f"the truss-filtered step handed K4 "
                             f"{len(seen)} inputs, expected {per_step}")
    n_real = int(batch["edge_mask"].sum())
    if not bool(batch["edge_mask"][:n_real].all()):
        raise AssertionError("the batch's padding edges are not a suffix")
    out["k4_shapes"] = _k4_training_shapes(
        ops, ref, seen, out["vs_plain"]["k4_max_abs_err"], n_real, dev)
    del g, batch, params, state, seen
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


@contextlib.contextmanager
def timed_checkpoints(checkpoint):
    """Seconds and bytes of each checkpoint the loop writes while inside:
    the host copy (``_host_copy``, on the loop's thread) and the write
    (``save``, on the writer's), by wrapping both; the copy is timed at
    its outermost call."""
    got = {"host_copy_s": [], "write_s": [], "bytes": []}
    copy, save = checkpoint._host_copy, checkpoint.save
    depth = [0]          # _host_copy recurses through this name

    def timed_copy(tree):
        depth[0] += 1
        t = time.perf_counter()
        try:
            return copy(tree)
        finally:
            depth[0] -= 1
            if not depth[0]:
                got["host_copy_s"].append(time.perf_counter() - t)

    def timed_save(path, tree, step=None):
        t = time.perf_counter()
        save(path, tree, step)
        got["write_s"].append(time.perf_counter() - t)
        got["bytes"].append(os.path.getsize(path))

    checkpoint._host_copy, checkpoint.save = timed_copy, timed_save
    try:
        yield got
    finally:
        checkpoint._host_copy, checkpoint.save = copy, save


def leaf_errors(grads_k, grads_p, what: str, tol: float, metric: str) -> list:
    """Each gradient leaf of the kernel route against the plain route's, by
    ``metric`` ("max": max abs error over the leaf's largest magnitude;
    "fro": relative Frobenius error), failing past ``tol`` or on a value
    that is not finite."""
    from repro_torch.training import optimizer as opt

    errs = []
    for i, (a, b) in enumerate(zip(opt.tree_leaves(grads_k),
                                   opt.tree_leaves(grads_p))):
        if metric == "fro":
            err = float(torch.linalg.vector_norm((a - b).float()))
            scale = float(torch.linalg.vector_norm(b.float()))
        else:
            err, scale = float((a - b).abs().max()), float(b.abs().max())
        if not bool(torch.isfinite(a).all()) or not err <= tol * scale:
            raise AssertionError(f"{what}: gradient leaf {i} off by {err} "
                                 f"of {scale} ({metric}) against the plain "
                                 f"route")
        errs.append(err / scale if scale else err)
    return errs


def loss_error(loss_k, loss_p, what: str, rtol: float) -> float:
    """The step loss's relative error against the plain route's, failing
    past ``rtol``."""
    err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not err <= rtol:
        raise AssertionError(f"{what}: step loss {float(loss_k)} vs plain "
                             f"{float(loss_p)}")
    return err


def lm_step_vs_plain(ops, ref, fa, loss_fn, params, batch, what: str) -> dict:
    """One LM step's loss and gradients through K3 against the same under
    ``use_kernels(False)`` on the card, at matched routing where the model
    has MoE layers: the kernel route routes freely, and each MoE layer's
    recompute in the backward must choose what its forward chose
    (``layer_routes``: 0 differing decisions, two calls a layer); the
    plain route replays the kernel route's forward choices, in its forward
    and in its recompute.  The loss within ``LM_STEP_LOSS_RTOL``, each
    leaf within ``LM_STEP_GRAD_FRO`` relative Frobenius error, each
    route's own choices at those matched inputs differing only within
    ``ROUTE_TIE_GAP`` of a tie.  Beside it, not held, the bf16 noise
    floor: the plain route against itself with its attention blocks
    halved (1,024 -> 512 queries and keys), taken after the kernel route's
    gradients are freed, so no more than two gradient trees exist at once.
    Returns also the kernel route's synchronised seconds, peak memory (and
    what was allocated when it started) and K3's launches by body in it."""
    from repro_torch.models import layers
    from repro_torch.training import optimizer as opt

    before = dict(fa.LAUNCHES_BY_BODY)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t = time.perf_counter()
    with layer_routes(layers, params) as rk:
        loss_k, grads_k = opt.value_and_grad(loss_fn, params, batch)
        sync("cuda")
    out = {"kernel_s": time.perf_counter() - t,
           "kernel_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "resident_gb": resident / 1e9,
           "launches": {b: n - before[b]
                        for b, n in fa.LAUNCHES_BY_BODY.items()},
           "loss": float(loss_k)}
    recompute = [int(d) for d in rk.recompute_differ]
    out.update(calls_a_layer=rk.calls, recompute_differ=recompute)
    if rk.calls != [2] * len(rk.calls) or any(recompute):
        raise AssertionError(f"{what}: the kernel route's layers were called "
                             f"{rk.calls} times (a forward and a recompute "
                             f"each expected) and their recomputes changed "
                             f"{recompute} routing decisions (0 expected)")
    replay = lambda i, j: rk.routes[i][0].gate_idx  # noqa: E731
    inner = ref.chunked_attention_ref
    ops.use_kernels(False)
    try:
        with layer_routes(layers, params, replay=replay) as rp:
            loss_p, grads_p = opt.value_and_grad(loss_fn, params, batch)
        errs = leaf_errors(grads_k, grads_p, what, LM_STEP_GRAD_FRO, "fro")
        del grads_k
        ref.chunked_attention_ref = functools.partial(inner, q_chunk=512,
                                                      kv_chunk=512)
        with layer_routes(layers, params, replay=replay):
            _, grads_h = opt.value_and_grad(loss_fn, params, batch)
        floor = [float(torch.linalg.vector_norm((a - b).float())
                       / torch.linalg.vector_norm(b.float())) for a, b in zip(
            opt.tree_leaves(grads_h), opt.tree_leaves(grads_p))]
        del grads_h, grads_p
    finally:
        ref.chunked_attention_ref = inner
        ops.use_kernels(True)
    torch.cuda.empty_cache()
    diffs = route_differences(rk.forward, rp.forward)
    check_route_gaps(diffs, f"{what}, kernel vs plain route")
    out.update(
        plain_loss=float(loss_p),
        loss_rel_err=loss_error(loss_k, loss_p, what, LM_STEP_LOSS_RTOL),
        leaves=len(errs), leaf_fro_err_max=max(errs),
        leaf_fro_err_median=float(np.median(errs)),
        noise_floor_fro_max=max(floor),
        noise_floor_fro_median=float(np.median(floor)), routing=diffs,
        plain_recompute_differ=[int(d) for d in rp.recompute_differ])
    return out


@contextlib.contextmanager
def cin_backward_outputs(ref, replay=None):
    """Record the layer output that each K5 backward reads its relu mask
    from (``ref.cin_layer_vjp_ref``'s ``out``), in call order; with
    ``replay`` (an earlier recording), hand each call that output instead
    of its own, recording its own."""
    seen, inner = [], ref.cin_layer_vjp_ref
    it = iter(replay or ())

    def wrapped(xk, x0, w, out, g, **kw):
        seen.append(out)
        return inner(xk, x0, w, next(it) if replay else out, g, **kw)

    ref.cin_layer_vjp_ref = wrapped
    try:
        yield seen
    finally:
        ref.cin_layer_vjp_ref = inner


def recsys_step_vs_plain(ops, ref, loss_fn, params, batch, what: str) -> dict:
    """One xDeepFM step's loss and gradients through K4 and K5 against the
    same step under ``use_kernels(False)`` on the card: the loss within
    ``TRAIN_LOSS_RTOL``, each leaf within ``TRAIN_GRAD_RTOL`` of its largest
    magnitude, at matched relu decisions.  K5's backward masks its cotangent by ``out > 0``; the two
    routes' pre-activations differ by fp32 rounding, so where one lies
    within that of 0 they can take opposite sides of the kink, and one such
    element moves a table row's gradient by ~1e-4 of the leaf's scale
    (PERF.md section 6).  So the plain route's K5 backwards read the
    kernel route's outputs for their masks, and every decision that differs
    must lie within ``K5_TOL`` of 0 on both routes.  The errors of the
    plain route on its own decisions are logged beside, not held."""
    from repro_torch.training import optimizer as opt

    with cin_backward_outputs(ref) as outs_k:
        loss_k, grads_k = opt.value_and_grad(loss_fn, params, batch)
    ops.use_kernels(False)
    try:
        with cin_backward_outputs(ref, replay=outs_k) as outs_p:
            loss_p, grads_p = opt.value_and_grad(loss_fn, params, batch)
        _, grads_own = opt.value_and_grad(loss_fn, params, batch)
    finally:
        ops.use_kernels(True)
    if len(outs_k) != len(outs_p) or not outs_k:
        raise AssertionError(f"{what}: K5 backwards {len(outs_k)} vs "
                             f"{len(outs_p)}")
    flips, flip_max = 0, 0.0
    for a, b in zip(outs_k, outs_p):
        differ = (a > 0) != (b > 0)
        flips += int(differ.sum())
        flip_max = max(flip_max, float(torch.where(
            differ, torch.maximum(a, b), 0.0).max()))
    if flip_max > K5_TOL:
        raise AssertionError(f"{what}: the routes' relu decisions differ at "
                             f"an output of {flip_max}, beyond {K5_TOL}")
    errs = leaf_errors(grads_k, grads_p, what, TRAIN_GRAD_RTOL, "max")
    own = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(
        opt.tree_leaves(grads_k), opt.tree_leaves(grads_own))]
    return {"loss": float(loss_k), "plain_loss": float(loss_p),
            "loss_rel_err": loss_error(loss_k, loss_p, what, TRAIN_LOSS_RTOL),
            "leaf_max_err": errs, "leaves": len(errs),
            "relu_decisions_differing": flips,
            "largest_output_at_a_differing_decision": flip_max,
            "leaf_max_err_own_decisions": own}


def counted_training(name: str, run, path: str, dev, mods) -> tuple:
    """``run()``, a training run on the card that writes its final
    checkpoint to ``path`` and returns ``{"history": ...}``, with every
    kernel count set to 0 just before it and read just after; the step
    seconds, losses, peak device memory and the final checkpoint (host copy
    and write seconds, bytes; deleted after).  Returns the record and what
    ``run`` returned."""
    from repro_torch.training import checkpoint

    reset_counts(*mods)
    torch.cuda.reset_peak_memory_stats(dev)
    with timed_checkpoints(checkpoint) as ck:
        t = time.perf_counter()
        res = run()
        sync(dev)
        wall = time.perf_counter() - t
    rec = {"s": wall, "step_s": [h["dt"] for h in res["history"]],
           "loss": [h["loss"] for h in res["history"]],
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "checkpoint": ck,
           "launches": {m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES
                        for m in mods},
           "by_body": {m.__name__.rsplit(".", 1)[-1]: dict(m.LAUNCHES_BY_BODY)
                       for m in mods if hasattr(m, "LAUNCHES_BY_BODY")}}
    for f in (path, path + ".meta.json"):
        if os.path.exists(f):
            os.remove(f)
    if not np.all(np.isfinite(rec["loss"])) or len(ck["bytes"]) != 1:
        raise AssertionError(f"{name}: {json.dumps(rec)}")
    return rec, res


def train_through_launcher(arch_id: str, args: list, work: str, dev,
                           mods) -> dict:
    """``launch.train.main(["--arch", arch_id, "--full", *args])`` through
    ``counted_training``."""
    from repro_torch.launch import train

    path = os.path.join(work, f"{arch_id}.npz")
    rec, res = counted_training(
        f"{arch_id} --full", lambda: train.main(
            ["--arch", arch_id, "--full", *args, "--device", str(dev),
             "--ckpt", path]), path, dev, mods)
    del res
    torch.cuda.empty_cache()
    return rec


def time_attention_backward(ops, ref, dev) -> dict:
    """K3's forward and the plain attention backward (``attention_vjp_ref``)
    at the training layer ``[4, 4096, 16 q / 8 kv, 128]`` bf16 causal, CUDA
    events, median of 3 (forward 10), with the backward's fp32 flops: the
    scores recomputed and four products, each ``2·Dh`` a visible pair."""
    cfg = model_cfg(LM_ARCH)
    rng = np.random.default_rng(4)
    b, s, dh = PREFILL_BATCH, PREFILL_SEQ, cfg.head_dim
    q = _normal(rng, (b, s, cfg.n_heads, dh), torch.bfloat16, dev)
    k, v = (_normal(rng, (b, s, cfg.n_kv, dh), torch.bfloat16, dev)
            for _ in range(2))
    do = _normal(rng, (b, s, cfg.n_heads, dh), torch.bfloat16, dev)
    fwd = time_ms(lambda: ops.flash_attention_heads(q, k, v), 10)
    bwd = time_ms(lambda: ref.attention_vjp_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        do.transpose(1, 2), causal=True, window=None), 3)
    flops = 5 * 2 * dh * b * cfg.n_heads * attention_pairs(s, True, None)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ref.attention_vjp_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), do.transpose(1, 2), causal=True,
                          window=None)
    transient = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    return {"shape": f"[{b}, {s}, {cfg.n_heads} q / {cfg.n_kv} kv, {dh}] "
                     f"bf16 causal", "k3_forward_ms": fwd,
            "plain_backward_ms": bwd, "backward_gflop": flops / 1e9,
            "backward_tflops": flops / bwd / 1e9,
            "backward_transient_gb": transient}


def time_cin_backward(ops, ref, dev, step_s: float) -> dict:
    """The plain K5 backward (``cin_layer_vjp_ref``) of each CIN layer at
    ``train_batch``'s 65,536 rows, on the layer inputs a step's forward
    makes from the launcher's first batch: CUDA events, median of 3, its
    sum and its share of the median step; K4's plain gathered backward
    (``segment_gathered_vjp_ref``) on the step's bags too."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import ClickStream
    from repro_torch.models import recsys

    cfg = get_config(RECSYS_ARCH).model
    params = recsys.init_params(cfg, torch.Generator(dev).manual_seed(0))
    rows = int(RS_TRAIN[RS_TRAIN.index("--batch") + 1])
    batch = recsys.batch_to_torch(ClickStream(cfg, rows, seed=0).next(), dev)
    rng = np.random.default_rng(6)
    out = {"layers": []}
    with torch.no_grad():
        x0 = recsys._field_embeddings(cfg, params, batch).contiguous()
        xk = x0
        for w in params["cin"]:
            o = ops.cin_layer(xk, x0, w)
            g = _normal(rng, tuple(o.shape), torch.float32, dev)
            ms = time_ms(lambda: ref.cin_layer_vjp_ref(xk, x0, w, o, g), 3)
            out["layers"].append({"h": xk.shape[1], "plain_backward_ms": ms})
            xk = o
        mh_rows, bag_ids = recsys.multihot_bags(cfg, batch["multihot_ids"])
        nb = rows * cfg.n_multihot
        gb = _normal(rng, (nb, cfg.embed_dim), torch.float32, dev)
        out["k4_plain_backward_ms"] = time_ms(
            lambda: ref.segment_gathered_vjp_ref(
                gb, params["table"].shape, mh_rows, bag_ids, True), 3)
    out["k5_plain_backward_ms"] = sum(r["plain_backward_ms"]
                                      for r in out["layers"])
    out["k5_backward_share_of_step"] = \
        1e-3 * out["k5_plain_backward_ms"] / step_s
    del params, batch, x0, xk
    torch.cuda.empty_cache()
    return out


def drive_lm_recsys_training(dev, card: str) -> dict:
    """Phase 14: qwen3-0.6b at full width and depth and xDeepFM's
    train_batch through ``launch.train.main --full`` on the card (the
    kernel counts set to 0 just before each run and read just after: K3's
    wgmma body 28 times forward and 28 in the remat a step, K4 once and K5
    three times a step); each card step against ``use_kernels(False)``;
    the restart check at both smoke configs; the plain backwards timed."""
    from repro_torch.kernels import cin, flash_attention, ops, ref, segment_matmul
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    mods = (flash_attention, segment_matmul, cin)
    cfg = model_cfg(LM_ARCH)
    out = {"lm_reduced": f"train_4k [256, 4096] cut to [{PREFILL_BATCH}, "
                         f"{PREFILL_SEQ}]: the batch only",
           "recsys_reduced": "none: train_batch's 65,536 rows at the full "
                             "config"}
    work = tempfile.mkdtemp(prefix="chip_smoke_train14_")
    try:
        lm = train_through_launcher(LM_ARCH, LM_TRAIN, work, dev, mods)
        per_step = 2 * cfg.n_layers      # each layer, then its remat
        want = {"wgmma": LM_TRAIN_STEPS * per_step, "simt": 0}
        if lm["by_body"]["flash_attention"] != want or \
                lm["launches"]["segment_matmul"] or lm["launches"]["cin"]:
            raise AssertionError(f"{LM_ARCH} training launched {lm['launches']}"
                                 f" by body {lm['by_body']}, expected {want}")
        if abs(lm["loss"][0] - np.log(cfg.vocab)) > 0.5:
            raise AssertionError(f"{LM_ARCH}: first loss {lm['loss'][0]}, "
                                 f"expected near ln {cfg.vocab}")
        log(f"phase 14 {LM_ARCH} --full {LM_TRAIN} ({card}): {json.dumps(lm)}")
        out["lm"] = lm

        rs = train_through_launcher(RECSYS_ARCH, RS_TRAIN, work, dev, mods)
        n_cin = len(model_cfg(RECSYS_ARCH).cin_layers)
        if rs["launches"] != {"flash_attention": 0,
                              "segment_matmul": RS_TRAIN_STEPS,
                              "cin": n_cin * RS_TRAIN_STEPS}:
            raise AssertionError(f"{RECSYS_ARCH} training launched "
                                 f"{rs['launches']}, expected K4 once and K5 "
                                 f"{n_cin} times a step")
        log(f"phase 14 {RECSYS_ARCH} --full {RS_TRAIN} ({card}): "
            f"{json.dumps(rs)}")
        out["recsys"] = rs

        # each card step against the plain route (launches not counted)
        t = time.perf_counter()
        s = train.setup(LM_ARCH, steps=1, ckpt=os.devnull, full=True,
                        batch=PREFILL_BATCH, seq=PREFILL_SEQ, device=str(dev))
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in s.stream.next().items()}
        out["lm_vs_plain"] = lm_step_vs_plain(
            ops, ref, flash_attention, s.loss, s.init(), batch,
            f"{LM_ARCH} step")
        out["lm_vs_plain"]["s"] = time.perf_counter() - t
        log(f"{LM_ARCH} step vs plain ({card}; loss rtol {LM_STEP_LOSS_RTOL}"
            f", leaves {LM_STEP_GRAD_FRO} relative Frobenius): "
            f"{json.dumps(out['lm_vs_plain'])}")
        del s, batch
        torch.cuda.empty_cache()
        t = time.perf_counter()
        s = train.setup(RECSYS_ARCH, steps=1, ckpt=os.devnull, full=True,
                        batch=RS_CHECK_ROWS, device=str(dev))
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in s.stream.next().items()}
        out["recsys_vs_plain"] = recsys_step_vs_plain(
            ops, ref, s.loss, s.init(), batch, f"{RECSYS_ARCH} step")
        out["recsys_vs_plain"]["s"] = time.perf_counter() - t
        log(f"{RECSYS_ARCH} step vs plain on {RS_CHECK_ROWS} rows ({card}; "
            f"loss rtol {TRAIN_LOSS_RTOL}, leaves {TRAIN_GRAD_RTOL} of their "
            f"largest magnitude at matched relu decisions): "
            f"{json.dumps(out['recsys_vs_plain'])}")
        del s, batch
        torch.cuda.empty_cache()

        out["restart"] = {}
        for arch_id in (LM_ARCH, RECSYS_ARCH):
            t = time.perf_counter()
            rec = check_restart(arch_id, work, dev, full=False)
            rec["s"] = time.perf_counter() - t
            out["restart"][arch_id] = rec
        log(f"phase 14 restarts at the smoke configs ({card}): "
            f"{json.dumps(out['restart'])}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    out["attention_backward"] = time_attention_backward(ops, ref, dev)
    out["attention_backward"]["per_step_s"] = \
        1e-3 * out["attention_backward"]["plain_backward_ms"] * cfg.n_layers
    log(f"attention backward ({card}): {json.dumps(out['attention_backward'])}")
    out["cin_backward"] = time_cin_backward(
        ops, ref, dev, float(np.median(out["recsys"]["step_s"])))
    log(f"K5 plain backward ({card}): {json.dumps(out['cin_backward'])}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 15: MoE serving on the card
# ---------------------------------------------------------------------------

def route_differences(tape_a, tape_b) -> dict:
    """(token, choice) decisions that differ between two lists of routings
    of the same calls, each differing one's gap ``|p_a[e_a] - p_a[e_b]|``
    on the first list's router probabilities (0 at an exact tie)."""
    n, gaps = 0, []
    for ra, rb in zip(tape_a, tape_b):
        n += ra.gate_idx.numel()
        diff = ra.gate_idx != rb.gate_idx
        pa = torch.gather(ra.probs, -1, ra.gate_idx)[diff]
        pb = torch.gather(ra.probs, -1, rb.gate_idx)[diff]
        gaps += (pa - pb).abs().tolist()
    return {"decisions": n, "differ": len(gaps),
            "max_gap": max(gaps, default=0.0),
            "gaps": sorted(gaps, reverse=True)[:8]}


class LayerRoutes:
    """What ``layer_routes`` saw: ``routes[i][j]`` is layer ``i``'s own
    routing at its ``j``-th call (``probs`` detached, ``gate_idx``,
    ``keep`` and ``cap``)."""

    def __init__(self, n_layers: int):
        self.routes = [[] for _ in range(n_layers)]

    @property
    def calls(self) -> list:
        return [len(r) for r in self.routes]

    @property
    def forward(self) -> list:
        """Each layer's routing at its first call."""
        return [r[0] for r in self.routes]

    @property
    def recompute_differ(self) -> list:
        """Each layer's (token, choice) decisions of its later calls (under
        the per-layer remat, the recompute in the backward) that differ
        from its first call's, as 0-d device tensors."""
        return [sum((c.gate_idx != r[0].gate_idx).sum() for c in r[1:])
                for r in self.routes]


@contextlib.contextmanager
def layer_routes(layers, params, replay=None):
    """Wrap ``layers.moe_route`` (which ``moe_apply`` calls through the
    module) for the calls of a model whose per-layer parameters are
    ``params["layers"]`` (``i`` counts its MoE layers; a dense model has
    none).  Each call is keyed by its layer, found by the router leaf's
    storage (``value_and_grad`` hands the loss detached views of the same
    storage), and by its count within that layer, not by call order: under
    the per-layer ``checkpoint`` a layer is called again in the backward,
    in reverse layer order, and each decode step calls every layer once.
    Each call's own routing is recorded on the yielded ``LayerRoutes``.
    With ``replay`` (``replay(i, j)``: a ``gate_idx``), the ``j``-th call
    of layer ``i`` routes by ``replay(i, j)``; its own choice at those
    inputs is still computed (without a gradient) and recorded."""
    orig = layers.moe_route
    index = {lp["moe"]["router"].data_ptr(): i for i, lp in enumerate(
        [lp for lp in params["layers"] if "moe" in lp])}
    seen = LayerRoutes(len(index))

    def wrapped(router, x, *, n_experts, top_k, capacity_factor=1.25,
                gate_idx=None):
        i = index[router.data_ptr()]
        kw = dict(n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor)
        if replay is not None:
            gate_idx = replay(i, len(seen.routes[i]))
        r = orig(router, x, gate_idx=gate_idx, **kw)
        if replay is None:
            own = r
        else:
            with torch.no_grad():
                own = orig(router, x, **kw)
        seen.routes[i].append(layers.Routing(
            own.probs.detach(), own.gate_idx, None, own.keep, None, own.cap))
        return r

    layers.moe_route = wrapped
    try:
        yield seen
    finally:
        layers.moe_route = orig


def check_route_gaps(diffs: dict, what: str) -> None:
    if diffs["max_gap"] > ROUTE_TIE_GAP:
        raise AssertionError(f"{what}: a routing decision differs "
                             f"{diffs['max_gap']:.3g} from a tie in the "
                             f"router probabilities, over {ROUTE_TIE_GAP}: "
                             f"{json.dumps(diffs)}")


def decode_attention(q, k_cache, v_cache, valid, n_kv: int) -> torch.Tensor:
    """The decode attention of ``layers.attention_apply`` (fp32 scores and
    softmax over the bf16 cache) for q ``[B, Hq, Dh]`` -> ``[B, Hq, Dh]``."""
    b, hq, dh = q.shape
    qg = q.reshape(b, n_kv, hq // n_kv, dh).float()
    scores = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * dh ** -0.5
    w = torch.softmax(torch.where(valid, scores, -1e30), dim=-1)
    return torch.einsum("bkgc,bckd->bkgd", w, v_cache.float()).reshape(b, hq, dh)


def check_kv_quant(cfg, cache: dict, pos: int, dev) -> dict:
    """The engine's bf16 cache after serving (``[L, B, C, Hkv, Dh]``, ``pos``
    positions written) through ``kv_quant.quantize_kv``; ``attend_quant`` of
    a seeded query at the last position on every layer against the bf16
    decode attention (max abs error within ``KV_QUANT_TOL``); bytes and
    CUDA-event ms of both."""
    from repro_torch.serving import kv_quant

    kq, ks = kv_quant.quantize_kv(cache["k"])
    vq, vs = kv_quant.quantize_kv(cache["v"])
    c = cache["k"].shape[2]
    valid = torch.arange(c, device=dev) < pos
    q = torch.randn((cache["k"].shape[1], cfg.n_heads, cfg.head_dim),
                    generator=torch.Generator(dev).manual_seed(7), device=dev)
    errs = []
    for i in range(cfg.n_layers):
        layer = {"kq": kq[i], "ks": ks[i], "vq": vq[i], "vs": vs[i]}
        got = kv_quant.attend_quant(q, layer, valid, cfg.n_kv, cfg.head_dim)
        exp = decode_attention(q, cache["k"][i], cache["v"][i], valid,
                               cfg.n_kv)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"attend_quant layer {i}: not finite")
        errs.append(float((got - exp).abs().max()))
    if max(errs) > KV_QUANT_TOL:
        raise AssertionError(f"attend_quant differs from the bf16 decode "
                             f"attention by {max(errs)} > {KV_QUANT_TOL}")
    layer0 = {"kq": kq[0], "ks": ks[0], "vq": vq[0], "vs": vs[0]}
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    t = [time_ms(lambda: kv_quant.attend_quant(q, layer0, valid, cfg.n_kv,
                                               cfg.head_dim), 20),
         time_ms(lambda: decode_attention(q, cache["k"][0], cache["v"][0],
                                          valid, cfg.n_kv), 20)]
    t += [time_ms(lambda: decode_attention(q, cache["k"][0], cache["v"][0],
                                           valid, cfg.n_kv), 20),
          time_ms(lambda: kv_quant.attend_quant(q, layer0, valid, cfg.n_kv,
                                                cfg.head_dim), 20)]
    return {"cache": list(cache["k"].shape), "positions": pos,
            "max_abs_err": max(errs), "tol": KV_QUANT_TOL,
            "int8_bytes": nbytes(kq, ks, vq, vs),
            "bf16_bytes": nbytes(cache["k"], cache["v"]),
            "attend_quant_ms": [t[0], t[3]], "bf16_attention_ms": [t[1], t[2]]}


def serve_moe(cfg, params, dev, rng) -> dict:
    """``DecodeEngine``: ``MOE_SERVE_SLOTS`` requests of ``MOE_SERVE_PROMPT``
    prompt and ``MOE_SERVE_NEW`` new tokens, each wave timed; then
    ``decode_step``'s replay of the prompts against prefill's logits at the
    prompt length, row by row (a request's prompt routes per row; decode
    never drops, its capacity is 1).  The replay takes the expert choices
    of a prefill at the drop-free capacity (``cap = s``), the function
    decode computes, and is held within ``LOGIT_RTOL`` of it on every row,
    decode's own choices differing only within ``ROUTE_TIE_GAP`` of a tie;
    it is held to the configured prefill (capacity factor 1.25) on the
    rows where that dropped no token, and each row's drops are logged."""
    from repro_torch.models import layers, transformer
    from repro_torch.serving import DecodeEngine, Request

    prompts = rng.integers(1, cfg.vocab, (MOE_SERVE_SLOTS, MOE_SERVE_PROMPT))
    eng = DecodeEngine(cfg, params, batch_slots=MOE_SERVE_SLOTS,
                       max_seq=MOE_SERVE_MAX_SEQ, device=dev)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.tolist(), max_new=MOE_SERVE_NEW))
    wave_ms = []
    while True:
        t = time.perf_counter()
        if eng.step() == 0:          # each wave reads its tokens to the host
            break
        wave_ms.append(1e3 * (time.perf_counter() - t))
    done = eng.finished
    if len(done) != MOE_SERVE_SLOTS or any(len(r.out) != MOE_SERVE_NEW
                                           for r in done):
        raise AssertionError(f"{cfg.name}: the engine did not finish every "
                             f"request")
    out = {"waves": len(wave_ms), "wave_ms_p50": float(np.median(wave_ms)),
           "wave_ms_max": max(wave_ms), "wave_ms_first": wave_ms[0],
           "serve_s": sum(wave_ms) / 1e3,
           "new_tok_s": MOE_SERVE_SLOTS * MOE_SERVE_NEW / (sum(wave_ms) / 1e3),
           "cache": list(eng.cache["k"].shape)}

    # prefill of the prompts as configured (capacity factor 1.25: a row may
    # drop tokens) and with the drop-free capacity (cap = s), which is the
    # function decode computes: at one position the capacity is 1 for any
    # factor up to E / k, and a token's k experts are distinct
    ptoks = torch.from_numpy(prompts).to(dev)
    with layer_routes(layers, params) as pre:
        logits_p = transformer.prefill(cfg, params, ptoks)
    drops = sum((~r.keep).sum(-1) for r in pre.forward).tolist()  # per row
    wide = dataclasses.replace(cfg, moe_capacity=cfg.moe_experts / cfg.moe_top_k)
    with layer_routes(layers, params) as pre_w:
        logits_w = transformer.prefill(wide, params, ptoks)
    if any(not bool(r.keep.all()) for r in pre_w.forward):
        raise AssertionError(f"{cfg.name}: the drop-free prefill dropped")
    # decode replays the drop-free prefill's expert choices (step p of
    # layer i takes position p's) and records its own at those matched
    # inputs
    cache = transformer.init_cache(cfg, MOE_SERVE_SLOTS, MOE_SERVE_PROMPT,
                                   device=dev)
    with layer_routes(layers, params, replay=lambda i, p: pre_w.forward[
            i].gate_idx[:, p:p + 1]) as dec:
        for pos in range(MOE_SERVE_PROMPT):
            logits_d, _ = transformer.decode_step(cfg, params, cache,
                                                  ptoks[:, pos], pos)
    if dec.calls != [MOE_SERVE_PROMPT] * len(dec.calls) or any(
            not bool(r.keep.all()) or r.cap != 1
            for rs in dec.routes for r in rs):
        raise AssertionError(f"{cfg.name}: a decode step dropped a token or "
                             f"missed a layer ({dec.calls} calls a layer)")
    own = [layers.Routing(None, torch.cat([r.gate_idx for r in rs], 1),
                          None, None, None, 1) for rs in dec.routes]
    lmax = float(logits_w.abs().max())
    diffs = route_differences(pre_w.forward, own)
    check_route_gaps(diffs, f"{cfg.name} decode vs drop-free prefill")
    rows = []
    for b in range(MOE_SERVE_SLOTS):
        gap_w = float((logits_d[b] - logits_w[b]).abs().max())
        gap = float((logits_d[b] - logits_p[b]).abs().max())
        rows.append({"dropped": drops[b], "dlogit_drop_free": gap_w,
                     "dlogit": gap, "held_to_configured": drops[b] == 0})
        if not gap_w <= LOGIT_RTOL * lmax or \
                (drops[b] == 0 and not gap <= LOGIT_RTOL * lmax):
            raise AssertionError(f"{cfg.name} row {b}: decode_step replay "
                                 f"differs from prefill: {rows[-1]}, limit "
                                 f"{LOGIT_RTOL} x {lmax}")
    out["replay_routing"] = diffs
    out.update(replay_rows=rows, largest_logit=lmax,
               prefill_drops=int(sum(drops)))
    out["cache_obj"], out["pos"] = eng.cache, eng.pos
    return out


def drive_moe_arch(ops, fa, arch_id: str, n_layers: int, batch: int,
                   seq: int, dev, card: str) -> dict:
    """One MoE arch at full width with its depth cut to ``n_layers``,
    seeded random weights: two timed prefill calls of ``[batch, seq]``
    (K3's wgmma body once a layer a call, the SIMT body never; the counts
    set to 0 before them and read after), the logits against the plain
    route at matched routing and each route's own decisions, serving, and
    for ``KV_QUANT_ARCH`` the int8 cache.  The launch counts are in
    ``out["launches"]``."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, transformer

    full = get_config(arch_id).model
    cfg = dataclasses.replace(full, n_layers=n_layers)
    out = {"reduced": f"depth {full.n_layers} -> {n_layers} layers (full "
                      f"width); prefill [{batch}, {seq}]"}
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(dev).manual_seed(0))
    sync(dev)
    n_total = sum(x.numel() for x in _leaves(params))
    if n_total - cfg.d_model != transformer.param_count(cfg):
        raise AssertionError(f"{arch_id}: {n_total} parameters - final norm "
                             f"!= param_count {transformer.param_count(cfg)}")
    out["params"] = transformer.param_count(cfg)
    out["active_params"] = transformer.active_param_count(cfg)
    out["cap"] = layers.moe_capacity(seq, cfg.moe_experts, cfg.moe_top_k,
                                     cfg.moe_capacity)
    log(f"{arch_id}: DEPTH CUT {full.n_layers} -> {n_layers} layers at full "
        f"width (d {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv} kv heads of "
        f"{cfg.head_dim}, {cfg.moe_experts} experts top-{cfg.moe_top_k} of "
        f"d_ff {cfg.d_ff}, window {cfg.window}, vocab {cfg.vocab}): "
        f"param_count {out['params']:,} ({4e-9 * n_total:.1f} GB fp32; full "
        f"depth {transformer.param_count(full):,}), active a token "
        f"{out['active_params']:,}; capacity {out['cap']} a row at s = {seq}; "
        f"init {time.perf_counter() - t:.1f} s ({card})")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, seq))).to(dev)

    reset_counts(fa)
    for i in range(2):
        by_body = dict(fa.LAUNCHES_BY_BODY)
        t0 = time.perf_counter()
        logits = transformer.prefill(cfg, params, tokens)
        sync(dev)
        dt = time.perf_counter() - t0
        ran = {b: c - by_body[b] for b, c in fa.LAUNCHES_BY_BODY.items()}
        if ran != {"wgmma": n_layers, "simt": 0}:
            raise AssertionError(f"{arch_id} prefill launched K3's bodies "
                                 f"{ran}, expected the wgmma body {n_layers} "
                                 f"times and the SIMT body never")
        if logits.shape != (batch, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch_id} prefill logits not finite or of "
                                 f"the wrong shape")
        log(f"{arch_id} prefill [{batch}, {seq}] call {i}: {dt:.3f} s, "
            f"{batch * seq / dt:,.0f} tokens/s, K3's bodies launched {ran}")
        out.setdefault("prefill_s", []).append(dt)
    out["launches"] = dict(fa.LAUNCHES_BY_BODY)
    out["prefill_tok_s"] = batch * seq / min(out["prefill_s"])
    out["prefill_busy"] = profiled(
        lambda: transformer.prefill(cfg, params, tokens))

    # the plain route (chunked attention) at the kernel route's routing,
    # and each route's own decisions at those matched inputs
    with layer_routes(layers, params) as tape_k:
        logits_k = transformer.prefill(cfg, params, tokens)
    ops.use_kernels(False)
    try:
        with layer_routes(layers, params, replay=lambda i, j: tape_k.routes[
                i][j].gate_idx) as tape_p:
            logits_p = transformer.prefill(cfg, params, tokens)
    finally:
        ops.use_kernels(True)
    dmax = float((logits_k - logits_p).abs().max())
    lmax = float(logits_p.abs().max())
    diffs = route_differences(tape_k.forward, tape_p.forward)
    drops = [int((~r.keep).sum()) for r in tape_k.forward]
    out.update(dlogit=dmax, largest_logit=lmax, routing=diffs,
               drops_by_layer=drops,
               slots=batch * seq * cfg.moe_top_k * n_layers)
    log(f"{arch_id} prefill vs the plain route at matched routing: max "
        f"|logit difference| {dmax:.4g} (largest |logit| {lmax:.4g}; limit "
        f"{LOGIT_RTOL:g} x that = {LOGIT_RTOL * lmax:.4g}); on each route's "
        f"own choices {diffs['differ']} of {diffs['decisions']} (token, "
        f"choice) decisions differ, largest gap from a tie "
        f"{diffs['max_gap']:.3g} (limit {ROUTE_TIE_GAP}); dropped slots a "
        f"layer {drops} of {batch * seq * cfg.moe_top_k}")
    if not dmax <= LOGIT_RTOL * lmax:
        raise AssertionError(f"{arch_id} prefill differs from the plain route "
                             f"at matched routing by {dmax} > {LOGIT_RTOL} x "
                             f"{lmax}")
    check_route_gaps(diffs, f"{arch_id} prefill, kernel vs plain route")
    del tape_k, tape_p, logits_k, logits_p, tokens
    torch.cuda.empty_cache()

    t = time.perf_counter()
    sv = serve_moe(cfg, params, dev, np.random.default_rng(2))
    cache, pos = sv.pop("cache_obj"), sv.pop("pos")
    sv["s"] = time.perf_counter() - t
    log(f"{arch_id} serve ({card}): {MOE_SERVE_SLOTS} requests x "
        f"({MOE_SERVE_PROMPT} prompt + {MOE_SERVE_NEW} new), cache "
        f"{sv['cache']} bf16 x2: {json.dumps(sv)}")
    out["serve"] = sv
    if arch_id == KV_QUANT_ARCH:
        out["kv_quant"] = check_kv_quant(cfg, cache, pos, dev)
        log(f"kv_quant on {arch_id}'s engine cache ({card}): "
            f"{json.dumps(out['kv_quant'])}")
    del params, cache
    torch.cuda.empty_cache()
    return out


def moe_launchers(dev, work: str) -> dict:
    """``python -m repro_torch.launch.serve --arch <moe arch>`` and
    ``python -m repro_torch.launch.train --arch <moe arch> --steps 3`` on
    the card (smoke configs), all four subprocesses at once, on a path
    holding ``repro_torch`` alone: each must exit 0 with finite losses.
    Then, in process, ``launch.train.main --steps 1`` on the card and on the
    CPU from the same parameters (drawn on the CPU): the first losses
    within ``MOE_LAUNCH_RTOL``; and the smoke config's aux loss on the
    launcher's first batch, which must be finite and nonzero."""
    import re

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.training.optimizer import tree_map

    def copy_to(tree, d):
        return tree_map(lambda t: t.detach().to(d, copy=True), tree)

    env = _launcher_env(work)
    procs = {}
    t = time.perf_counter()
    for arch in MOE_ARCHS:
        procs[f"{arch} serve"] = ["repro_torch.launch.serve", "--arch", arch,
                                  "--device", str(dev)]
        procs[f"{arch} train"] = ["repro_torch.launch.train", "--arch", arch,
                                  "--steps", "3", "--device", str(dev),
                                  "--ckpt", os.path.join(work, f"{arch}.npz")]
    running = {k: subprocess.Popen([sys.executable, "-m", *a], env=env,
                                   cwd=ROOT, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
               for k, a in procs.items()}
    out = {}
    try:
        for k, p in running.items():
            text, _ = p.communicate(timeout=MOE_LAUNCH_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"{k} exited {p.returncode}:\n"
                                     f"{text[-4000:]}")
            line = text.strip().splitlines()[-1]
            if k.endswith("train"):
                m = re.search(r"step0 loss=(\S+) final loss=(\S+) \(3 steps\)"
                              rf" on {dev}", line)
                if not m or not all(np.isfinite([float(m[1]), float(m[2])])):
                    raise AssertionError(f"{k}: {line}")
                out[k] = {"first": float(m[1]), "final": float(m[2])}
            else:
                if "served 8 requests" not in line or \
                        not line.endswith(f"on {dev}"):
                    raise AssertionError(f"{k}: {line}")
                out[k] = line
    finally:
        for p in running.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out["subprocess_s"] = time.perf_counter() - t

    for arch in MOE_ARCHS:
        cfg = get_config(arch).smoke
        drawn = transformer.init_params(cfg, torch.Generator().manual_seed(0))
        first = {}
        orig = train.transformer.init_params
        for i, d in enumerate(("cpu", str(dev))):
            train.transformer.init_params = \
                lambda c, gen, d=d: copy_to(drawn, d)
            try:
                res = train.main(["--arch", arch, "--steps", "1", "--device",
                                  d, "--ckpt",
                                  os.path.join(work, f"{arch}-{i}.npz")])
            finally:
                train.transformer.init_params = orig
            first[d] = res["history"][0]["loss"]
        rel = abs(first[str(dev)] - first["cpu"]) / abs(first["cpu"])
        toks = synthetic.TokenStream(cfg.vocab, 8, 128, seed=0).next()["tokens"]
        _, aux = transformer.backbone(cfg, copy_to(drawn, dev),
                                      torch.as_tensor(toks, device=dev))
        aux = float(aux)
        out[f"{arch} in process"] = {"first_loss": first, "rel": rel,
                                     "aux": aux}
        if not rel <= MOE_LAUNCH_RTOL or not np.isfinite(aux) or aux == 0:
            raise AssertionError(f"{arch} launcher in process: "
                                 f"{out[f'{arch} in process']}")
    return out


def time_moe_attention(ops, ref, fa, dev) -> dict:
    """K3 at the MoE layouts (``MOE_K3_LAYOUTS``: mixtral's windowed GQA
    group of 4 at its prefill's and its training's shapes, llama4-scout's
    causal group of 5, prefill and training alike): held against the plain
    version,
    then timed (CUDA events, median of 10; plain median of 3) beside its
    bound (the pairs inside the mask) and ``scaled_dot_product_attention``
    for the same function (where the window masks no key, as in llama4's
    layouts and mixtral's training one: ``enable_gqa``, causal; mixtral's
    prefill: the K/V heads expanded before the clock and an explicit boolean
    band mask, as SDPA's GQA flag takes no mask but on its math backend)."""
    import torch.nn.functional as F

    out, errs = {}, {}
    rng = np.random.default_rng(4)
    for key, (b, s, hq, hkv, dh, window) in MOE_K3_LAYOUTS.items():
        q = _normal(rng, (b, s, hq, dh), torch.bfloat16, dev)
        k, v = (_normal(rng, (b, s, hkv, dh), torch.bfloat16, dev)
                for _ in range(2))
        kern = lambda: fa.flash_attention_cuda(q, k, v, window=window)  # noqa: E731
        n = dict(fa.LAUNCHES_BY_BODY)
        got = kern()
        if fa.LAUNCHES_BY_BODY["wgmma"] != n["wgmma"] + 1:
            raise AssertionError(f"K3 at {key}'s layout did not run the "
                                 f"wgmma body")
        exp = ref.chunked_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window).transpose(1, 2)
        name = f"{key} [{b}, {s}, {hq} q / {hkv} kv, {dh}] window {window}"
        errs[name] = check_close(got, exp, K3_PATH_ATOL, f"K3 {name}",
                                 K3_PATH_RTOL)
        del got, exp
        ops.use_kernels(False)
        try:
            pm = time_ms(lambda: ops.flash_attention_heads(
                q, k, v, window=window), 3)
        finally:
            ops.use_kernels(True)
        qt = q.transpose(1, 2)
        if window is None or window >= s:
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True)
        else:
            ke = k.repeat_interleave(hq // hkv, 2).transpose(1, 2)
            ve = v.repeat_interleave(hq // hkv, 2).transpose(1, 2)
            pos = torch.arange(s, device=dev)
            band = (pos[:, None] >= pos[None, :]) & \
                (pos[:, None] - pos[None, :] < window)
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, ke, ve, attn_mask=band)
            lib_out = lib_fn().transpose(1, 2)
            errs[f"SDPA at {name} (yardstick, not held)"] = float(
                (lib_out.float() - kern().float()).abs().max())
            del lib_out
        t = [time_ms(kern, 10), time_ms(lib_fn, 10), time_ms(lib_fn, 10),
             time_ms(kern, 10)]
        pairs = attention_pairs(s, True, window)
        flops = 4 * dh * b * hq * pairs
        bound = k3_bound(q, k, flops)
        ms = (t[0] + t[3]) / 2
        out[key] = {"layout": name, "ms": ms, "ms_turns": [t[0], t[3]],
                    "plain_ms": pm, "sdpa_ms": (t[1] + t[2]) / 2,
                    "sdpa_turns": [t[1], t[2]], "bound_ms": bound[0],
                    "bound_by": bound[1], "pairs": pairs,
                    "tflops": flops / ms / 1e9}
        log(f"K3 {name} bf16: wgmma body {t[0]:.4f} / {t[3]:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s over the {pairs:,} pairs a "
            f"head inside the mask, {bound[0] / ms:.1%} of the bound), plain "
            f"{pm:.3f} ms, scaled_dot_product_attention {t[1]:.4f} / "
            f"{t[2]:.4f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({flops / 1e9:.1f} GFLOP; {bound[2] / 1e6:.1f} MB)")
        del q, k, v
        torch.cuda.empty_cache()
    return {"layouts": out, "errs": errs}


def drive_moe_serving(dev, card: str) -> dict:
    """Phase 15: both MoE archs (full width, labelled depth cuts), each
    built, driven and freed in turn; the launchers; K3 at the MoE
    layouts.  Returns the phase's readings; ``launches`` holds K3's launches
    by body on the two archs' prefill paths."""
    from repro_torch.kernels import flash_attention, ops, ref

    t_phase = time.perf_counter()
    out = {"archs": {}}
    launches = {"wgmma": 0, "simt": 0}
    for arch_id, n_layers, batch, seq in MOE_RUNS:
        t = time.perf_counter()
        res = drive_moe_arch(ops, flash_attention, arch_id, n_layers, batch,
                             seq, dev, card)
        res["s"] = time.perf_counter() - t
        for body, n in res["launches"].items():
            launches[body] += n
        out["archs"][arch_id] = res
        log(f"phase 15 {arch_id} ({card}): {json.dumps(res)}")
    out["launches"] = launches
    work = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        t = time.perf_counter()
        out["launchers"] = moe_launchers(dev, work)
        out["launchers"]["s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 15 launchers ({card}): {json.dumps(out['launchers'])}")
    out["k3"] = time_moe_attention(ops, ref, flash_attention, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 16: the cell plans, the dry-run, the expert block's mesh branches
# ---------------------------------------------------------------------------

def start_dryrun(work: str) -> dict:
    """``python -m repro_torch.launch.dryrun --mesh both`` into ``work`` as
    a subprocess on a path holding ``repro_torch`` alone, with no card
    visible (it traces on ``meta``), output to a file.  It runs beside the
    phases that follow its start, on its own core."""
    pkg = os.path.join(work, "pkg")
    os.makedirs(pkg)
    env = _launcher_env(pkg)
    env["CUDA_VISIBLE_DEVICES"] = ""
    log_path = os.path.join(work, "dryrun.log")
    with open(log_path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
             "both", "--out", os.path.join(work, "dryrun_artifacts")],
            env=env, cwd=work, stdout=f, stderr=subprocess.STDOUT)
    return {"proc": proc, "t0": time.perf_counter(), "t0_wall": time.time(),
            "log": log_path, "out": os.path.join(work, "dryrun_artifacts")}


def finish_dryrun(run: dict, card: str) -> dict:
    """Wait for the dry-run (``DRYRUN_TIMEOUT`` after its start), require
    exit 0 and ``72/72 cells traced``, and log each cell's per-device
    argument GB on both meshes, its matmul flops and trace seconds."""
    proc, t_wait = run["proc"], time.perf_counter()
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT
                                   - (time.perf_counter() - run["t0"])))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    waited = time.perf_counter() - t_wait
    with open(run["log"]) as f:
        text = f.read()
    if rc != 0 or f"{DRYRUN_CELLS}/{DRYRUN_CELLS} cells traced" not in text:
        raise AssertionError(f"the dry-run exited {rc}:\n{text[-4000:]}")
    summary = os.path.join(run["out"], "summary.json")
    wall = os.path.getmtime(summary) - run["t0_wall"]   # start to summary
    with open(summary) as f:
        recs = json.load(f)
    cells = {}
    for r in recs:
        c = cells.setdefault(f"{r['arch']}/{r['cell']}", {})
        c[f"{r['mesh']}_arg_gb"] = r["argument_size_in_bytes"] / 1e9
        c["matmul_flops"] = r["matmul_flops"]
        c[f"{r['mesh']}_trace_s"] = r["trace_s"]
    for name, c in cells.items():
        log(f"phase 16 dry-run {name}: arguments {c['single_arg_gb']:.3f} / "
            f"{c['multi_arg_gb']:.3f} GB a device (single / multi pod, "
            f"computed from shapes), matmul_flops {c['matmul_flops']:.4e}, "
            f"trace {c['single_trace_s']} / {c['multi_trace_s']} s")
    out = {"wall_s": wall, "waited_s": waited, "cells": len(recs),
           "trace_s": sum(r["trace_s"] for r in recs), "by_cell": cells}
    log(f"phase 16 dry-run ({card}): {len(recs)}/{DRYRUN_CELLS} cells traced "
        f"in {wall:.1f} s of wall time from its start to its summary "
        f"(traces {out['trace_s']:.1f} s); phase 16 waited {waited:.1f} s "
        f"for it")
    return out


def _tree_sig(tree):
    """Paths, shapes and dtypes of a tree of tensors."""
    from repro_torch.launch.specs import tree_paths
    return [(p, tuple(t.shape), t.dtype) for p, t in tree_paths(tree)]


def _plan_args(arch, cell, plan, dev) -> tuple:
    """The plan's arguments on the card: the port's own init from a seeded
    generator, the batch from ``PLAN_SEED``."""
    from repro_torch.data import sampler, synthetic
    from repro_torch.models import gnn, recsys, transformer
    from repro_torch.training.optimizer import adamw_init

    gen = torch.Generator(dev).manual_seed(PLAN_SEED)
    rng = np.random.default_rng(PLAN_SEED)
    if arch.family == "lm":
        params = transformer.stack_layers(
            transformer.init_params(arch.model, gen))
        b, s = cell.params["batch"], cell.params["seq"]
        tokens = torch.from_numpy(rng.integers(
            0, arch.model.vocab, (b, s), dtype=np.int32)).to(dev)
        return params, tokens
    if arch.family == "recsys":
        params = recsys.init_params(arch.model, gen)
        nb = synthetic.ClickStream(arch.model, cell.params["batch"],
                                   seed=PLAN_SEED).next()
        return params, recsys.batch_to_torch(nb, dev)
    n, d_feat = cell.params["n_nodes"], cell.params["d_feat"]
    edges = synthetic.powerlaw_graph(n, 4, seed=PLAN_SEED)[:cell.params["n_edges"]]
    want = plan.args[2]
    nb = sampler.make_gnn_batch(edges, n, d_feat, n_classes=arch.model.n_classes,
                                pad_edges=want["edge_src"].shape[0],
                                seed=PLAN_SEED)
    batch = gnn.batch_to_torch({k: nb[k] for k in want}, dev)
    params = gnn.init_params(arch.model, gen, d_feat)
    return params, adamw_init(params), batch


def _direct(arch, args):
    """The model's own entry point on the plan's tensors (xDeepFM and the
    GNN family): ``recsys.serve``, or a train step of ``gnn.loss_fn``."""
    from repro_torch.models import gnn, recsys
    from repro_torch.training import optimizer

    if arch.family == "recsys":
        return recsys.serve(arch.model, *args)
    step = optimizer.make_train_step(
        lambda p, b: gnn.loss_fn(arch.model, p, b, n_graphs=0),
        optimizer.AdamWConfig())
    return step(*args)


def run_plan_on_card(arch_id: str, cell_name: str, dev, card: str) -> dict:
    """One cell's plan run on the card at ``make_test_mesh((1, 1))``: the
    cell's global shape at full config.  The plan is first traced on
    ``meta`` at the same mesh (``dryrun.run_cell``); the card's arguments
    must match its tree and its ``argument_size_in_bytes`` exactly, the
    outputs its shapes and dtypes; outputs finite; launches counted (set
    to 0 just before the call, read just after)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cin, flash_attention, segment_matmul
    from repro_torch.launch import dryrun, mesh as lmesh, specs
    from repro_torch.launch.specs import tree_paths
    from repro_torch.models import transformer

    arch = get_config(arch_id)
    cell = next(c for c in arch.cells() if c.name == cell_name)
    rec = dryrun.run_cell(arch, cell_name,
                          lmesh.make_test_mesh((1, 1), device="meta"), "1x1")
    if not rec["ok"]:
        raise AssertionError(f"{arch_id}/{cell_name} on meta: {rec['error']}")
    plan = specs.build_cell(arch, cell, lmesh.make_test_mesh((1, 1), device=dev))
    t = time.perf_counter()
    args = _plan_args(arch, cell, plan, dev)
    sync(dev)
    init_s = time.perf_counter() - t
    if _tree_sig(args) != _tree_sig(plan.args):
        raise AssertionError(f"{arch_id}/{cell_name}: the card's arguments "
                             f"differ from the plan's shapes and dtypes")
    n_bytes = sum(x.numel() * x.element_size() for _, x in tree_paths(args))
    if n_bytes != rec["argument_size_in_bytes"]:
        raise AssertionError(f"{arch_id}/{cell_name}: {n_bytes} argument bytes "
                             f"on the card, the dry-run says "
                             f"{rec['argument_size_in_bytes']}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts(flash_attention, segment_matmul, cin)
    t = time.perf_counter()
    out = plan.fn(*args)
    sync(dev)
    run_s = time.perf_counter() - t
    launches = {"flash_attention": dict(flash_attention.LAUNCHES_BY_BODY),
                "segment_matmul": segment_matmul.LAUNCHES, "cin": cin.LAUNCHES}
    res = {"init_s": init_s, "run_s": run_s, "arg_bytes": n_bytes,
           "dryrun_arg_bytes": rec["argument_size_in_bytes"],
           "dryrun_out_bytes": rec["output_size_in_bytes"],
           "matmul_flops": rec["matmul_flops"], "trace_s": rec["trace_s"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_above_args_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "launches": launches}
    got = dryrun._shape_tree(out)
    if got != rec["outputs"]:
        raise AssertionError(f"{arch_id}/{cell_name}: outputs {got}, the meta "
                             f"trace's {rec['outputs']}")
    for p, x in tree_paths(out):
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{arch_id}/{cell_name}: {p} not finite")
    if arch.family == "lm":
        n = arch.model.n_layers
        if launches["flash_attention"] != {"wgmma": n, "simt": 0}:
            raise AssertionError(f"{arch_id}/{cell_name} launched K3's bodies "
                                 f"{launches['flash_attention']}, expected the "
                                 f"wgmma body {n} times")
        # rows 0-1 against a direct prefill of those two rows
        direct = transformer.prefill(arch.model,
                                     transformer.unstack_layers(args[0]),
                                     args[1][:PLAN_LM_ROWS])
        scale = float(direct.abs().max())
        res["rows_max_abs_diff"] = float((out[:PLAN_LM_ROWS] - direct).abs().max())
        res["rows_max_logit"] = scale
        if res["rows_max_abs_diff"] > LOGIT_RTOL * scale:
            raise AssertionError(f"{arch_id}/{cell_name}: rows 0-1 differ from "
                                 f"a direct prefill by {res['rows_max_abs_diff']}"
                                 f" > {LOGIT_RTOL} x {scale}")
    else:
        want = ({"segment_matmul": 1, "cin": 3} if arch.family == "recsys"
                else {"segment_matmul": 3, "cin": 0})
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"{arch_id}/{cell_name} launched {launches}, "
                                 f"expected {want}")
        direct = _direct(arch, args)
        for (p, x), (_, y) in zip(tree_paths(out), tree_paths(direct)):
            if not torch.equal(x, y):
                raise AssertionError(f"{arch_id}/{cell_name}: {p} differs from "
                                     f"the model's own entry point")
        res["bitwise_vs_direct"] = True
    log(f"phase 16 plan {arch_id}/{cell_name} on the card ({card}): "
        f"{json.dumps(res)}")
    del out, args
    torch.cuda.empty_cache()
    return res


def _time_call(fn, reps: int = 3) -> list:
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return ms


def check_expert_branches(dev, card: str) -> dict:
    """One MoE layer at full width on ``BRANCH_SHAPE`` (phase 15's
    mixtral prefill), seeded, on ``make_test_mesh(BRANCH_MESH)``:
    mixtral-8x7b's 8 experts take the model-sharded branch (16 ``d_ff``
    slices of 896), held to ``mesh=None`` at the same routing within
    ``BRANCH_FRO`` relative Frobenius error; llama4-scout's 16 take expert
    parallelism, bitwise equal to ``mesh=None``.  Then the same layer's
    backward: the gradients of ``sum(y · ct) + aux`` (a seeded cotangent)
    with respect to ``x``, the router and each expert stack, each leaf
    within ``BRANCH_FRO`` of ``mesh=None``'s (mixtral) or bitwise
    (llama4).  Forward and forward + backward timed against ``mesh=None``
    (host clock around a synchronised call, 3 calls)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers

    mesh = make_test_mesh(BRANCH_MESH, device=dev)
    out = {}
    for arch_id in MOE_ARCHS:
        cfg = get_config(arch_id).model
        gen = torch.Generator(dev).manual_seed(PLAN_SEED)
        p = layers.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.mlp)
        x = torch.randn((*BRANCH_SHAPE, cfg.d_model), generator=gen,
                        device=dev).to(layers.COMPUTE_DTYPE)
        ct = torch.randn((*BRANCH_SHAPE, cfg.d_model), generator=gen,
                         device=dev)
        kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, kind=cfg.mlp,
                  capacity_factor=cfg.moe_capacity)
        with torch.no_grad():
            y0, aux0 = layers.moe_apply(p, x, **kw)
            y1, aux1 = layers.moe_apply(p, x, mesh=mesh, **kw)
            t0 = _time_call(lambda: layers.moe_apply(p, x, **kw))
            t1 = _time_call(lambda: layers.moe_apply(p, x, mesh=mesh, **kw))
        ep = cfg.moe_experts % BRANCH_MESH[1] == 0
        fro = float((y1.float() - y0.float()).norm() / y0.float().norm())
        r = {"branch": "expert parallel" if ep else
             f"model-sharded, {BRANCH_MESH[1]} d_ff slices of "
             f"{cfg.d_ff // BRANCH_MESH[1]}",
             "rel_fro": fro, "finite": bool(torch.isfinite(y1).all()),
             "aux_equal": bool(torch.equal(aux0, aux1)),
             "mesh_none_ms": t0, "mesh_ms": t1}
        if not r["finite"] or not r["aux_equal"]:
            raise AssertionError(f"{arch_id} expert branch: {r}")
        if ep and not torch.equal(y0, y1):
            raise AssertionError(f"{arch_id}: the expert-parallel branch is not "
                                 f"bitwise equal to mesh=None ({fro})")
        if not ep and not 0 < fro <= BRANCH_FRO:
            raise AssertionError(f"{arch_id}: the model-sharded branch is "
                                 f"{fro} from mesh=None (bound {BRANCH_FRO})")
        del y0, y1
        names = ["x", *sorted(p)]
        leaves = [x.detach().requires_grad_(True)] + [
            p[k].detach().requires_grad_(True) for k in names[1:]]

        def grads(m):
            y, aux = layers.moe_apply(dict(zip(names[1:], leaves[1:])),
                                      leaves[0], mesh=m, **kw)
            return torch.autograd.grad((y.float() * ct).sum() + aux, leaves)

        g0, g1 = grads(None), grads(mesh)
        r["grad_rel_fro"] = {
            k: float((a.float() - b.float()).norm() / b.float().norm())
            for k, a, b in zip(names, g1, g0)}
        r["grad_finite"] = all(bool(torch.isfinite(g).all()) for g in g1)
        r["grad_equal"] = all(torch.equal(a, b) for a, b in zip(g1, g0))
        del g0, g1
        r["backward_mesh_none_ms"] = _time_call(lambda: grads(None))
        r["backward_mesh_ms"] = _time_call(lambda: grads(mesh))
        if not r["grad_finite"] or (ep and not r["grad_equal"]) or (
                not ep and not max(r["grad_rel_fro"].values()) <= BRANCH_FRO):
            raise AssertionError(f"{arch_id}: the {r['branch']} branch's "
                                 f"gradients against mesh=None: {r} (bound "
                                 f"{'bitwise' if ep else BRANCH_FRO})")
        log(f"phase 16 expert branch {arch_id} on {BRANCH_MESH} ({card}): "
            f"{json.dumps(r)}")
        out[arch_id] = r
        del p, x, ct, leaves
        torch.cuda.empty_cache()
    return out


def drive_plans(dev, card: str, dryrun_run: dict) -> dict:
    """Phase 16: the dry-run's result (started before phase 13), the three
    plans run on the card, the expert block's mesh branches.  ``launches``
    sums the plans' launches by kernel."""
    t_phase = time.perf_counter()
    out = {"dryrun": finish_dryrun(dryrun_run, card), "plans": {}}
    launches = {"flash_attention_wgmma": 0, "flash_attention_simt": 0,
                "segment_matmul": 0, "cin": 0}
    for arch_id, cell_name in PLAN_CELLS:
        r = run_plan_on_card(arch_id, cell_name, dev, card)
        out["plans"][f"{arch_id}/{cell_name}"] = r
        launches["flash_attention_wgmma"] += r["launches"]["flash_attention"]["wgmma"]
        launches["flash_attention_simt"] += r["launches"]["flash_attention"]["simt"]
        launches["segment_matmul"] += r["launches"]["segment_matmul"]
        launches["cin"] += r["launches"]["cin"]
    out["launches"] = launches
    out["branches"] = check_expert_branches(dev, card)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 17: MoE training at full width on the card
# ---------------------------------------------------------------------------

def moe_depth_cut(arch_id: str, copies: int, dev) -> tuple:
    """The full config of ``arch_id`` cut to the deepest depth at which
    ``copies`` fp32 copies of its parameters fit in ``MOE_TRAIN_FIT`` of
    the card's memory, and the reckoning: the GB those copies take at each
    depth up to the first that does not fit, the limit and the card."""
    from repro_torch.models import transformer

    full = model_cfg(arch_id)
    card = torch.cuda.get_device_properties(dev).total_memory
    limit, gb, depth = MOE_TRAIN_FIT * card, {}, 0
    for d in range(1, full.n_layers + 1):
        need = 4 * copies * transformer.param_count(
            dataclasses.replace(full, n_layers=d))
        gb[d] = need / 1e9
        if need > limit:
            break
        depth = d
    if depth == 0:
        raise AssertionError(f"{arch_id}: {copies} fp32 copies of one layer's "
                             f"parameters take {gb[1]:.1f} GB, over "
                             f"{limit / 1e9:.1f} GB")
    return dataclasses.replace(full, n_layers=depth), {
        "copies": copies, "gb_by_depth": gb, "limit_gb": limit / 1e9,
        "card_gb": card / 1e9}


def moe_train_loop(cfg, stream, loss_fn, init, work: str, dev, mods) -> tuple:
    """``loop.run`` of ``MOE_TRAIN_STEPS`` AdamW steps with
    ``launch.train.setup``'s optimizer settings through
    ``counted_training``, the last step under ``torch.profiler`` (opened in
    the hook after the step before it, closed in the hook after it).
    Returns the record and the trained parameters."""
    from repro_torch.training import loop
    from repro_torch.training.optimizer import AdamWConfig

    steps = MOE_TRAIN_STEPS
    path = os.path.join(work, f"{cfg.name}.npz")
    opt_cfg = AdamWConfig(total_steps=steps, warmup_steps=max(1, steps // 10))
    prof = {"top": []}

    def hook(step, stats):
        if step == steps - 2:
            prof["session"] = profile_open()
        elif step == steps - 1:
            prof["busy"] = profile_close(prof.pop("session"), top=prof["top"])

    rec, res = counted_training(
        f"{cfg.name} training", lambda: loop.run(
            loop.LoopConfig(total_steps=steps, ckpt_path=path), opt_cfg,
            loss_fn, init, stream, device=dev, hooks=[hook]), path, dev, mods)
    rec.update(grad_norm=[h["grad_norm"] for h in res["history"]],
               last_step_busy=prof["busy"], last_step_top_ops=prof["top"])
    params = res["params"]
    del res
    torch.cuda.empty_cache()
    return rec, params


def drive_moe_training(dev, card: str) -> dict:
    """Phase 17: the MoE archs' training at full width (``MOE_TRAIN_RUNS``,
    depth and batch cuts labelled): mixtral-8x7b's AdamW steps through
    ``loop.run`` with ``launch.train._lm_setup``'s stream, loss and
    initialiser, as ``launch.train.main`` drives them; llama4-scout's loss
    and gradients (its AdamW step holds 8 copies at any depth), profiled
    once.  The kernel counts are set to 0 just before each arch's run and
    read just after: K3's wgmma body twice a layer a step (each layer and
    its recompute), its SIMT body, K4 and K5 never.  Each arch's step is
    held against the plain route at matched routing, and mixtral's once
    more at ``MOE_WINDOW_STEP``.  ``launches`` sums K3's by body."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import cin, flash_attention, ops, ref, segment_matmul
    from repro_torch.launch import train
    from repro_torch.models import layers, transformer
    from repro_torch.training import optimizer as opt

    t_phase = time.perf_counter()
    mods = (flash_attention, segment_matmul, cin)
    out = {"archs": {}, "launches": {"wgmma": 0, "simt": 0}}
    work = tempfile.mkdtemp(prefix="chip_smoke_moe_train_")
    try:
        for arch_id, step, copies, b, s in MOE_TRAIN_RUNS:
            t_arch = time.perf_counter()
            cfg, cut = moe_depth_cut(arch_id, copies, dev)
            n_full = model_cfg(arch_id).n_layers
            adamw_gb = 32e-9 * transformer.param_count(cfg)
            rec = {"reduced": f"depth {n_full} -> {cfg.n_layers} layers (full "
                              f"width); train_4k [256, 4096] cut to [{b}, {s}]",
                   "layers": cfg.n_layers, "cut": cut,
                   "cap": layers.moe_capacity(s, cfg.moe_experts,
                                              cfg.moe_top_k, cfg.moe_capacity),
                   "params": transformer.param_count(cfg),
                   "adamw_8p_gb": adamw_gb}
            log(f"{arch_id}: DEPTH CUT {n_full} -> {cfg.n_layers} layers at "
                f"full width (d {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv} kv "
                f"heads of {cfg.head_dim}, {cfg.moe_experts} experts top-"
                f"{cfg.moe_top_k} of d_ff {cfg.d_ff}, window {cfg.window}, "
                f"vocab {cfg.vocab}): the {step} step holds ~{copies} fp32 "
                f"copies of the {rec['params']:,} parameters; GB by depth "
                f"{json.dumps({d: round(g, 2) for d, g in cut['gb_by_depth'].items()})}"
                f", limit {cut['limit_gb']:.1f} of {cut['card_gb']:.1f} GB "
                f"({card})")
            log(f"{arch_id}: BATCH CUT train_4k [256, 4096] -> [{b}, {s}]; "
                f"capacity {rec['cap']} slots an expert a row")
            stream, loss_fn, init = train._lm_setup(cfg, b, s, 0, str(dev))
            if step == "adamw":
                rec["train"], params = moe_train_loop(cfg, stream, loss_fn,
                                                      init, work, dev, mods)
                got, loss0 = rec["train"], rec["train"]["loss"][0]
                want = {"wgmma": 2 * cfg.n_layers * MOE_TRAIN_STEPS, "simt": 0}
                log(f"phase 17 {arch_id} loop.run ({card}): "
                    f"{json.dumps(rec['train'])}")
            else:
                log(f"{arch_id}: no AdamW step: adamw_update returns new "
                    f"params, mu and nu beside the old, ~8 fp32 copies = "
                    f"{adamw_gb:.1f} GB at depth {cfg.n_layers}, over the "
                    f"card's {cut['card_gb']:.1f} GB; loss and gradients only")
                params = init()
                reset_counts(*mods)
                got, want = None, {"wgmma": 2 * cfg.n_layers, "simt": 0}
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in stream.next().items()}
            t = time.perf_counter()
            vs = lm_step_vs_plain(ops, ref, flash_attention, loss_fn, params,
                                   batch, f"{arch_id} step")
            vs["s"] = time.perf_counter() - t
            rec["vs_plain"] = vs
            if got is None:
                got = {"by_body": {"flash_attention": vs["launches"]},
                       "launches": {"segment_matmul": segment_matmul.LAUNCHES,
                                    "cin": cin.LAUNCHES}}
                loss0 = vs["loss"]
                rec["grad_s"], rec["grad_peak_gb"] = \
                    vs["kernel_s"], vs["kernel_peak_gb"]
                prof_top = []
                rec["grad_busy"] = profiled(
                    lambda: opt.value_and_grad(loss_fn, params, batch),
                    top=prof_top)
                rec["grad_top_ops"] = prof_top
            if got["by_body"]["flash_attention"] != want or \
                    got["launches"]["segment_matmul"] or got["launches"]["cin"]:
                raise AssertionError(f"{arch_id} training launched "
                                     f"{got['launches']} by body "
                                     f"{got['by_body']}, expected {want}")
            if abs(loss0 - np.log(cfg.vocab)) > MOE_FIRST_LOSS_GAP:
                raise AssertionError(f"{arch_id}: first loss {loss0}, expected "
                                     f"within {MOE_FIRST_LOSS_GAP} of ln "
                                     f"{cfg.vocab}")
            rec["launches"] = got["by_body"]["flash_attention"]
            for body, n in rec["launches"].items():
                out["launches"][body] += n
            log(f"{arch_id} step vs plain at matched routing [{b}, {s}] "
                f"({card}; loss rtol {LM_STEP_LOSS_RTOL}, leaves "
                f"{LM_STEP_GRAD_FRO} relative Frobenius): {json.dumps(vs)}")
            del batch
            if step == "adamw":
                wb, ws = MOE_WINDOW_STEP
                batch = {k: torch.as_tensor(v, device=dev) for k, v in
                         TokenStream(cfg.vocab, wb, ws, seed=1).next().items()}
                loss_w = lambda p, bb: transformer.loss_fn(  # noqa: E731
                    cfg, p, bb, xent_chunk=min(512, ws))
                t = time.perf_counter()
                vw = lm_step_vs_plain(ops, ref, flash_attention, loss_w,
                                       params, batch, f"{arch_id} [{wb}, {ws}]")
                vw["s"] = time.perf_counter() - t
                rec["window_step"] = vw
                log(f"{arch_id} step vs plain at matched routing [{wb}, {ws}] "
                    f"(window {cfg.window} masks) ({card}): {json.dumps(vw)}")
                del batch
            del params, stream, loss_fn, init
            torch.cuda.empty_cache()
            rec["s"] = time.perf_counter() - t_arch
            out["archs"][arch_id] = rec
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def model_cfg(arch_id: str):
    """The full model config of ``arch_id``."""
    from repro_torch.configs import get_config
    return get_config(arch_id).model


def reset_counts(*mods) -> None:
    """Set the launch counts of the kernel modules to 0 (and K3's by body)."""
    for mod in mods:
        mod.LAUNCHES = 0
        for body in getattr(mod, "LAUNCHES_BY_BODY", ()):
            mod.LAUNCHES_BY_BODY[body] = 0


T_START = time.perf_counter()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import core
    from repro_torch.data.synthetic import powerlaw_graph
    from repro_torch.kernels import (_build, bitmap_support, flash_attention,
                                     ops, peel_wave, ref)

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_all(_build)
    k3_compile_report(_build, flash_attention)
    k5_compile = cin_compile_report(_build)

    err = check_test_shapes(ops, ref, dev)
    log(f"test shapes: kernels == plain versions (tolerance: bitwise; "
        f"max abs err {err})")
    k3_errs = check_flash_attention(ops, ref, flash_attention, dev)

    edges = powerlaw_graph(N_NODES, M_PER_NODE, seed=0)
    if len(edges) != N_EDGES:
        raise AssertionError(f"powerlaw_graph gave {len(edges)} edges, "
                             f"expected {N_EDGES}")
    full = full_width_checks(core, ops, ref, edges, dev)

    reset_counts(peel_wave, bitmap_support, flash_attention)
    t = time.perf_counter()
    g, sec, initial = drive_main_path(core, edges, dev)
    launches = {"peel_wave": peel_wave.LAUNCHES,
                "bitmap_support": bitmap_support.LAUNCHES}
    by_body = {"peel_wave": dict(peel_wave.LAUNCHES_BY_BODY),
               "bitmap_support": dict(bitmap_support.LAUNCHES_BY_BODY)}
    log(f"truss path: {time.perf_counter() - t:.1f} s, launches {launches}, "
        f"by body {by_body}")
    for name, n in launches.items():
        if by_body[name] != {"digest": n, "direct": 0}:
            raise AssertionError(f"{name}: {n} calls on the truss path ran "
                                 f"{by_body[name]}, expected the digest body "
                                 f"in every one")
    t = time.perf_counter()
    final = g.edge_list()
    if g.phi_dict() != core.oracle.scratch_phi(N_NODES, map(tuple, final.tolist())):
        raise AssertionError("final phi differs from a from-scratch oracle")
    log(f"final phi == oracle over {len(final)} edges "
        f"({time.perf_counter() - t:.1f} s); phases {sec}")
    del g
    torch.cuda.empty_cache()

    reset_counts(peel_wave, bitmap_support, flash_attention)
    t = time.perf_counter()
    svc_out = drive_service_path(edges, dev)
    svc_launches = {"peel_wave": peel_wave.LAUNCHES,
                    "bitmap_support": bitmap_support.LAUNCHES}
    svc_by_body = {"peel_wave": dict(peel_wave.LAUNCHES_BY_BODY),
                   "bitmap_support": dict(bitmap_support.LAUNCHES_BY_BODY)}
    log(f"service path: {time.perf_counter() - t:.1f} s, launches "
        f"{svc_launches}, by body {svc_by_body}; {json.dumps(svc_out)}")
    for name, n in svc_launches.items():
        if n <= 0 or svc_by_body[name] != {"digest": n, "direct": 0}:
            raise AssertionError(f"{name}: {n} calls on the service path "
                                 f"ran {svc_by_body[name]}, expected the "
                                 f"digest body in every one (and at least one)")

    # the replica cluster at full width (K1 on the primary, the replicas'
    # applies and the promotion's replay), then the launcher
    reset_counts(peel_wave, bitmap_support, flash_attention)
    t = time.perf_counter()
    cl_out = drive_cluster_path(edges, dev)
    cl_launches = {"peel_wave": peel_wave.LAUNCHES,
                   "bitmap_support": bitmap_support.LAUNCHES}
    cl_by_body = {"peel_wave": dict(peel_wave.LAUNCHES_BY_BODY),
                  "bitmap_support": dict(bitmap_support.LAUNCHES_BY_BODY)}
    log(f"cluster path ({card}): {time.perf_counter() - t:.1f} s, launches "
        f"{cl_launches}, by body {cl_by_body}; {json.dumps(cl_out)}")
    if cl_launches["peel_wave"] <= 0 or cl_by_body["peel_wave"]["direct"] \
            or cl_by_body["bitmap_support"]["direct"]:
        raise AssertionError(f"the cluster path ran {cl_by_body}, expected "
                             f"K1 and the digest body in every call")
    t = time.perf_counter()
    la_out = {"sorted_sizing": sorted_sizing(edges, dev)}
    la_out.update(drive_launcher(dev))
    log(f"launcher path ({card}): {time.perf_counter() - t:.1f} s; "
        f"{json.dumps(la_out)}")

    # the sharded substrate at full width (K1 on each shard's row block, K2
    # on each shard's word slab); the counts are set to 0 inside, after the
    # mesh=None references it is held against
    sh_out = drive_sharded_path(core, edges, dev, initial,
                                (peel_wave, bitmap_support))
    sh_launches = {"peel_wave": peel_wave.LAUNCHES,
                   "bitmap_support": bitmap_support.LAUNCHES}
    sh_by_body = {"peel_wave": dict(peel_wave.LAUNCHES_BY_BODY),
                  "bitmap_support": dict(bitmap_support.LAUNCHES_BY_BODY)}
    log(f"sharded path ({card}): {sh_out['phase_s']:.1f} s, launches "
        f"{sh_launches}, by body {sh_by_body}; {json.dumps(sh_out)}")
    for name, n in sh_launches.items():
        if n <= 0 or sh_by_body[name] != {"digest": n, "direct": 0}:
            raise AssertionError(f"{name}: {n} calls on the sharded path "
                                 f"ran {sh_by_body[name]}, expected the "
                                 f"digest body in every one (and at least one)")

    k3_time = time_flash_attention(ops, ref, flash_attention, dev)

    reset_counts(peel_wave, bitmap_support, flash_attention)
    t = time.perf_counter()
    lm = drive_lm_path(flash_attention, dev)
    wgmma_paths = {f"{LM_ARCH} prefill":
                   flash_attention.LAUNCHES_BY_BODY["wgmma"]}
    log(f"LM path: {time.perf_counter() - t:.1f} s, launches "
        f"{flash_attention.LAUNCHES_BY_BODY}; {json.dumps(lm)}")

    # gemma-2b's prefill (the wgmma body at head dim 256), then its smoke
    # config's (the SIMT body), each path with the counts set to 0 first
    simt_paths = {}
    for smoke, paths in ((False, wgmma_paths), (True, simt_paths)):
        reset_counts(peel_wave, bitmap_support, flash_attention)
        t = time.perf_counter()
        res = drive_gemma_prefill(ops, flash_attention, dev, smoke)
        name = GEMMA_ARCH + (" smoke config" if smoke else "") + " prefill"
        paths[name] = flash_attention.LAUNCHES_BY_BODY[
            "simt" if smoke else "wgmma"]
        log(f"{name} path: {time.perf_counter() - t:.1f} s, launches "
            f"{flash_attention.LAUNCHES_BY_BODY}; {json.dumps(res)}")
    launches["flash_attention_wgmma"] = sum(wgmma_paths.values())
    launches["flash_attention_simt"] = sum(simt_paths.values())
    gm = k3_time["gemma"]
    log(f"K3 at {GEMMA_ARCH}'s layout: the wgmma body {gm['wgmma']:.4f} ms, "
        f"the SIMT body {gm['simt']:.4f} ms in the same call: "
        f"{gm['simt'] / gm['wgmma']:.2f}x")

    from repro_torch.kernels import cin, segment_matmul
    k45_errs = check_recsys_kernels(ops, ref, dev)
    rs = recsys_setup(dev)
    k45_errs.update(check_recsys_path_shapes(ops, ref, rs))
    reset_counts(peel_wave, bitmap_support, flash_attention, segment_matmul,
                 cin)
    t = time.perf_counter()
    rec = drive_recsys_path(rs, dev)
    launches["segment_matmul"] = segment_matmul.LAUNCHES
    launches["cin"] = cin.LAUNCHES
    log(f"recsys path: {time.perf_counter() - t:.1f} s, launches "
        f"segment_matmul {segment_matmul.LAUNCHES}, cin {cin.LAUNCHES}; "
        f"{json.dumps(rec)}")
    if segment_matmul.LAUNCHES != rec["calls"]:
        raise AssertionError(f"K4 launched {segment_matmul.LAUNCHES} times in "
                             f"{rec['calls']} serve and retrieval calls, "
                             f"expected once a call")
    out_errs = check_recsys_outputs(ops, rs, dev)
    k45_time = time_recsys_kernels(ops, ref, rs, dev)
    del rs
    torch.cuda.empty_cache()

    # the dry-run of every cell (phase 16) starts here, a subprocess on its
    # own core with no card visible, and is read in phase 16
    dry_work = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry = start_dryrun(dry_work)

    def stop_dryrun():
        if dry["proc"].poll() is None:
            dry["proc"].kill()
            dry["proc"].wait()
        shutil.rmtree(dry_work, ignore_errors=True)

    atexit.register(stop_dryrun)

    # truss-filtered GCN training (K1 in every round's batch, K4 in every
    # aggregation) and the GNN launcher; the counts are set to 0 inside,
    # just before the path, and read just after it
    tr = drive_training_path(core, edges, dev, card)
    tr_launches = tr["launches"]
    log(f"training path ({card}): {tr['phase_s']:.1f} s, launches "
        f"{tr_launches}, by body {tr['by_body']}; {json.dumps(tr)}")
    if tr_launches["peel_wave"] <= 0 or tr["by_body"]["peel_wave"] != {
            "digest": tr_launches["peel_wave"], "direct": 0}:
        raise AssertionError(f"K1 on the training path: {tr['by_body']}, "
                             f"expected the digest body in every call")
    if tr["by_body"]["bitmap_support"]["direct"]:
        raise AssertionError(f"K2 on the training path ran {tr['by_body']}, "
                             f"expected the digest body in every call")
    if tr_launches["segment_matmul_rounds"] <= 0:
        raise AssertionError("K4 was not launched by the training rounds")
    launches["segment_matmul_training"] = tr_launches["segment_matmul"]
    launches["peel_wave_training"] = tr_launches["peel_wave"]

    # qwen3-0.6b and xDeepFM training through the launcher (K3's wgmma
    # body, K4's gathered entry, K5); the counts are set to 0 inside, just
    # before each run, and read just after it
    lt = drive_lm_recsys_training(dev, card)
    lm_tr = lt["lm"]["by_body"]["flash_attention"]["wgmma"]
    rs_tr = lt["recsys"]["launches"]
    wgmma_paths[f"{LM_ARCH} training"] = lm_tr
    launches["flash_attention_wgmma"] += lm_tr
    launches["segment_matmul_training"] += rs_tr["segment_matmul"]
    launches["cin_training"] = rs_tr["cin"]
    log(f"LM and recsys training ({card}): {lt['phase_s']:.1f} s; "
        f"{json.dumps(lt)}")

    # MoE serving (K3's wgmma body on both archs' prefill, mixtral's in its
    # window mode); the counts are set to 0 inside, just before each arch's
    # prefill calls, and read just after them
    moe = drive_moe_serving(dev, card)
    for arch_id, n_layers, _, _ in MOE_RUNS:
        wgmma_paths[f"{arch_id} prefill ({n_layers} layers)"] = \
            moe["archs"][arch_id]["launches"]["wgmma"]
    launches["flash_attention_wgmma"] += moe["launches"]["wgmma"]
    if moe["launches"]["simt"]:
        raise AssertionError(f"the MoE prefills launched K3's SIMT body "
                             f"{moe['launches']['simt']} times")
    log(f"MoE serving ({card}): {moe['phase_s']:.1f} s; launches "
        f"{moe['launches']}")

    # the cell plans: the dry-run's result, three plans on the card (K3,
    # K4's gathered and rows entries, K5; the counts set to 0 just before
    # each plan's call and read just after it), the expert branches
    plans = drive_plans(dev, card, dry)
    stop_dryrun()
    for cell, r in plans["plans"].items():
        if r["launches"]["flash_attention"]["wgmma"]:
            wgmma_paths[f"{cell} plan"] = r["launches"]["flash_attention"]["wgmma"]
    launches["flash_attention_wgmma"] += plans["launches"]["flash_attention_wgmma"]
    launches["segment_matmul_plans"] = plans["launches"]["segment_matmul"]
    launches["cin_plans"] = plans["launches"]["cin"]
    log(f"cell plans ({card}): {plans['phase_s']:.1f} s; launches "
        f"{plans['launches']}")

    # MoE training at full width (K3's wgmma body on mixtral's AdamW steps
    # and llama4-scout's gradient); the counts are set to 0 inside, just
    # before each arch's run, and read just after it
    mt = drive_moe_training(dev, card)
    for arch_id, r in mt["archs"].items():
        wgmma_paths[f"{arch_id} training (depth {r['layers']})"] = \
            r["launches"]["wgmma"]
    launches["flash_attention_wgmma"] += mt["launches"]["wgmma"]
    if mt["launches"]["simt"]:
        raise AssertionError(f"MoE training launched K3's SIMT body "
                             f"{mt['launches']['simt']} times")
    log(f"MoE training ({card}): {mt['phase_s']:.1f} s; launches "
        f"{mt['launches']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its path")

    sources = {"peel_wave": "src/repro/kernels/peel_wave.py:50",
               "bitmap_support": "src/repro/kernels/bitmap_support.py:41"}
    kernels = []
    # K1/K2: the top-level time is the digest body's (the path's) on a full
    # wave; "bodies" has both bodies in turns, K1 also at 10% and 1% alive,
    # host us a call, and the probe mappings; launches are the truss
    # path's, the service path's, the cluster path's, the sharded path's
    # and the training path's ("path" has each, "cluster_paths" the
    # cluster's by primary, replica, promotion and replay check)
    for name in ("peel_wave", "bitmap_support"):
        f = full[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/bitmap_popcount.cu",
            "replaces": sources[name],
            "launches": launches[name] + svc_launches[name]
            + cl_launches[name] + sh_launches[name] + tr_launches[name],
            "max_abs_err": max(f["err"], err), "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": None,
            "path": {"truss": launches[name],
                     "service": svc_launches[name],
                     "cluster": cl_launches[name],
                     "sharded": sh_launches[name],
                     "training": tr_launches[name]},
            "cluster_paths": {path: by[name]["launches"]
                              for path, by in cl_out["launches"].items()},
            "launches_by_body": {
                body: by_body[name][body] + svc_by_body[name][body]
                + cl_by_body[name][body] + sh_by_body[name][body]
                + tr["by_body"][name][body] for body in by_body[name]},
            "bodies": f["bodies"]})
    kernels[0]["nonzero"] = full["nonzero"]
    kernels[0]["id_check_host_us"] = full["id_check_host_us"]
    # K3's bodies: the top-level times of the wgmma body are at qwen3's
    # [64, 4096, 128], those of the SIMT body at gemma-2b's MQA layout (in
    # turns with the wgmma body there); "layouts" has each body at each
    # layout it was timed at, "path" the paths that launched it
    layouts = {"flat": f"{list(K3_SHAPE)}",
               "gqa": f"{LM_ARCH} prefill and training [{PREFILL_BATCH}, "
                      f"{PREFILL_SEQ}, 16 q / 8 kv, 128]",
               "gemma": f"{GEMMA_ARCH} [{GEMMA_BATCH}, {GEMMA_SEQ}, "
                        f"{GEMMA_HEADS[0]} q / {GEMMA_HEADS[1]} kv, "
                        f"{GEMMA_HEADS[2]}]"}
    for body, main_layout, paths in (("wgmma", "flat", wgmma_paths),
                                     ("simt", "gemma", simt_paths)):
        tm = k3_time[main_layout]
        kernels.append({
            "name": f"flash_attention_{body}", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:83",
            "launches": launches[f"flash_attention_{body}"],
            "max_abs_err": max(k3_errs[body].values()), "ms": tm[body],
            "plain_ms": tm["plain"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1], "library_ms": tm["sdpa"],
            "path": paths,
            "layouts": {layouts[key]: {
                "ms": k3_time[key][body], "plain_ms": k3_time[key]["plain"],
                "bound_ms": k3_time[key]["bound"][0],
                "bound_by": k3_time[key]["bound"][1],
                "library_ms": k3_time[key]["sdpa"]}
                for key in ("flat", "gqa", "gemma")}})
    for key, r in moe["k3"]["layouts"].items():      # the MoE layouts
        kernels[2]["layouts"][r["layout"]] = {
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["sdpa_ms"]}
    kernels[2]["max_abs_err"] = max([kernels[2]["max_abs_err"]] + [
        e for name, e in moe["k3"]["errs"].items() if "SDPA" not in name])
    # K4: the recsys path's entry (declared sorted, the mean fused) at
    # bulk; the sum and sorting entries and the p99 shape under "entries";
    # the training path's rows entry under "training_rows_entry"
    k4 = k45_time["segment_matmul serve_bulk"]
    k4_timing = (k4["ms"]["mean"], k4["ms"]["plain_mean"],
                 k4["ms"]["embedding_bag_mean"], k4["bound_ms"], k4["bound_by"])
    extra_errs = {"segment_matmul": [v["max_abs_err"] for v in
                                     tr["k4_shapes"].values()] + [
        e for a in tr["arch_vs_plain"].values()
        for e in a["k4_max_abs_err"].values()], "cin": []}
    for name, source, replaces, timing in (
            ("segment_matmul", "segment_sum.cu",
             "src/repro/kernels/segment_matmul.py:44", k4_timing),
            ("cin", "cin.cu", "src/repro/kernels/cin.py:46", k45_time["cin"])):
        ms, pms, lms, bms, by = timing
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[name] + launches.get(f"{name}_training", 0)
            + launches[f"{name}_plans"],
            "max_abs_err": max([e for k, e in k45_errs.items()
                                if k.startswith(name)] + extra_errs[name]),
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lms})
    kernels[-2]["path"] = {"recsys": launches["segment_matmul"],
                           "training": tr_launches["segment_matmul"],
                           "recsys training": rs_tr["segment_matmul"],
                           "cell plans": launches["segment_matmul_plans"]}
    kernels[-2]["training_rows_entry"] = tr["k4_shapes"]
    kernels[-2]["gathered_plain_backward_ms"] = \
        lt["cin_backward"]["k4_plain_backward_ms"]
    kernels[-2]["entries"] = {
        shape: {key: k45_time[f"segment_matmul {shape}"]["ms"][key]
                for key in ("sum", "mean", "sorting", "plain", "plain_mean",
                            "embedding_bag_sum", "embedding_bag_mean",
                            "sum_batch_major")}
        | {key: k45_time[f"segment_matmul {shape}"][key]
           for key in ("bound_ms", "sector_ms", "host_us")
           if key in k45_time[f"segment_matmul {shape}"]}
        for shape in ("serve_p99", "serve_bulk")}
    # K5 also: cuBLAS's SGEMM at the same p99 shape, one whole bulk layer-2
    # call, and the GEMM's compile report
    kernels[-1].update({"sgemm_ms": k45_time["cin sgemm_ms"],
                        "bulk_layer2": k45_time["cin bulk layer 2"],
                        "compile": k5_compile,
                        "path": {"recsys": launches["cin"],
                                 "recsys training": rs_tr["cin"],
                                 "cell plans": launches["cin_plans"]},
                        "plain_backward": lt["cin_backward"]})
    # K3's training forward is prefill's GQA layout ("layouts" has it under
    # the prefill name); its backward is plain
    kernels[2]["training"] = lt["attention_backward"]
    log(f"recsys outputs: {json.dumps(out_errs)}")
    log(f"smoke total ({card}): {time.perf_counter() - T_START:.1f} s of "
        f"the 1,200 s limit; phase 13 {tr['phase_s']:.1f} s, phase 14 "
        f"{lt['phase_s']:.1f} s, phase 15 {moe['phase_s']:.1f} s, phase 16 "
        f"{plans['phase_s']:.1f} s (the dry-run {plans['dryrun']['wall_s']:.1f}"
        f" s beside phases 13-15, waited for {plans['dryrun']['waited_s']:.1f}"
        f" s), phase 17 {mt['phase_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
