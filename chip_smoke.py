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
   against the pure-Python oracle; two fused 2,000-update batches, a few
   progressive single updates, one batch with ``engine="recompute"``, one
   more batch of each engine under ``torch.profiler`` (each must show the
   digest body's ``digest_rows`` among its device ops, and every K1 and K2
   call of the path must have run the digest body), then
   ``max_truss``/``k_truss``/``index.query`` checked against a host
   connected-components pass, and a final from-scratch oracle check.  Each
   phi == oracle check of phases 4-6 (``OracleChecks``: ~15 s of pure
   Python each) runs in a worker process from phase 17 on, beside the
   device-bound phases, and is read at the end; one that differs fails
   the smoke there.
5. Drives the WAL-backed truss service on the same graph:
   ``TrussService(support_method="bitmap")`` tracking the slashdot
   config's ``query_ks`` (34, 30, 25, 15) over a ``TrussStore`` in a
   temporary directory (removed at the end).  The constructor (decompose,
   K2, and the baseline snapshot: seconds and bytes); two serial
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
   equal to the oracle (heal seconds).  Every K1 and K2 call of this path
   must run the digest body.
6. Drives the replica cluster on the same graph: a ``bitmap`` primary and
   two ``Replica(support_method="bitmap")`` on the card tailing its store
   (a temporary directory, removed at the end) behind a ``QueryRouter``,
   with ``MixedWorkloadStream`` traffic (read fraction 0.9, zipf 1.1,
   levels 3, 5 and the max truss) for three generations of 1,000 writes
   through a ``Session``.  One read record in 60 goes out ``bounded``
   (bound 2) mid-generation and must be served within 2 generations; at
   each boundary replica-0 applies the generation (K1) and must equal the
   primary bitwise, 40 reads go out ``strong`` (the primary) and
   ``read_your_writes`` (replica-0) with the same answers, and the
   session reads its own last insert and delete.  Replica-1 stays parked
   (within the bound it serves bounded reads; once it lags 3, after the
   last generation, 8 bounded reads must pass it over), then steps up one
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
   ``--trace-jsonl`` and ``--profile-dir``; then ``--router --replicas 2
   --pipeline`` (the ``--restore`` run went to pay for phases 17 and 18's
   deeper steps: phase 5 holds the restore at full width, and
   ``tests/test_torch_serve_truss.py`` the launcher's ``--restore``).
   Every exit code must be 0, every profiled region's trace must hold
   each launch's and copy's device record, and the merged trace (``python
   -m repro_torch.obs.merge``) must join the replicas' applies to the
   router's writes.
8. Drives the sharded substrate at full width on ``make_shard_mesh(S)``
   (every shard on the one card) for S = 4: ``DynamicGraph(...,
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
   ``torch.profiler``, the logits against the plain route, then
   ``DecodeEngine`` serving four 64-token prompts with 16 new tokens each
   (each wave timed), checked against prefill's argmax within a tolerance
   measured from a ``decode_step`` replay of the prompts.  Then the SIMT body's path,
   prefill of ``gemma-2b``'s smoke config (head dim 32, bf16: the SIMT body
   once a layer) on 4 x 1,024 tokens, the logits held against the plain
   route (``gemma-2b`` at full width runs in phase 18).
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
    ``DynamicGraph(support_method="bitmap", tracked_ks=(5,))``, one
    round of a ``GraphUpdateStream`` chunk of 2,000 updates (K1 in its
    fused batch, digest body), followed by the k = 5 truss
    community batched by ``sampler.make_gnn_batch`` (d_feat 1,433, edges
    padded to 4 x 980,614) and 3 AdamW steps (K4 three times a step: the
    degree count and each layer's aggregation; the backward a plain row
    gather; the last step of the last round under ``torch.profiler``).
    Logs each round's apply seconds, community edges, batch-build seconds,
    step ms and losses.  Then ``launch.train.main --full --steps 6`` for
    gcn-cora, gin-tu, meshgraphnet and dimenet, each against 3 steps of
    the launcher's setup cut by the preemption flag and resumed to 6 by
    ``main`` (bitwise; phase 15 runs ``launch.train`` as subprocesses
    whose path holds ``repro_torch`` alone).  The launch counts are read
    there.  Then
    a step's loss and gradients through K4 against ``use_kernels(False)``
    (``step_vs_plain``: loss within 1e-5 of itself, each gradient leaf
    within 1e-4 of its largest magnitude, the plain route replaying the
    card route's relu decisions, each decision taken apart within
    ``RELU_TIE`` of a tie), with K4's rows entry against its plain version
    on the CPU, which sums in K4's order, on every input the step handed
    it: each arch at full config on the launcher's first batch, and the
    truss-filtered step on the last round's batch, whose K4
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
    step seconds, losses (qwen3's first near ln 151,936) and peak device
    memory; the loop's final checkpoint is counted with its bytes and not
    taken (``skipped_checkpoints``: 7.2 and 5.2 GB, ~21 s of host copy and
    write; phase 13's launcher runs and the restart checks hold the loop's
    checkpoints).  Then each card step against
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
    (within half an int8 step of V), bytes and ms of both.  Then ``launch.serve`` and
    ``launch.train --steps 3`` of both MoE archs as four subprocesses at
    once (smoke configs, exit 0, finite losses), ``launch.train`` in
    process on the card and the CPU from the same parameters (first loss
    within ``MOE_LAUNCH_RTOL``; the aux loss nonzero), and K3 at both MoE
    prefill layouts, mixtral's training layout ``[4, 4096]`` (llama4's is
    its prefill's) and a row of each arch's ``prefill_32k`` (``[1,
    32768]``: mixtral's 4,096 window an eighth of it) against its plain
    version and timed beside its bound and
    ``scaled_dot_product_attention``.
16. The cell plans (``launch/specs.py``, ``launch/dryrun.py``).  The
    dry-run of all 36 cells on both production meshes, started as a
    subprocess before phase 13 on a path holding ``repro_torch`` alone,
    with no card visible: exit 0 with 72/72 cells traced, each cell's
    per-device argument GB on both meshes (computed from shapes), matmul
    flops and trace seconds logged.  Four plans run on the card at
    ``make_test_mesh((1, 1))``, each cell's global shape and full config
    (``PLAN_CELLS``): ``qwen3-0.6b/prefill_32k`` (K3's wgmma body once a
    layer, rows 0-1 against a direct ``prefill`` of those rows within
    ``LOGIT_RTOL`` of the largest |logit|), ``xdeepfm/serve_bulk`` (K4
    once, K5 three times), ``xdeepfm/train_batch``'s donated step at
    65,536 rows (K4 once, K5 three times forward; its peak beside phase
    14's launcher run) and ``gcn-cora/full_graph_sm``'s (K4 three times;
    the batch from ``gnn_cell_batch``, as in phase 19), those three
    bitwise against the model's own entry point on the same tensors (a
    train plan steps on a clone of its parameters and optimizer state,
    each leaf of which must keep its storage, against the returning step
    from the originals); each plan's arguments equal to its meta trace's
    shapes, dtypes and ``argument_size_in_bytes``, its outputs to the
    trace's shapes and dtypes, finite; seconds and peak memory logged.
    Then one MoE layer of each MoE arch at full width on ``[1, 8192]``
    over ``make_test_mesh((1, 16))``: mixtral's model-sharded branch (16
    ``d_ff`` slices of 896) within ``BRANCH_FRO`` of ``mesh=None``,
    llama4-scout's expert-parallel branch bitwise, and the same for the
    layer's gradients (``x``, the router, each expert stack); forward and
    backward timed.
17. Trains the two MoE archs at full width (``MOE_TRAIN_RUNS``), each
    through the donated step of its cut ``train_4k`` plan
    (``specs.build_cell`` at ``make_test_mesh((1, 1))``, the stacked
    parameters from ``PLAN_SEED``), its depth cut to the deepest whose
    donated step's 4 fp32 copies of the parameters (params, grads, mu, nu)
    and the update's slices fit in ``TRAIN_FIT`` of the card
    (``depth_cut``, the reckoning printed), the batch of ``train_4k`` cut
    to ``[4, 4096]``: mixtral-8x7b (2 of 32 layers) and
    llama4-scout-17b-a16e (1 of 48) three AdamW steps each (``adamw_steps``:
    step seconds, losses, peak memory, the last step under
    ``torch.profiler``; the loop and its checkpoint run in phase 14).
    After every step each leaf of params, ``mu`` and ``nu`` must keep its
    storage; the peak must stay within the reckoning, the largest stacked
    leaf and the transient the donated steps measured on the card
    (``check_step_peak``; what the process held beside is subtracted).
    The counts are set to 0 just before each arch's steps and read just
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
    where its 4,096 window masks.  Last, mixtral's same-bits gate at 1
    layer (``same_bits_at_cut``): three donated steps equal three
    returning steps from the same seeded start (two inits bitwise equal),
    bitwise.
18. The dense LM family at full width (``DENSE_RUNS``), each arch from one
    seeded initialisation on the card, built, driven and freed in turn:
    starcoder2-7b (LayerNorm, GELU, untied embeddings, 36 q / 4 kv heads
    of 128: a GQA group of 9) at full width and depth, 7,399,047,168
    parameters checked, and gemma-2b (MQA at head dim 256, a 256,000-entry
    tied vocabulary).  Two timed prefill calls (starcoder2 ``[4, 4096]``,
    gemma ``[1, 4096]``: K3's wgmma body once a layer a call, its SIMT
    body never) and one profiled, the logits against the plain route
    within ``LOGIT_RTOL`` of the largest; ``DecodeEngine`` serving 4
    requests of 64 + 16 tokens (each wave timed) with phase 10's
    consistency gates.  Then the first layers of the same parameters at
    the depth cut (``depth_cut``, as in phase 17: starcoder2 17 of 32,
    gemma 18 of 18), stacked, ``train_4k`` cut to ``[4, 4096]``: the first
    step's loss and gradients against ``use_kernels(False)`` (phase 14's
    gates, beside the plain route's own spread with its attention blocks
    halved), then three donated AdamW steps of the cut plan from the same
    parameters and batches (step seconds, losses, peak memory, the last
    step profiled; the first step's loss equal to the checked one; the
    storage and peak gates).  The counts are set to 0 just before each
    arch's prefill and serving and just before its steps, and read just
    after: K3's wgmma body once a layer a prefill call and twice a layer a
    step, its SIMT body, K4 and K5 never.  Then the same-bits gate at 2
    layers of qwen3-0.6b, gemma-2b and starcoder2-7b.  Then
    K3 at starcoder2-7b's layout ``[4, 4096, 36 q / 4 kv, 128]`` and at a
    row of ``prefill_32k`` of starcoder2-7b and of gemma-2b (``[1, 32768,
    8 q / 1 kv, 256]``) against its plain version, timed in turns with
    ``scaled_dot_product_attention`` (causal, ``enable_gqa``) beside its
    bound.
19. The GNN family at its cells' global shapes (``GNN_CELLS``): all four
    archs on ``full_graph_sm`` (gcn-cora's is phase 16's), ``molecule``
    and ``minibatch_lg``, and gcn-cora on ``ogb_products`` (the other
    three cut there, ``OGB_CUT``), each through ``run_plan_on_card``.
    Each cell's batch comes from ``gnn_cell_batch``: a full graph of
    exactly the cell's edges (``full_graph_edges``: the smallest
    ``m_per_node`` that has them), a fanout sample placed with its
    directed edges as they are (``minibatch_sample``,
    ``directed_batch``), or ``make_batched_graphs``.  The two big cells'
    graphs and batches are built by a host process started once the
    kernels are built (``start_host_cells``) and waited for here
    (``HOST_TIMEOUT``; a failure fails the smoke).  Each step: arguments equal to the meta
    trace's bytes, K4 launched ``k4_per_step`` times and K3, K5 never,
    outputs bitwise equal to the model's own step, then ``step_vs_plain``
    with its peak memory; ``PROFILED_CELL``'s step is also profiled and
    K4 timed on its inputs beside ``index_add_`` and the byte bound.
20. The decode cells through their plans (``DECODE_RUNS``): ``decode_32k``
    (``[128, 32768]``) for the five LM archs, qwen3-0.6b, gemma-2b and
    starcoder2-7b at full depth, mixtral-8x7b and llama4-scout at phase
    15's depth cuts, and mixtral-8x7b's ``long_500k`` (``[1, 524288]``, a
    4,096-slot ring) on the same parameters; each arch from one seeded
    initialisation (``stacked_params``).  Each batch is cut to the largest
    whose wave fits in ``TRAIN_FIT`` of the card (``decode_cut``, logged
    with its reckoning), the cache filled with seeded bf16 normal values
    (every slot valid at the cell's last position).  ``decode_cell_on_card``
    holds each cell to its gates: the plan's arguments and outputs against
    its meta trace, finite logits, the wave bitwise equal to a direct
    ``decode_step``, no kernel launch, the logits unmoved by refilling the
    slots past the position (no window), the card against the CPU on the
    first layers and rows (MoE at matched routing), ``rope`` on the card
    within 2e-6 of the CPU's at positions ending at 32,767 and 524,287;
    ``long_500k`` takes 8 waves at its last positions first.  Readings:
    wave ms (median of 5 after a warm-up), the cache and peak GB, the byte
    bound (only the experts the wave chose, only the embedding rows it
    reads), one wave profiled.  Then ``prefill_32k`` (``[32, 32768]``)
    for gemma-2b, starcoder2-7b, mixtral-8x7b and llama4-scout
    (``PREFILL_ARCHS``; qwen3-0.6b's is phase 16's) on the same parameters,
    under the allocator's expandable segments: the batch cut to the largest
    whose call fits in ``TRAIN_FIT`` of the card (``prefill_cut``: the fp32
    parameters, the weight casts and each sequence's peak in a layer, by
    phase; logged with its reckoning), at phase 15's depth for the MoE
    archs, through ``run_plan_on_card``: the cut plan's meta trace against
    the card's arguments and outputs, finite logits, K3's wgmma body once a
    layer and no other kernel (the counts set to 0 just before the call,
    read just after), rows 0-1 against a direct ``prefill``; then
    ``prefill_checks``: the peak within the reckoning and
    ``PREFILL_TRANSIENT_GB``, the first ``DECODE_CPU_LAYERS`` layers at row
    0 against the plain route (MoE at matched routing); the median of
    ``PREFILL_TIMED`` calls, tokens/s, and for ``PREFILL_PROFILED`` one
    call profiled.
21. Fails unless every kernel was launched by its path (K1 and K2 on the
    truss path, on the service path and on the sharded path, K1 on the
    cluster path and the training rounds, K4 on the recsys and training
    paths, K3 and K5 on the LM and recsys training paths too, K3 on the
    MoE prefills and the MoE training, K3, K4 and K5 on the cell plans,
    K3 on the dense family's prefills, serving and training, K4 on the
    GNN cells, K3 on phase 20's prefill cells),
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
# settings), then every GNN arch at full config through the launcher; one
# round of 3 steps (the example runs 6 of 8 rounds of 5): each round and
# each step repeats the same work (4 rounds until phase 17, 2 until phase
# 20's prefill cells took the smoke past 1,200 s on an H100)
TRAIN_ARCH, TRAIN_K, TRAIN_ROUNDS, TRAIN_STEPS = "gcn-cora", 5, 1, 3
TRAIN_CHUNK = 2_000                # updates a round (GraphUpdateStream)
TRAIN_D_FEAT = 1_433               # full_graph_sm's d_feat (GNN_SHAPES)
TRAIN_PAD_EDGES = 4 * N_EDGES      # directed edges padded as the example pads
TRAIN_OPT = {"lr": 1e-2, "total_steps": 60, "warmup_steps": 5}
# the card's step through K4 against the plain route: the loss within
# 1e-5 of itself, each gradient leaf within 1e-4 of the leaf's largest
# magnitude (fp32 sums in another order, over runs of up to ~2M rows)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
# the plain route replays the card route's relu decisions (relu_tape); a
# decision the routes take apart must be a near-tie: its pre-activation
# within 1e-4 of its layer's largest.  K4 sums in index order and the plain
# route in the order index_add_'s atomics land, which moves a pre-activation
# by ~1e-6 of its layer's scale; one flipped unit of meshgraphnet's 15 blocks
# moved a gradient leaf by 1.2e-4 of its largest on full_graph_sm (H100)
RELU_TIE = 1e-4
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
# phases 10, 15 and 18 serve 4 requests of 64 prompt + 16 new tokens on a
# 640-slot cache: the engine feeds a prompt through decode_step, one wave a
# token, and a wave attends over every slot of the cache whatever its
# position, so more prompt waves repeat the same wave (phase 10 served 512 +
# 16 until the smoke with phase 18 took 1,074 s on an H100)
SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_SEQ = 4, 64, 16, 640
# the int8 cache is checked on this arch's engine cache
KV_QUANT_ARCH = "mixtral-8x7b"
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
                  "mixtral_train": (4, 4096, 32, 8, 128, 4096),  # training too
                  # a row of phase 20's prefill_32k: the window at 1/8 of it
                  "mixtral_32k": (1, 32768, 32, 8, 128, 4096),
                  "llama4_32k": (1, 32768, 40, 8, 128, None)}
# Phase 16: the cell plans.  The dry-run of all 36 cells on both production
# meshes as a subprocess (started before phase 13, it runs beside phases
# 13-15), then four plans on the card at each cell's global shape and full
# config, at make_test_mesh((1, 1)), and one MoE layer of each MoE arch at
# full width on phase 15's mixtral shape over a model axis of 16
DRYRUN_CELLS, DRYRUN_TIMEOUT = 72, 900
PLAN_CELLS = (("qwen3-0.6b", "prefill_32k"), ("xdeepfm", "serve_bulk"),
              ("xdeepfm", "train_batch"), ("gcn-cora", "full_graph_sm"))
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
# Phases 17 and 18: training at full width.  Each step is the donating step
# of the cut arch's train_4k plan (specs.build_cell at make_test_mesh((1,
# 1)): make_train_step(..., donate=True)), which holds DONATED_COPIES fp32
# copies of the parameters (params, grads, mu, nu; adamw_update_ writes the
# new params, mu and nu into the old in slices of ADAMW_SLICE elements, at
# most three fp32 slices of temporaries).  Each arch's depth is cut to the
# deepest whose copies and those slices fit in TRAIN_FIT of the card
# (depth_cut); train_4k's [256, 4096] is cut to [4, 4096]
DONATED_COPIES = 4
MOE_TRAIN_RUNS = (("mixtral-8x7b", 4, 4096),               # arch, b, s
                  ("llama4-scout-17b-a16e", 4, 4096))
TRAIN_FIT = 0.8
ADAMW_STEPS = 3
# the peak gate: a step's peak, less what the process held beside the
# parameters before the steps, over its reckoning (depth_cut's), the
# largest stacked leaf (unbind's backward stacks one leaf's per-layer
# gradients into a new [L, ...] tensor at a time, at the end of the
# backward) and the transient a donated step measured above those two
# fails the phase.  The transients (activations, the tied or untied
# embedding's gradient sums, the update's slices) as the first card runs
# of the donated steps read them, rounded up to the next 0.5 GB: gemma-2b
# 1.64, starcoder2-7b 1.25, mixtral-8x7b 3.30, llama4-scout 3.57 GB (NVIDIA
# H100 80GB HBM3, 700 W)
STEP_TRANSIENT_GB = {"gemma-2b": 2.0, "starcoder2-7b": 1.5,
                     "mixtral-8x7b": 3.5, "llama4-scout-17b-a16e": 4.0}
# the same-bits gate: at these cuts (arch: layers) ADAMW_STEPS donated steps
# equal as many returning steps from the same start, bitwise
SAME_BITS_CUTS = {"qwen3-0.6b": 2, "gemma-2b": 2, "starcoder2-7b": 2,
                  "mixtral-8x7b": 1}
# mixtral's extra step: at 4,096 positions its 4,096 window never masks a
# key; at 8,192 the band reaches K3's forward and attention_vjp_ref's
# windowed query blocks
MOE_WINDOW_STEP = (1, 8192)
# the first loss of a run from seeded weights: the untied unembedding gives
# logits of unit scale, ~0.5 above ln(vocab) (tests/test_torch_moe.py)
FIRST_LOSS_GAP = 1.0
# Phase 18: the dense LM family at full width.  Each arch prefills and
# serves at full width and depth from seeded weights, then trains at its
# depth cut (depth_cut): the first layers of the same parameters, stacked;
# train_4k's [256, 4096] cut to [4, 4096]
DENSE_RUNS = (("starcoder2-7b", 4, 4096),   # arch, prefill batch, seq
              ("gemma-2b", 1, 4096))
DENSE_PARAMS = {"starcoder2-7b": 7_399_047_168,   # transformer.param_count
                "gemma-2b": 2_506_170_368}
DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ = 4, 4096
# K3 at starcoder2-7b's layout: a GQA group of 9 (b, s, hq, hkv, dh, window),
# and at a row of phase 20's prefill_32k of each dense arch
DENSE_K3_LAYOUTS = {"starcoder2": (4, 4096, 36, 4, 128, None),
                    "gemma_32k": (1, 32768, 8, 1, 256, None),
                    "starcoder2_32k": (1, 32768, 36, 4, 128, None)}
# Phase 19: the GNN family at its cells' global shapes (GNN_SHAPES), each
# cell through its plan at make_test_mesh((1, 1)) and full config: all four
# archs on full_graph_sm (gcn-cora's runs in phase 16), molecule and
# minibatch_lg, and gcn-cora on ogb_products.  The other three archs are cut
# from ogb_products: gin-tu's first layer gathers [E, 100] raw features
# (49.5 GB, twice), meshgraphnet's edge latents are [E, 128] (63.3 GB each)
# and DimeNet needs ~990M triplets; none fits one H100 without chunking the
# edges, which the reference does not do
GNN_CELLS = tuple((a, c) for c in ("full_graph_sm", "molecule", "minibatch_lg")
                  for a in GNN_ARCHS if (a, c) != ("gcn-cora", "full_graph_sm")
                  ) + (("gcn-cora", "ogb_products"),)
OGB_CUT = {"gin-tu": "its first layer gathers [E, 100] raw features: 49.5 GB, "
                     "twice",
           "meshgraphnet": "its edge latents are [E, 128]: 63.3 GB each",
           "dimenet": "~990M triplets beside [E, 128] edge latents"}
# the cells whose graphs a host process builds from the smoke's start (a
# 232,965-node source graph of ~114.6M draws for minibatch_lg's sample, a
# 2,449,029-node graph of 61,859,140 edges for ogb_products), and how long
# after its start phase 19 waits for it
HOST_CELLS, HOST_TIMEOUT = ("minibatch_lg", "ogb_products"), 900
PROFILED_CELL = ("gcn-cora", "ogb_products")   # profiled, K4 timed on its inputs
TRIANGLE_P = 0.7       # powerlaw_graph's share of new nodes closing a triangle
TRIPLET_FANOUT = 8     # DimeNet's triplet slots an edge (the plans' 8 x E)
# Phase 20: the decode cells through their plans at make_test_mesh((1, 1)):
# decode_32k for the five LM archs, the dense ones at full depth, the MoE
# ones at phase 15's depth cuts (arch, layers; None: full depth), and
# mixtral-8x7b's long_500k (ArchConfig.cells keeps it for mixtral alone).
# Each batch is cut to the largest that fits in TRAIN_FIT of the card
# (decode_cut); the cache is filled with seeded bf16 normal values
DECODE_RUNS = (("qwen3-0.6b", None), ("gemma-2b", None),
               ("starcoder2-7b", None)) + tuple((r[0], r[1]) for r in MOE_RUNS)
DECODE_TIMED = 5         # timed waves after one warm-up (their median)
LONG_WAVES = 8           # long_500k's waves, at the last 8 positions
MASK_BACK = 1024         # the mask check's wave at seq - 1 - MASK_BACK
# rope on the card against the CPU at positions ending at decode_32k's and
# long_500k's last, within the CPU test's bound against the reference
ROPE_ENDS, ROPE_ATOL = (32767, 524287), 2e-6
# the card's decode_step against the CPU's on the same parameters' first
# layers and the cache's first rows (host copies under ~16 GB)
DECODE_CPU_LAYERS = {"dense": 2, "moe": 1}
DECODE_CPU_ROWS = 2
# Phase 20 also runs prefill_32k ([32, 32768]) through its plan for each LM
# arch but qwen3-0.6b (phase 16 runs its), on the decode cells' parameters:
# the batch cut to the largest whose call fits in TRAIN_FIT of the card
# (prefill_cut), the gated call, then PREFILL_TIMED synchronised calls
PREFILL_ARCHS = tuple(a for a, _ in DECODE_RUNS if a != LM_ARCH)
PREFILL_TIMED = 2
PREFILL_PROFILED = ("gemma-2b", "mixtral-8x7b")
# the peak gate: a prefill call's peak, less what the process held beside
# its arguments, within prefill_cut's reckoning and the transient the first
# card runs measured above it, rounded up to the next 0.5 GB (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md section 6): gemma-2b +0.81, starcoder2-7b -0.89,
# mixtral-8x7b -2.22, llama4-scout -4.85 GB.  Negative where the reckoning
# counts more than lives: it counts a layer's weight casts all at once, and
# the MoE layers' three expert casts are used, and freed, one at a time
PREFILL_TRANSIENT_GB = {"gemma-2b": 1.0, "starcoder2-7b": -0.5,
                        "mixtral-8x7b": -2.0, "llama4-scout-17b-a16e": -4.5}
K3_MIN_SEQ = 512     # layers.attention_apply takes K3 from 512 positions
# the first AdamW step's loss against the checked step's (the same function
# of the same tensors), and how far below ln(vocab) a mean loss over
# [4, 4096] uniform random targets may fall: no predictor's expected loss on
# them is below ln(vocab), and the mean's spread is under 2e-2 (logits of
# std up to ~2)
FIRST_STEP_RTOL, FIRST_LOSS_FLOOR = 1e-5, 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator growing its segments in place while the
    block runs (phases 17 and 18, phase 20's prefill cells), its cache
    emptied on the way in and out.  The donated steps at starcoder2-7b's
    17 layers peak at ~85% of the card; with fixed segments the stacked
    gradient's 5.4 GiB found no block in 14 GiB of cached, fragmented free
    space, nor starcoder2-7b's [10, 32768, 18432] GELU input (11.25 GiB)
    in 17.5 GiB at its prefill_32k cut.  The other phases
    keep fixed segments: growing in place maps pages at each new
    allocation after an ``empty_cache``, which they call often."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


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


def oracle_equal(n_nodes: int, edges: np.ndarray, phi: np.ndarray,
                 present: np.ndarray) -> tuple:
    """``{(u, v): phi}`` of a graph's active ``edges`` against
    ``core.oracle.scratch_phi`` of the edge set ``present``: ``(equal,
    seconds)``.  Runs in ``OracleChecks``' worker."""
    from repro_torch.core import oracle

    t = time.perf_counter()
    got = dict(zip(zip(edges[:, 0].tolist(), edges[:, 1].tolist()),
                   phi.tolist()))
    want = oracle.scratch_phi(n_nodes, map(tuple, present.tolist()))
    return got == want, time.perf_counter() - t


class OracleChecks:
    """The truss phases' phi == oracle gates, ~15 s of pure Python each at
    full width, run in one worker process (spawned) while the card's later
    phases keep the host mostly idle: ``submit`` copies a graph's active
    edges and phi and the edge set the smoke tracked to the host, as
    arrays; ``start`` hands every check to the worker (``oracle_equal``);
    ``finish`` waits for them in order, fails at the first whose phi
    differs, and stops the worker."""

    def __init__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pool = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        self.checks, self.futures = [], []

    def submit(self, what: str, graph, present) -> None:
        act = graph.state.active.cpu().numpy()
        self.checks.append((what, (
            N_NODES, graph.state.edges.cpu().numpy()[act],
            graph.state.phi.cpu().numpy()[act],
            np.array(list(present), dtype=np.int64).reshape(-1, 2))))

    def start(self) -> None:
        self.futures += [(what, self.pool.submit(oracle_equal, *args))
                         for what, args in self.checks]
        self.checks = []

    def finish(self) -> dict:
        out = {}
        try:
            self.start()
            for what, fut in self.futures:
                equal, out[what] = fut.result()
                if not equal:
                    raise AssertionError(f"{what}: phi differs from the "
                                         f"oracle")
        finally:
            self.pool.shutdown(cancel_futures=True)
        return out


def drive_main_path(core, edges: np.ndarray, dev, oracle: OracleChecks):
    """The port's main path at full width; returns the graph, the seconds
    of each phase and the initial decomposition (spec, phi, stats), which
    phase 8 holds its sharded decompositions against.  The initial phi
    goes to ``oracle``."""
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
    oracle.submit("initial phi", g, present)

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

    for i in range(2):
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
# serial generations before the queries (4 until the decode cells of phase
# 20 took the smoke past 1,000 s on an H100)
SERVICE_GENS = 2
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


def drive_service_path(edges: np.ndarray, dev, oracle: OracleChecks) -> dict:
    """The WAL-backed ``TrussService`` at full width, in a temporary store
    removed at the end; returns its readings.  The restored and the healed
    phi go to ``oracle``."""
    from repro_torch import service
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
        oracle.submit("the service's restored phi", back.graph, present)
        log(f"service restore == live bitwise; WAL == the {len(acked)} acked "
            f"writes; phi to the oracle check")
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
        oracle.submit("the service's healed phi", heal.graph, present)
        out["heal"] = {"heal_s": heal_s, "gen": st["gen"]}
        log(f"service heal: {json.dumps(out['heal'])}; healed == replay "
            f"bitwise; phi to the oracle check")
        replay.store.close()
        del heal, replay
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


CLUSTER_WRITES = 1000         # a generation of the mixed workload's writes
CLUSTER_GENS = 3              # generations the router drives
CLUSTER_BOUND = 2             # staleness bound of the bounded reads
CLUSTER_READ_STRIDE = 60      # one read record in this many goes out bounded
CLUSTER_BOUNDARY_READS = 40   # read records asked at each boundary, strong
                              # and read-your-writes each
CLUSTER_PARKED_UNTIL = 3      # replica-1 steps up to this generation only
CLUSTER_PARKED_READS = 8      # bounded reads after the last generation,
                              # replica-1 lagging past the bound (a fourth
                              # generation showed it until phase 20's
                              # prefill cells needed the time)
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


def drive_cluster_path(edges: np.ndarray, dev, oracle: OracleChecks) -> dict:
    """A ``bitmap`` primary and two replicas on the card behind a
    ``QueryRouter``, driven by the mixed workload at full width, then the
    primary's loss and a promotion; returns the readings and the K1/K2
    launches by path (``primary``, ``replica``, ``promotion``,
    ``replay_check``); the promoted primary's phi goes to ``oracle``."""
    from repro_torch import cluster, service
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
        # replica-1, parked at gen 0, lags CLUSTER_GENS > CLUSTER_BOUND now:
        # bounded reads must pass it over (the router round-robins over the
        # replicas within the bound, so it would serve every other one)
        if r1.gen != 0 or primary.gen <= CLUSTER_BOUND:
            raise AssertionError(f"replica-1 at gen {r1.gen}, the primary at "
                                 f"{primary.gen}: no lag past the bound")
        resps = [route(rec, "bounded") for rec in held[:CLUSTER_PARKED_READS]]
        out["parked_reads"] = [(r.served_by, primary.gen - r.gen) for r in resps]
        if len(resps) < CLUSTER_PARKED_READS or any(
                r.served_by == "replica-1" or primary.gen - r.gen > CLUSTER_BOUND
                for r in resps):
            raise AssertionError(f"bounded reads with replica-1 "
                                 f"{primary.gen} generations behind went to "
                                 f"(node, lag) {out['parked_reads']}")

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
            f"and node {json.dumps(out['lag_gens'])}; with replica-1 "
            f"{CLUSTER_GENS} behind, bounded reads went to (node, lag) "
            f"{out['parked_reads']}")

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
        oracle.submit("the promoted primary's phi", new.graph, present)
        # replica-1 tails the promoted primary
        _counted(launches, "replica", r1.poll)
        same_state(new.graph.state, r1.svc.graph.state,
                   "replica-1 vs the promoted primary")
        log(f"cluster promotion: {out['promotion_s']:.2f} s, replica-0 "
            f"(most caught up) at gen {new.gen}; == a replay of the whole "
            f"WAL bitwise ({out['replay_check_s']:.1f} s); WAL == the "
            f"{len(acked)} acked writes; phi to the oracle check; "
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


# ticks of the primary's launcher run and of the router's: each repeats the
# same ingest, flush and queries (3 each until the prefill cells of phase
# 20 needed the time); the router's replicas apply a generation once its
# writes pass --flush-every 8, which its 64-record ticks (~6 writes) reach
# in the second
LAUNCHER_TICKS = {"primary": 1, "router": 2}
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
    then ``--router --replicas 2 --pipeline``.  Checks the exit codes,
    every profiled region's device records and the merged trace's
    joins."""
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
            common + ["--store", store, "--ticks",
                      str(LAUNCHER_TICKS["primary"]),
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

        _, text, out["router_s"] = run_launcher(
            common + ["--store", os.path.join(work, "store2"), "--router",
                      "--replicas", "2", "--pipeline", "--ticks",
                      str(LAUNCHER_TICKS["router"]), "--chunk", "64",
                      "--flush-every",
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
# shard counts on the one card (2 and 4 until phase 20's prefill cells
# needed the time: each count runs the same engines over its own slabs,
# and the CPU tests hold S = 1, 2, 4 and 8)
SHARD_COUNTS = (4,)
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


def uncounted_params(cfg) -> int:
    """Elements of an LM's parameters that ``transformer.param_count``
    leaves out: the qk-norm scales, the final norm's scale and, with
    LayerNorm, the bias of the final norm and of each layer's two norms
    (``param_count`` counts each layer's two norm scales, and the untied
    unembedding beside the embedding)."""
    bias = cfg.norm == "layernorm"
    return (cfg.n_layers * 2 * cfg.head_dim * cfg.qk_norm
            + cfg.d_model * (1 + bias) + bias * cfg.n_layers * 2 * cfg.d_model)


def lm_fixed_bytes(cfg) -> tuple:
    """An LM's bytes on the card whatever its batch: the fp32 parameters
    (``uncounted_params`` included), and the bf16 weight casts of a call
    (one layer's weights, each cast where it is used, and the
    unembedding's)."""
    from repro_torch.models import transformer

    layer = transformer.param_count(dataclasses.replace(cfg, n_layers=1)) - \
        transformer.param_count(dataclasses.replace(cfg, n_layers=0))
    return (4 * (transformer.param_count(cfg) + uncounted_params(cfg)),
            2 * (layer + cfg.vocab * cfg.d_model))


def check_param_count(cfg, params, expect: int | None = None) -> int:
    """The elements of every leaf of ``params`` less ``uncounted_params``
    must equal ``transformer.param_count(cfg)`` (and ``expect``); returns
    the elements of every leaf."""
    from repro_torch.models import transformer

    n_total = sum(x.numel() for x in _leaves(params))
    count, uncounted = transformer.param_count(cfg), uncounted_params(cfg)
    if n_total - uncounted != count or expect not in (None, count):
        raise AssertionError(f"{cfg.name}: {n_total:,} parameters - "
                             f"{uncounted:,} (qk-norm scales, the final norm,"
                             f" LayerNorm biases) != param_count {count:,} "
                             f"(expected {expect})")
    return n_total


def lm_prefill(fa, cfg, params, tokens, body: str = "wgmma") -> tuple:
    """One synchronised prefill call: ``(logits, seconds)``.  Where the
    prompt takes K3 (``K3_MIN_SEQ`` positions or more) its ``body`` must
    launch once a layer and the other body never; below, neither; the
    logits ``[B, vocab]`` and finite."""
    from repro_torch.models import transformer

    by_body = dict(fa.LAUNCHES_BY_BODY)
    t = time.perf_counter()
    logits = transformer.prefill(cfg, params, tokens)
    sync(tokens.device)
    dt = time.perf_counter() - t
    n = cfg.n_layers if tokens.shape[1] >= K3_MIN_SEQ else 0
    want = {b: n if b == body else 0 for b in by_body}
    ran = {b: c - by_body[b] for b, c in fa.LAUNCHES_BY_BODY.items()}
    if ran != want:
        raise AssertionError(f"{cfg.name} prefill {list(tokens.shape)} "
                             f"launched K3's bodies {ran}, expected {want}")
    if logits.shape != (tokens.shape[0], cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} prefill logits "
                             f"{tuple(logits.shape)} not finite or of the "
                             f"wrong shape")
    return logits, dt


def prefill_vs_plain(ops, cfg, params, tokens, logits=None) -> dict:
    """The same prefill through ``use_kernels(False)`` (the chunked plain
    attention): the largest |logit difference| within ``LOGIT_RTOL`` of
    the largest |logit|.  ``logits`` are the kernel route's, computed here
    when not given.  An MoE model is compared at matched routing: the
    kernel route runs (again) under ``layer_routes``, the plain route
    replays its expert choices, and each route's own choices at those
    inputs may differ only within ``ROUTE_TIE_GAP`` of a tie; its dropped
    slots by layer are returned too."""
    from repro_torch.models import layers, transformer

    moe = bool(cfg.moe_experts)

    def routes(replay=None):
        return layer_routes(layers, params, replay) if moe else \
            contextlib.nullcontext()

    if moe or logits is None:
        with routes() as tape_k:
            logits = transformer.prefill(cfg, params, tokens)
    replay = (lambda i, j: tape_k.routes[i][j].gate_idx) if moe else None
    ops.use_kernels(False)
    try:
        with routes(replay) as tape_p:
            plain = transformer.prefill(cfg, params, tokens)
    finally:
        ops.use_kernels(True)
    dmax = float((logits - plain).abs().max())
    lmax = float(plain.abs().max())
    out = {"dlogit": dmax, "largest_logit": lmax}
    if moe:
        out["routing"] = route_differences(tape_k.forward, tape_p.forward)
        out["drops_by_layer"] = [int((~r.keep).sum()) for r in tape_k.forward]
    log(f"{cfg.name} prefill {list(tokens.shape)} vs the plain route"
        f"{' at matched routing' if moe else ''}: max |logit difference| "
        f"{dmax:.4g} (largest |logit| {lmax:.4g}; limit {LOGIT_RTOL:g} x that"
        f" = {LOGIT_RTOL * lmax:.4g}); argmax {logits.argmax(-1).tolist()} vs "
        f"{plain.argmax(-1).tolist()}" + (
            f"; on each route's own choices {out['routing']['differ']} of "
            f"{out['routing']['decisions']} (token, choice) decisions differ,"
            f" largest gap from a tie {out['routing']['max_gap']:.3g} (limit "
            f"{ROUTE_TIE_GAP}); dropped slots a layer {out['drops_by_layer']}"
            f" of {tokens.numel() * cfg.moe_top_k}" if moe else ""))
    if not dmax <= LOGIT_RTOL * lmax:
        raise AssertionError(f"{cfg.name} prefill differs from the plain "
                             f"route by {dmax} > {LOGIT_RTOL} x {lmax}")
    if moe:
        check_route_gaps(out["routing"], f"{cfg.name} prefill, kernel vs "
                                         f"plain route")
    return out


def engine_waves(cfg, params, prompts: np.ndarray, new: int, max_seq: int,
                 dev) -> tuple:
    """``DecodeEngine`` serving ``prompts`` (``[slots, P]``) with ``new``
    tokens each, each wave timed (one host read a wave): ``(engine, the
    finished requests by id, wave ms)``; fails unless every request got
    its ``new`` tokens."""
    from repro_torch.serving import DecodeEngine, Request

    eng = DecodeEngine(cfg, params, batch_slots=len(prompts),
                       max_seq=max_seq, device=dev)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.tolist(), max_new=new))
    wave_ms = []
    while True:
        t = time.perf_counter()
        if eng.step() == 0:          # each wave reads its tokens to the host
            break
        wave_ms.append(1e3 * (time.perf_counter() - t))
    done = sorted(eng.finished, key=lambda r: r.rid)
    if len(done) != len(prompts) or any(len(r.out) != new for r in done):
        raise AssertionError(f"{cfg.name}: the engine did not finish every "
                             f"request")
    return eng, done, wave_ms


def serve_dense(fa, cfg, params, prompts: np.ndarray, new: int, max_seq: int,
                dev, profile_tail: int = 0) -> dict:
    """``DecodeEngine`` serving ``prompts`` (``[slots, P]``) with ``new``
    tokens each, each wave timed (one host read a wave); then the
    consistency gates: ``decode_step``'s replay of the prompts against
    prefill's logits at ``P`` within ``LOGIT_RTOL`` of the largest |logit|
    (the last ``profile_tail`` replay steps under the profiler), and each
    request's first token equal to prefill's argmax unless prefill's top-2
    margin is under twice that gap (a bf16 near-tie)."""
    from repro_torch.models import transformer

    slots, plen = prompts.shape
    eng, done, wave_ms = engine_waves(cfg, params, prompts, new, max_seq, dev)
    cache_mb = sum(t.numel() * t.element_size()
                   for t in eng.cache.values()) / 1e6
    serve_s = sum(wave_ms) / 1e3
    out = {"waves": len(wave_ms), "serve_s": serve_s,
           "wave_ms": 1e3 * serve_s / len(wave_ms),
           "wave_ms_p50": float(np.median(wave_ms)),
           "wave_ms_max": max(wave_ms), "decode_tok_s": slots * new / serve_s,
           "cache": list(eng.cache["k"].shape), "cache_mb": cache_mb}
    log(f"{cfg.name} serve: {slots} requests x ({plen} prompt + {new} new) "
        f"tokens, cache {out['cache']} bf16 x2 = {cache_mb:.0f} MB: "
        f"{serve_s:.2f} s, {len(wave_ms)} waves ({out['wave_ms']:.2f} ms "
        f"each, p50 {out['wave_ms_p50']:.2f}), {out['decode_tok_s']:.1f} new "
        f"tokens/s, {slots * len(wave_ms) / serve_s:.0f} tokens/s through "
        f"decode_step")
    del eng
    ptoks = torch.from_numpy(prompts).to(dev)
    logits_p, _ = lm_prefill(fa, cfg, params, ptoks)
    cache = transformer.init_cache(cfg, slots, plen, device=dev)
    logits_d = None

    def replay(positions):
        nonlocal logits_d
        for pos in positions:
            logits_d, _ = transformer.decode_step(cfg, params, cache,
                                                  ptoks[:, pos], pos)

    replay(range(plen - profile_tail))
    if profile_tail:
        out["decode_busy"] = profiled(
            lambda: replay(range(plen - profile_tail, plen)))
    dmax = float((logits_d - logits_p).abs().max())
    lmax = float(logits_p.abs().max())
    tol = 2 * dmax
    top2 = logits_p.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    argmax_p = logits_p.argmax(-1).tolist()
    first = [r.out[0] for r in done]
    agree = sum(a == b for a, b in zip(first, argmax_p))
    log(f"{cfg.name} consistency: max |prefill - decode_step replay| logit "
        f"= {dmax:.4g} (largest |logit| {lmax:.4g}; limit {LOGIT_RTOL:g} x "
        f"that = {LOGIT_RTOL * lmax:.4g}); argmax tolerance 2x the gap = "
        f"{tol:.4g}; prefill top-2 margins {[round(m, 4) for m in margins]}; "
        f"first tokens {first}, prefill argmax {argmax_p}: {agree}/{slots} "
        f"agree; replay argmax {logits_d.argmax(-1).tolist()}")
    if not dmax <= LOGIT_RTOL * lmax:
        raise AssertionError(f"{cfg.name}: decode_step replay differs from "
                             f"prefill by {dmax} > {LOGIT_RTOL} x {lmax}")
    for f, a, m in zip(first, argmax_p, margins):
        if f != a and m >= tol:
            raise AssertionError(f"{cfg.name}: first token {f} != prefill "
                                 f"argmax {a} at top-2 margin {m} >= {tol}")
    out.update(dlogit=dmax, largest_logit=lmax, agree=agree, margins=margins)
    del cache
    torch.cuda.empty_cache()
    return out


def drive_lm_path(ops, fa, dev) -> dict:
    """Prefill and serving of ``qwen3-0.6b`` at full width and depth, seeded
    random weights on the card, the prefill's logits against the plain
    route; returns the path's metrics."""
    from repro_torch.models import transformer

    cfg = model_cfg(LM_ARCH)
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(dev).manual_seed(0))
    sync(dev)
    n_total = check_param_count(cfg, params, PARAM_COUNT)
    log(f"{LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"param_count {PARAM_COUNT:,} (+ {uncounted_params(cfg):,} "
        f"qk-norm and final-norm scales = {n_total:,} tensors' elements), "
        f"init {time.perf_counter() - t:.1f} s")

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ))).to(dev)
    n_tok = PREFILL_BATCH * PREFILL_SEQ
    out = {}
    for i in range(2):
        logits, dt = lm_prefill(fa, cfg, params, tokens)
        log(f"prefill [{PREFILL_BATCH}, {PREFILL_SEQ}] call {i}: {dt:.3f} s, "
            f"{n_tok / dt:,.0f} tokens/s, logits finite, K3's wgmma body "
            f"launched {cfg.n_layers} times, its SIMT body never")
    out["prefill_s"], out["prefill_tok_s"] = dt, n_tok / dt
    out["prefill_busy"] = profiled(lambda: lm_prefill(fa, cfg, params, tokens))
    out["vs_plain"] = prefill_vs_plain(ops, cfg, params, tokens, logits)
    del tokens, logits
    torch.cuda.empty_cache()

    prompts = rng.integers(1, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT))
    out.update(serve_dense(fa, cfg, params, prompts, SERVE_NEW,
                           SERVE_MAX_SEQ, dev, profile_tail=8))
    del params
    torch.cuda.empty_cache()
    return out


def drive_simt_prefill(ops, fa, dev) -> dict:
    """The SIMT body's model path: prefill of ``gemma-2b``'s smoke config
    (4 query heads over one KV head of 32, bf16) on 4 x 1,024 tokens, two
    calls (K3's SIMT body once a layer, the wgmma body never), the logits
    against the plain route."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(GEMMA_ARCH).smoke
    if fa.body_for(torch.bfloat16, cfg.head_dim) != "simt":
        raise AssertionError(f"{cfg.name}: bf16 at head dim {cfg.head_dim} "
                             f"does not pick the SIMT body")
    params = transformer.init_params(cfg, torch.Generator(dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (SIMT_BATCH, SIMT_SEQ))).to(dev)
    for i in range(2):
        logits, dt = lm_prefill(fa, cfg, params, tokens, body="simt")
        log(f"{cfg.name} prefill [{SIMT_BATCH}, {SIMT_SEQ}] call {i}: "
            f"{dt:.3f} s, K3's SIMT body launched {cfg.n_layers} times, its "
            f"wgmma body never")
    out = {"prefill_s": dt, "prefill_tok_s": SIMT_BATCH * SIMT_SEQ / dt}
    out.update(prefill_vs_plain(ops, cfg, params, tokens, logits))
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
    step handed it (``plain_in_index_order``), within ``K4_TOL``; the
    elements that differ at all are counted.  Returns the errors and those
    inputs."""
    from repro_torch.training import optimizer as opt

    with k4_inputs(ops) as seen, relu_tape() as tape:
        loss_k, grads_k = opt.value_and_grad(loss_fn, params, batch)
    if not seen:
        raise AssertionError(f"{what}: the step handed K4 nothing")
    ops.use_kernels(False)
    try:
        with relu_tape(tape) as replayed:
            loss_p, grads_p = opt.value_and_grad(loss_fn, params, batch)
    finally:
        ops.use_kernels(True)
    if replayed["tie"] > RELU_TIE:
        raise AssertionError(f"{what}: the routes take {replayed['apart']} "
                             f"relu decisions apart, one at "
                             f"{replayed['tie']} of its layer's largest "
                             f"pre-activation (near-ties: {RELU_TIE})")
    loss_err = abs(float(loss_k) - float(loss_p))
    loss_error(loss_k, loss_p, what, TRAIN_LOSS_RTOL)
    grad_errs = leaf_errors(grads_k, grads_p, what, TRAIN_GRAD_RTOL, "max")
    k4_errs, unequal = {}, 0
    with torch.no_grad():
        for (msgs, ids, n), plain in zip(seen, plain_in_index_order(ref, seen)):
            shape = f"[{msgs.shape[0]}, {msgs.shape[1]}] -> {n}"
            tol = K4_TOL[msgs.dtype]
            got, plain = ops.segment_matmul(msgs, ids, n), plain.to(msgs.device)
            err = check_close(got, plain, tol,
                              f"{what}: K4 rows entry {shape}", rtol=tol)
            k4_errs[shape] = max(err, k4_errs.get(shape, 0.0))
            unequal += int((got != plain).sum())
    return {"loss": float(loss_k), "plain_loss": float(loss_p),
            "loss_abs_err": loss_err, "grad_rel_err": grad_errs,
            "k4_max_abs_err": k4_errs, "k4_unequal_elements": unequal,
            "relu_apart": replayed["apart"], "relu_tie": replayed["tie"]}, seen


@contextlib.contextmanager
def relu_tape(replay: dict | None = None):
    """The relu decisions of the GNN models' MLPs (``gnn._mlp_apply``), in
    call order: recorded, or, given a recorded tape, replayed: each relu
    takes the recorded decision (``where(mask, z, 0)``, whose gradient is
    the mask, as relu's is), and the decisions that differ from ``z``'s own
    are counted (``apart``) with the largest ``|z|`` among them over its
    layer's largest (``tie``).  A replay must make as many relu calls as
    the recording."""
    from repro_torch.models import gnn

    inner = gnn._mlp_apply
    tape = {"masks": [], "apart": 0, "tie": 0.0}
    recorded = None if replay is None else iter(replay["masks"])

    def relu(z):
        if recorded is None:
            tape["masks"].append((z > 0).detach())
            return torch.relu(z)
        mask = next(recorded)
        apart = (z > 0) != mask
        if bool(apart.any()):
            zd = z.detach().abs()
            tape["apart"] += int(apart.sum())
            tape["tie"] = max(tape["tie"], float(zd[apart].max() / zd.max()))
        return torch.where(mask, z, torch.zeros((), dtype=z.dtype,
                                                device=z.device))

    def mlp(p, x, act=torch.relu, final_act=False):
        if act is not torch.relu:
            raise AssertionError("relu_tape: an MLP with another activation")
        return inner(p, x, act=relu, final_act=final_act)

    gnn._mlp_apply = mlp
    try:
        yield tape
    finally:
        gnn._mlp_apply = inner
    if recorded is not None and next(recorded, None) is not None:
        raise AssertionError("relu_tape: the replay made fewer relu calls "
                             "than the recording")


def plain_in_index_order(ref, seen) -> list:
    """The plain version of K4's rows entry on each input of ``seen``,
    computed on the CPU, whose ``index_add_`` sums each segment's rows in
    index order in fp32: the order K4 sums them in.  The card's
    ``index_add_`` adds them in the order its atomics land, which on a
    long run of unit-scale rows that cancel moves a sum by more than
    ``K4_TOL`` (1.6e-5 over node 0's ~300 rows of 1,433 raw features on
    an H100).  One host thread an input, one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(len(seen)) as pool:
            return list(pool.map(lambda s: ref.segment_matmul_ref(
                s[0].cpu(), s[1].cpu(), s[2]), seen))
    finally:
        torch.set_num_threads(threads)


def check_arch_steps(ops, ref, dev) -> dict:
    """``step_vs_plain`` for each GNN arch at full config on the launcher's
    first batch (``train.setup``).  The graph readouts run in phase 19, on
    the molecule cell's plan."""
    from repro_torch.launch import train

    out = {}
    for arch_id in GNN_ARCHS:
        s = train.setup(arch_id, steps=1, ckpt=os.devnull, full=True,
                        device=str(dev))
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in s.stream.next().items()}
        out[arch_id], _ = step_vs_plain(ops, ref, s.loss, s.init(), batch,
                                        f"{arch_id} --full")
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


def _k4_training_shapes(ops, ref, seen, errs: dict, n_real: int | None,
                        dev) -> dict:
    """K4's rows entry on the inputs one training step handed it (GCN's
    degree count and the two layers' messages), timed in turns with its
    plain version and ``index_add_`` (CUDA events, median), beside its
    byte bound from these inputs, with the longest run of one id; and,
    unless ``n_real`` is None, on the community's own rows alone (the
    first ``n_real``, the padding being a suffix), beside theirs."""
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
        b_ms, by = bound(e, d, n)
        out[shape] = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                      "library_ms": ms["index_add_"], "bound_ms": b_ms,
                      "bound_by": by,
                      "max_abs_err": errs[f"{shape} -> {n}"],
                      "largest_run": hub}
        if n_real is not None:
            real_m, real_ids = msgs[:n_real].contiguous(), ids[:n_real]
            out[shape].update(
                community_rows=n_real, community_bound_ms=bound(n_real, d, n)[0],
                community_ms=in_turns({"kernel": lambda: ops.segment_matmul(
                    real_m, real_ids, n)}, reps=10)["kernel"])
    return out


def drive_training_path(core, edges: np.ndarray, dev, card: str) -> dict:
    """Phase 13: the truss-filtered GCN rounds, then each GNN arch at full
    config through the launcher (in process, a restart check each); the
    launch counts are read just after them.  Then each arch's step and the truss-filtered
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


@contextlib.contextmanager
def skipped_checkpoints(checkpoint):
    """Each checkpoint the loop takes while inside counted, with the bytes
    of its tensors, and neither copied to the host nor written: the loop
    calls ``_host_copy`` and then ``save`` on its writer, and both are
    replaced."""
    got = {"skipped": 0, "bytes": []}
    copy, save = checkpoint._host_copy, checkpoint.save

    def no_copy(tree):
        got["bytes"].append(sum(x.numel() * x.element_size()
                                for x in _leaves(tree)
                                if isinstance(x, torch.Tensor)))

    def no_save(path, tree, step=None):
        got["skipped"] += 1

    checkpoint._host_copy, checkpoint.save = no_copy, no_save
    try:
        yield got
    finally:
        checkpoint._host_copy, checkpoint.save = copy, save


def counted_training(name: str, run, dev, mods) -> tuple:
    """``run()``, a training run on the card that returns ``{"history":
    ...}``, with every kernel count set to 0 just before it and read just
    after; the step seconds, losses, peak device memory and its one final
    checkpoint, counted by ``skipped_checkpoints`` and not taken.  Returns
    the record and what ``run`` returned."""
    from repro_torch.training import checkpoint

    reset_counts(*mods)
    torch.cuda.reset_peak_memory_stats(dev)
    with skipped_checkpoints(checkpoint) as ck:
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
    if not np.all(np.isfinite(rec["loss"])) or len(ck["bytes"]) != 1:
        raise AssertionError(f"{name}: {json.dumps(rec)}")
    return rec, res


def train_through_launcher(arch_id: str, args: list, work: str, dev,
                           mods) -> dict:
    """``launch.train.main(["--arch", arch_id, "--full", *args])`` through
    ``counted_training``, its checkpoint path in ``work``."""
    from repro_torch.launch import train

    path = os.path.join(work, f"{arch_id}.npz")
    rec, res = counted_training(
        f"{arch_id} --full", lambda: train.main(
            ["--arch", arch_id, "--full", *args, "--device", str(dev),
             "--ckpt", path]), dev, mods)
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
    ``params["layers"]``, a list or a plan's stacked leaves (``i`` counts
    its MoE layers; a dense model has none).  Each call is keyed by its
    layer, found by the router leaf's storage (``value_and_grad`` hands the
    loss detached views of the same storage), and by its count within that
    layer, not by call order: under
    the per-layer ``checkpoint`` a layer is called again in the backward,
    in reverse layer order, and each decode step calls every layer once.
    Each call's own routing is recorded on the yielded ``LayerRoutes``.
    With ``replay`` (``replay(i, j)``: a ``gate_idx``), the ``j``-th call
    of layer ``i`` routes by ``replay(i, j)``; its own choice at those
    inputs is still computed (without a gradient) and recorded."""
    from repro_torch.models import transformer

    orig = layers.moe_route
    if isinstance(params["layers"], dict):       # a plan's stacked layers
        params = transformer.unstack_layers(params)
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
    decode attention, each layer's max abs error within half an int8 step
    of the largest V row it reads (its scale / 2: the most V's rounding can
    move a convex mix of V rows); bytes and CUDA-event ms of both."""
    from repro_torch.serving import kv_quant

    kq, ks = kv_quant.quantize_kv(cache["k"])
    vq, vs = kv_quant.quantize_kv(cache["v"])
    c = cache["k"].shape[2]
    valid = torch.arange(c, device=dev) < pos
    q = torch.randn((cache["k"].shape[1], cfg.n_heads, cfg.head_dim),
                    generator=torch.Generator(dev).manual_seed(7), device=dev)
    errs, half_steps = [], []
    for i in range(cfg.n_layers):
        layer = {"kq": kq[i], "ks": ks[i], "vq": vq[i], "vs": vs[i]}
        got = kv_quant.attend_quant(q, layer, valid, cfg.n_kv, cfg.head_dim)
        exp = decode_attention(q, cache["k"][i], cache["v"][i], valid,
                               cfg.n_kv)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"attend_quant layer {i}: not finite")
        errs.append(float((got - exp).abs().max()))
        half_steps.append(float(vs[i][:, :pos].max()) / 2)
        if not errs[i] <= half_steps[i]:
            raise AssertionError(f"attend_quant layer {i} differs from the "
                                 f"bf16 decode attention by {errs[i]} > "
                                 f"half an int8 step of V, {half_steps[i]}")
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
            "max_abs_err": max(errs), "errs_by_layer": errs,
            "v_half_step_by_layer": half_steps,
            "int8_bytes": nbytes(kq, ks, vq, vs),
            "bf16_bytes": nbytes(cache["k"], cache["v"]),
            "attend_quant_ms": [t[0], t[3]], "bf16_attention_ms": [t[1], t[2]]}


def serve_moe(cfg, params, dev, rng) -> dict:
    """``DecodeEngine``: ``SERVE_SLOTS`` requests of ``SERVE_PROMPT`` prompt
    and ``SERVE_NEW`` new tokens, each wave timed; then ``decode_step``'s
    replay of the prompts against prefill's logits at the
    prompt length, row by row (a request's prompt routes per row; decode
    never drops, its capacity is 1).  The replay takes the expert choices
    of a prefill at the drop-free capacity (``cap = s``), the function
    decode computes, and is held within ``LOGIT_RTOL`` of it on every row,
    decode's own choices differing only within ``ROUTE_TIE_GAP`` of a tie;
    it is held to the configured prefill (capacity factor 1.25) on the
    rows where that dropped no token, and each row's drops are logged."""
    from repro_torch.models import layers, transformer

    prompts = rng.integers(1, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT))
    eng, _, wave_ms = engine_waves(cfg, params, prompts, SERVE_NEW,
                                   SERVE_MAX_SEQ, dev)
    out = {"waves": len(wave_ms), "wave_ms_p50": float(np.median(wave_ms)),
           "wave_ms_max": max(wave_ms), "wave_ms_first": wave_ms[0],
           "serve_s": sum(wave_ms) / 1e3,
           "new_tok_s": SERVE_SLOTS * SERVE_NEW / (sum(wave_ms) / 1e3),
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
    cache = transformer.init_cache(cfg, SERVE_SLOTS, SERVE_PROMPT,
                                   device=dev)
    with layer_routes(layers, params, replay=lambda i, p: pre_w.forward[
            i].gate_idx[:, p:p + 1]) as dec:
        for pos in range(SERVE_PROMPT):
            logits_d, _ = transformer.decode_step(cfg, params, cache,
                                                  ptoks[:, pos], pos)
    if dec.calls != [SERVE_PROMPT] * len(dec.calls) or any(
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
    for b in range(SERVE_SLOTS):
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
    n_total = check_param_count(cfg, params)
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
        _, dt = lm_prefill(fa, cfg, params, tokens)
        log(f"{arch_id} prefill [{batch}, {seq}] call {i}: {dt:.3f} s, "
            f"{batch * seq / dt:,.0f} tokens/s, K3's wgmma body launched "
            f"{n_layers} times, its SIMT body never")
        out.setdefault("prefill_s", []).append(dt)
    out["launches"] = dict(fa.LAUNCHES_BY_BODY)
    out["prefill_tok_s"] = batch * seq / min(out["prefill_s"])
    out["prefill_busy"] = profiled(
        lambda: transformer.prefill(cfg, params, tokens))

    # the plain route (chunked attention) at the kernel route's routing,
    # and each route's own decisions at those matched inputs
    out.update(prefill_vs_plain(ops, cfg, params, tokens),
               slots=batch * seq * cfg.moe_top_k * n_layers)
    del tokens
    torch.cuda.empty_cache()

    t = time.perf_counter()
    sv = serve_moe(cfg, params, dev, np.random.default_rng(2))
    cache, pos = sv.pop("cache_obj"), sv.pop("pos")
    sv["s"] = time.perf_counter() - t
    log(f"{arch_id} serve ({card}): {SERVE_SLOTS} requests x "
        f"({SERVE_PROMPT} prompt + {SERVE_NEW} new), cache "
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


def time_k3_layouts(ops, ref, fa, dev, layouts: dict) -> dict:
    """K3 at model layouts (``{key: (b, s, hq, hkv, dh, window)}``: phase
    15's ``MOE_K3_LAYOUTS``, mixtral's windowed GQA group of 4 at its
    prefill's and its training's shapes and llama4-scout's causal group of
    5, each also at a row of ``prefill_32k``; phase 18's
    ``DENSE_K3_LAYOUTS``, starcoder2-7b's causal group of 9, and a row of
    ``prefill_32k`` of it and of gemma-2b's MQA at head dim 256): held
    against the plain version (``ref.chunked_attention_ref``,
    ``attention_ref``'s math over 1,024-query by 1,024-key blocks, whose
    scores a 32,768-position layout's whole ``[S, S]`` would not hold: 4.3
    GB a head in fp32; that call timed by CUDA events), then timed in turns
    (kernel, SDPA, SDPA, kernel; CUDA events, median of 10) beside its bound (the
    pairs inside the mask) and ``scaled_dot_product_attention`` for the
    same function (where the window masks no key: one causal
    ``enable_gqa`` call; where it does: the K/V heads expanded before the
    clock and an explicit boolean band mask on SDPA's memory-efficient
    backend, as its GQA flag takes no mask but on its math backend, which
    at 32,768 positions would hold 69 GB of scores)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out, errs = {}, {}
    gen = torch.Generator(dev).manual_seed(4)
    for key, (b, s, hq, hkv, dh, window) in layouts.items():
        q = torch.randn((b, s, hq, dh), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        kern = lambda: fa.flash_attention_cuda(q, k, v, window=window)  # noqa: E731
        n = dict(fa.LAUNCHES_BY_BODY)
        got = kern()
        if fa.LAUNCHES_BY_BODY["wgmma"] != n["wgmma"] + 1:
            raise AssertionError(f"K3 at {key}'s layout did not run the "
                                 f"wgmma body")
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ops.use_kernels(False)
        try:
            t0.record()
            exp = ops.flash_attention_heads(q, k, v, window=window)
            t1.record()
        finally:
            ops.use_kernels(True)
        t1.synchronize()
        pm = t0.elapsed_time(t1)
        name = f"{key} [{b}, {s}, {hq} q / {hkv} kv, {dh}] window {window}"
        errs[name] = check_close(got, exp, K3_PATH_ATOL, f"K3 {name}",
                                 K3_PATH_RTOL)
        del got, exp
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

            def lib_fn():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(qt, ke, ve,
                                                          attn_mask=band)
            lib_out = lib_fn().transpose(1, 2)
            errs[f"SDPA at {name} (yardstick, not held)"] = float(
                (lib_out.float() - kern().float()).abs().max())
            del lib_out, pos
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
        del q, k, v, qt, lib_fn
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
    out["k3"] = time_k3_layouts(ops, ref, flash_attention, dev,
                                MOE_K3_LAYOUTS)
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


def full_graph_edges(n: int, n_edges: int, seed: int = PLAN_SEED) -> tuple:
    """A graph of ``n`` nodes and exactly ``n_edges`` undirected edges:
    ``powerlaw_graph(n, m, seed)`` at the smallest ``m`` (``m_per_node``)
    whose graph has at least ``n_edges`` edges, truncated to ``n_edges``.
    The search starts at the ``m`` reckoned from ``m`` draws and
    ``TRIANGLE_P`` closed triangles a node, and builds ``m - 1`` too, so
    the ``m`` it returns is the smallest.  Returns the edges and the
    reckoning: each ``m`` tried with its edge count and seconds."""
    from repro_torch.data.synthetic import powerlaw_graph

    tried = {}

    def draw(m):
        t = time.perf_counter()
        e = powerlaw_graph(n, m, seed=seed)
        tried[m] = {"edges": len(e), "s": time.perf_counter() - t}
        return e

    m = max(1, int((n_edges - TRIANGLE_P * n) // n))
    edges = draw(m)
    if len(edges) >= n_edges:
        while m > 1:
            fewer = draw(m - 1)
            if len(fewer) < n_edges:
                break
            m, edges = m - 1, fewer
    else:
        while len(edges) < n_edges:
            m += 1
            edges = draw(m)
    edges = edges[:n_edges]
    if len(edges) != n_edges:
        raise AssertionError(f"{len(edges)} edges, the cell has {n_edges}")
    return edges, {"m_per_node": m, "edges": n_edges, "tried": tried}


def minibatch_sample(cell, seed: int = PLAN_SEED) -> tuple:
    """A ``minibatch`` cell's sample: a source graph of the cell's
    ``n_nodes`` (``powerlaw_graph`` at ``round(n_edges / n_nodes)`` draws a
    node, so its draws number the cell's edges before duplicates are
    dropped), its ``CSRGraph``, ``batch_nodes`` seeds drawn without
    replacement, then ``fanout_sample``.  Every node of the source has at
    least the largest fanout's neighbours (asserted), so no node's draw
    comes up short and the sample holds exactly ``batch_nodes · (f1 + f1 ·
    f2 + ...)`` directed edges (asserted).  Returns ``(nodes, src, dst,
    info)``."""
    from repro_torch.data import sampler
    from repro_torch.data.synthetic import powerlaw_graph

    p = cell.params
    n, fan, seeds_n = p["n_nodes"], tuple(p["fanout"]), p["batch_nodes"]
    m = max(1, round(p["n_edges"] / n))
    t = time.perf_counter()
    edges = powerlaw_graph(n, m, seed=seed)
    info = {"source_nodes": n, "source_m_per_node": m,
            "source_edges": len(edges), "cell_edges": p["n_edges"],
            "source_s": time.perf_counter() - t}
    t = time.perf_counter()
    csr = sampler.CSRGraph(n, edges)
    del edges
    deg = np.diff(csr.indptr)
    info.update(csr_s=time.perf_counter() - t, min_degree=int(deg.min()),
                max_degree=int(deg.max()))
    if info["min_degree"] < max(fan):
        raise AssertionError(f"{cell.name}: a source node of degree "
                             f"{info['min_degree']} under the fanout {fan}")
    t = time.perf_counter()
    seeds = np.random.default_rng(seed).choice(n, seeds_n, replace=False)
    nodes, src, dst = sampler.fanout_sample(csr, seeds, fan, seed=seed)
    want = sum(seeds_n * int(np.prod(fan[:i + 1])) for i in range(len(fan)))
    info.update(sample_s=time.perf_counter() - t, sampled_nodes=len(nodes),
                sampled_edges=len(src))
    if len(src) != want:
        raise AssertionError(f"{cell.name}: the sample has {len(src)} edges, "
                             f"expected {want}: a draw came up short")
    return nodes, src, dst, info


def directed_batch(nodes, src, dst, d_feat: int, n_classes: int, *,
                   with_pos: bool, with_triplets: bool, pad_nodes: int,
                   pad_edges: int, seed: int = PLAN_SEED) -> dict:
    """A fanout sample's padded batch.  Its directed ``(src, dst)`` pairs
    go into the edge arrays as they are (``make_gnn_batch`` takes
    undirected edges and adds each one's reverse, and ``pad_to`` cuts what
    passes the pad without a word).  The rest is ``make_gnn_batch``'s on
    the sampled nodes: their features, labels, targets and positions drawn
    from ``seed`` in its order, ``node_mask`` true on them, padding edges
    on node ``pad_nodes - 1`` with a false mask, and DimeNet's fixed-fanout
    triplets (``build_triplets_fixed`` on the directed edges) padded to
    ``TRIPLET_FANOUT`` slots a padded edge."""
    from repro_torch.data import sampler

    n, e = len(nodes), len(src)
    if n > pad_nodes or e > pad_edges:
        raise AssertionError(f"{n} nodes and {e} edges over the pads "
                             f"{pad_nodes} and {pad_edges}")
    nb = sampler.make_gnn_batch(np.zeros((0, 2), np.int64), n, d_feat,
                                n_classes=n_classes, with_pos=with_pos,
                                pad_nodes=pad_nodes, pad_edges=pad_edges,
                                seed=seed)
    nb["edge_src"] = sampler.pad_to(src.astype(np.int32), pad_edges,
                                    fill=pad_nodes - 1)
    nb["edge_dst"] = sampler.pad_to(dst.astype(np.int32), pad_edges,
                                    fill=pad_nodes - 1)
    nb["edge_mask"] = sampler.pad_to(np.ones(e, bool), pad_edges, fill=False)
    if with_triplets:
        t_kj, t_ji, tmask = sampler.build_triplets_fixed(
            src, dst, n, fanout=TRIPLET_FANOUT, seed=seed)
        pt = pad_edges * TRIPLET_FANOUT
        nb["triplet_kj"] = sampler.pad_to(t_kj.astype(np.int32), pt, fill=0)
        nb["triplet_ji"] = sampler.pad_to(t_ji.astype(np.int32), pt, fill=0)
        nb["triplet_mask"] = sampler.pad_to(tmask, pt, fill=False)
        nb["energy_target"] = np.float32(0.0)
    return nb


def gnn_cell_batch(arch, cell, source=None) -> tuple:
    """The numpy batch of the GNN arch ``arch`` on ``cell``: the plan's
    keys at the plan's padded shapes (``specs._gnn_batch_structs``), from
    ``PLAN_SEED``; with the plan's ``n_graphs`` and a record of what was
    built.  By kind: a graph of exactly the cell's edges
    (``full_graph_edges``) through ``make_gnn_batch``, padded only to
    ``_round_up``'s quantum; a fanout sample (``minibatch_sample``) placed
    by ``directed_batch``; or ``make_batched_graphs`` (the cell's graphs
    of its nodes and edges).  ``source``: the cell's graph or sample, if
    already built (``full_graph_edges`` / ``minibatch_sample``'s result).
    Positions go to the geometric models and triplets to DimeNet, as the
    plan's keys ask."""
    from repro_torch.data import sampler
    from repro_torch.launch import specs

    want, n_graphs, d_feat = specs._gnn_batch_structs(arch, cell)
    p, n_classes = cell.params, arch.model.n_classes
    pn, pe = want["node_feat"].shape[0], want["edge_src"].shape[0]
    flags = {"with_pos": "pos" in want, "with_triplets": "triplet_kj" in want}
    if cell.kind == "full_graph":
        edges, info = source or full_graph_edges(p["n_nodes"], p["n_edges"])
        nb = sampler.make_gnn_batch(edges, p["n_nodes"], d_feat,
                                    n_classes=n_classes, pad_nodes=pn,
                                    pad_edges=pe, seed=PLAN_SEED, **flags)
        real = 2 * len(edges)
        if pe != specs._round_up(real):
            raise AssertionError(f"{cell.name}: {pe} edge slots for {real} "
                                 f"directed edges")
    elif cell.kind == "minibatch":
        nodes, src, dst, info = source or minibatch_sample(cell)
        nb = directed_batch(nodes, src, dst, d_feat, n_classes, pad_nodes=pn,
                            pad_edges=pe, **flags)
        real = len(src)
    else:
        nb = sampler.make_batched_graphs(p["batch"], p["n_nodes"],
                                         p["n_edges"], d_feat,
                                         n_classes=n_classes, seed=PLAN_SEED)
        info, real = {"graphs": p["batch"]}, 2 * p["batch"] * p["n_edges"]
        if nb["labels"].max() >= n_classes:
            # make_batched_graphs hands n_classes to the graph labels only:
            # its node labels span make_gnn_batch's default 16 classes, past
            # the logits of a model of fewer (gcn-cora's 7), where the loss
            # reads NaN (jnp.take_along_axis's fill, which gnn._gold
            # follows).  The node labels taken modulo the model's classes
            nb["labels"] = nb["labels"] % np.int32(n_classes)
            info["node_labels"] = f"modulo {n_classes} classes"
    mask = np.asarray(nb["edge_mask"])
    if int(mask.sum()) != real or not mask[:real].all():
        raise AssertionError(f"{cell.name}: {int(mask.sum())} real edge "
                             f"slots, expected {real} ahead of the padding")
    missing = sorted(set(want) - set(nb))
    if missing:
        raise AssertionError(f"{cell.name}: the batch lacks {missing}")
    batch = {k: np.asarray(nb[k]) for k in want}
    for k, s in want.items():
        x = torch.from_numpy(batch[k])
        if tuple(x.shape) != tuple(s.shape) or x.dtype != s.dtype:
            raise AssertionError(f"{cell.name}: {k} is {x.dtype} "
                                 f"{tuple(x.shape)}, the plan's {s.dtype} "
                                 f"{tuple(s.shape)}")
    return batch, n_graphs, dict(
        info, nodes=pn, real_nodes=int(batch["node_mask"].sum()),
        edge_slots=pe, real_edge_slots=real, padding_edge_slots=pe - real)


def k4_per_step(cfg, n_graphs: int) -> int:
    """K4's launches in one step of ``gnn.loss_fn``, one a call of
    ``gnn._segment_sum``: one a layer (``gcn_forward``, ``gin_forward``,
    ``mgn_forward``, ``dimenet_forward``), GCN's degree count, and the
    graph readout of GIN and DimeNet on a cell of graphs.  DimeNet's
    fixed-fanout triplet reduce is a reshape and a sum, no segment sum."""
    return (cfg.n_layers + (cfg.model == "gcn")
            + (bool(n_graphs) and cfg.model in ("gin", "dimenet")))


def _plan_args(arch, cell, plan, dev, batch: dict | None = None,
               params: dict | None = None) -> tuple:
    """The plan's arguments on the card: the port's own init from a seeded
    generator (an LM's stacked parameters as ``params`` give them, where
    they do: ``stacked_params``, the same values), the batch from
    ``PLAN_SEED`` (a GNN cell's numpy batch from ``gnn_cell_batch``, built
    here unless ``batch`` gives it)."""
    from repro_torch.data import synthetic
    from repro_torch.models import gnn, recsys, transformer
    from repro_torch.training.optimizer import adamw_init

    gen = torch.Generator(dev).manual_seed(PLAN_SEED)
    rng = np.random.default_rng(PLAN_SEED)
    if arch.family == "lm":
        if params is None:
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
        if cell.kind == "train_batch":
            return params, adamw_init(params), recsys.batch_to_torch(nb, dev)
        return params, recsys.batch_to_torch(nb, dev)
    if batch is None:
        batch = gnn_cell_batch(arch, cell)[0]
    batch = gnn.batch_to_torch(batch, dev)
    params = gnn.init_params(arch.model, gen, cell.params["d_feat"])
    return params, adamw_init(params), batch


def _direct(arch, args, n_graphs: int = 0):
    """The model's own entry point on the plan's tensors (xDeepFM and the
    GNN family): ``recsys.serve``, or on ``(params, opt_state, batch)`` a
    returning train step of the model's ``loss_fn`` (the GNN's with the
    cell's ``n_graphs``)."""
    from repro_torch.models import gnn, recsys
    from repro_torch.training import optimizer

    if arch.family == "recsys" and len(args) == 2:
        return recsys.serve(arch.model, *args)
    if arch.family == "recsys":
        loss_fn = lambda p, b: recsys.loss_fn(arch.model, p, b)  # noqa: E731
    else:
        loss_fn = lambda p, b: gnn.loss_fn(  # noqa: E731
            arch.model, p, b, n_graphs=n_graphs)
    return optimizer.make_train_step(loss_fn, optimizer.AdamWConfig())(*args)


def run_plan_on_card(arch, cell_name: str, dev, card: str,
                     phase: int = 16, host_dir: str | None = None,
                     params: dict | None = None, checks=None) -> dict:
    """One cell of the ``ArchConfig`` ``arch`` (its full config, or a cut
    one) run through its plan on the card at ``make_test_mesh((1, 1))``, at
    the cell's shape.  The plan is first traced on
    ``meta`` at the same mesh (``dryrun.run_cell``); the card's arguments
    must match its tree and its ``argument_size_in_bytes`` exactly, the
    outputs its shapes and dtypes; outputs finite; launches counted (set
    to 0 just before the call, read just after).  An LM plan (``params``:
    its stacked parameters, else initialised here) must launch K3's wgmma
    body once a layer, its SIMT body, K4 and K5 never, and its rows 0-1
    lie within ``LOGIT_RTOL`` of a direct ``prefill``.  A GNN cell's batch comes
    from ``gnn_cell_batch`` (from ``host_dir`` when the host process built
    it); its step must launch K4 ``k4_per_step`` times, K3 and K5 never,
    and equal the model's own step bitwise.  A train plan (the GNN cells,
    ``xdeepfm/train_batch``: K4 once, K5 three times) donates its
    parameters and optimizer state: it steps on a clone of them
    (``clone_donated``), each leaf of which must keep its storage, and is
    held bitwise against the model's own returning step from the
    originals (``_direct``).  ``checks(plan, args, res)``, where given,
    runs after these gates, its dict merged into the readings (phase 19's
    ``gnn_cell_checks``, phase 20's ``prefill_checks``)."""
    from repro_torch.kernels import cin, flash_attention, segment_matmul
    from repro_torch.launch import dryrun, mesh as lmesh, specs
    from repro_torch.launch.specs import tree_paths
    from repro_torch.models import transformer

    arch_id = arch.arch_id
    cell = next(c for c in arch.cells() if c.name == cell_name)
    rec = dryrun.run_cell(arch, cell_name,
                          lmesh.make_test_mesh((1, 1), device="meta"), "1x1")
    if not rec["ok"]:
        raise AssertionError(f"{arch_id}/{cell_name} on meta: {rec['error']}")
    plan = specs.build_cell(arch, cell,
                            lmesh.make_test_mesh((1, 1), device=dev))
    batch, built, host_s, n_graphs = None, None, None, 0
    if arch.family == "gnn":
        n_graphs = specs._gnn_batch_structs(arch, cell)[1]
        t = time.perf_counter()
        if host_dir is None:
            batch, _, built = gnn_cell_batch(arch, cell)
        else:
            batch = load_host_batch(host_dir, arch_id, cell_name, plan.args[2])
        host_s = time.perf_counter() - t
    t = time.perf_counter()
    args = _plan_args(arch, cell, plan, dev, batch, params)
    del batch, params
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
    # a train plan donates its parameters and optimizer state: it steps on
    # a clone, so the model's own step and the plain route start from the
    # same arguments; every donated leaf must keep its storage
    donated = clone_donated(args) if plan.donate_argnums == (0, 1) else args
    before = leaf_ptrs(donated[:2]) if donated is not args else None
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts(flash_attention, segment_matmul, cin)
    t = time.perf_counter()
    out = plan.fn(*donated)
    sync(dev)
    run_s = time.perf_counter() - t
    if donated is not args:
        check_storage_kept(before, donated[:2], f"{arch_id}/{cell_name}")
    launches = {"flash_attention": dict(flash_attention.LAUNCHES_BY_BODY),
                "segment_matmul": segment_matmul.LAUNCHES, "cin": cin.LAUNCHES}
    res = {"init_s": init_s, "run_s": run_s, "arg_bytes": n_bytes,
           "dryrun_arg_bytes": rec["argument_size_in_bytes"],
           "dryrun_out_bytes": rec["output_size_in_bytes"],
           "matmul_flops": rec["matmul_flops"], "trace_s": rec["trace_s"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_above_args_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "launches": launches}
    if host_s is not None:
        res.update(batch_host_s=host_s, built=built)
    if donated is not args:
        res["storage_kept"] = True
        del donated
    got = dryrun._shape_tree(out)
    if got != rec["outputs"]:
        raise AssertionError(f"{arch_id}/{cell_name}: outputs {got}, the meta "
                             f"trace's {rec['outputs']}")
    for p, x in tree_paths(out):
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{arch_id}/{cell_name}: {p} not finite")
    if arch.family == "lm":
        n = arch.model.n_layers
        want = {"flash_attention": {"wgmma": n, "simt": 0},
                "segment_matmul": 0, "cin": 0}
        if launches != want:
            raise AssertionError(f"{arch_id}/{cell_name} launched {launches}, "
                                 f"expected {want}")
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
                else {"segment_matmul": k4_per_step(arch.model, n_graphs),
                      "cin": 0, "flash_attention": {"wgmma": 0, "simt": 0}})
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"{arch_id}/{cell_name} launched {launches}, "
                                 f"expected {want}")
        direct = _direct(arch, args, n_graphs)
        for (p, x), (_, y) in zip(tree_paths(out), tree_paths(direct)):
            if not torch.equal(x, y):
                raise AssertionError(f"{arch_id}/{cell_name}: {p} differs from "
                                     f"the model's own entry point")
        res["bitwise_vs_direct"] = True
        if plan.donate_argnums:
            res["loss"] = float(out[2]["loss"])
            if not np.isfinite(res["loss"]):
                raise AssertionError(f"{arch_id}/{cell_name}: loss {res['loss']}")
        del direct
    del out
    if checks is not None:
        res.update(checks(plan, args, res))
    log(f"phase {phase} plan {arch_id}/{cell_name} on the card ({card}): "
        f"{json.dumps(res)}")
    del args
    torch.cuda.empty_cache()
    return res


def gnn_cell_checks(arch, cell, plan, args, dev) -> dict:
    """Phase 19's checks of a GNN cell past its plan's call: the step held
    against ``use_kernels(False)`` at phase 13's gates, K4's rows entry
    against its plain version on every input the step handed it (as many
    as ``k4_per_step``), the peak memory of the two steps; on
    ``PROFILED_CELL``, one plan step profiled (busy share, top ops) and K4
    timed on the step's inputs beside ``index_add_`` and its byte bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import specs
    from repro_torch.models import gnn

    cfg, what = arch.model, f"{arch.arch_id}/{cell.name}"
    n_graphs = specs._gnn_batch_structs(arch, cell)[1]
    out = {}
    if (arch.arch_id, cell.name) == PROFILED_CELL:
        top, donated = [], clone_donated(args)
        out["profiled_busy"] = profiled(lambda: plan.fn(*donated),
                                        require="segment_sum", top=top)
        out["top_ops"] = top
        del donated
    torch.cuda.reset_peak_memory_stats()
    vs, seen = step_vs_plain(
        ops, ref, lambda p, b: gnn.loss_fn(cfg, p, b, n_graphs=n_graphs),
        args[0], args[2], what)
    out["vs_plain"] = vs
    out["vs_plain_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if len(seen) != k4_per_step(cfg, n_graphs):
        raise AssertionError(f"{what}: the step handed K4 {len(seen)} "
                             f"inputs, expected {k4_per_step(cfg, n_graphs)}")
    if (arch.arch_id, cell.name) == PROFILED_CELL:
        out["k4_shapes"] = _k4_training_shapes(
            ops, ref, seen, vs["k4_max_abs_err"], None, dev)
    del seen
    return out


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


def drive_plans(dev, card: str, dryrun_run: dict,
                recsys_launcher_peak_gb: float) -> dict:
    """Phase 16: the dry-run's result (started before phase 13), the
    plans of ``PLAN_CELLS`` run on the card (``xdeepfm/train_batch``'s peak
    logged beside phase 14's launcher run of the returning loop, whose
    peak is ``recsys_launcher_peak_gb``), the expert block's mesh branches.
    ``launches`` sums the plans' launches by kernel."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out = {"dryrun": finish_dryrun(dryrun_run, card), "plans": {}}
    launches = {"flash_attention_wgmma": 0, "flash_attention_simt": 0,
                "segment_matmul": 0, "cin": 0}
    for arch_id, cell_name in PLAN_CELLS:
        r = run_plan_on_card(get_config(arch_id), cell_name, dev, card)
        out["plans"][f"{arch_id}/{cell_name}"] = r
        launches["flash_attention_wgmma"] += r["launches"]["flash_attention"]["wgmma"]
        launches["flash_attention_simt"] += r["launches"]["flash_attention"]["simt"]
        launches["segment_matmul"] += r["launches"]["segment_matmul"]
        launches["cin"] += r["launches"]["cin"]
    r = out["plans"]["xdeepfm/train_batch"]
    r["launcher_peak_gb"] = recsys_launcher_peak_gb
    log(f"phase 16 xdeepfm/train_batch ({card}): the plan's donated step "
        f"peaks at {r['peak_gb']:.2f} GB, phase 14's launcher run (the "
        f"returning step of loop.run) at {recsys_launcher_peak_gb:.2f} GB")
    out["launches"] = launches
    out["branches"] = check_expert_branches(dev, card)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 17: MoE training at full width on the card
# ---------------------------------------------------------------------------

def depth_cut(arch_id: str, card_bytes: int) -> tuple:
    """The full config of the LM arch ``arch_id`` cut to the deepest depth
    at which its donated AdamW step fits in ``TRAIN_FIT`` of
    ``card_bytes``: ``DONATED_COPIES`` fp32 copies of its parameters and
    the update's three fp32 slices of ``ADAMW_SLICE`` elements; and the
    reckoning: the GB these take at each depth up to the first that does
    not fit (or the full depth), the limit and the card."""
    from repro_torch.models import transformer
    from repro_torch.training.optimizer import ADAMW_SLICE

    full = model_cfg(arch_id)
    slices = 3 * 4 * ADAMW_SLICE
    limit, gb, depth = TRAIN_FIT * card_bytes, {}, 0
    for d in range(1, full.n_layers + 1):
        need = 4 * DONATED_COPIES * transformer.param_count(
            dataclasses.replace(full, n_layers=d)) + slices
        gb[d] = need / 1e9
        if need > limit:
            break
        depth = d
    if depth == 0:
        raise AssertionError(f"{arch_id}: {DONATED_COPIES} fp32 copies of one "
                             f"layer's parameters take {gb[1]:.1f} GB, over "
                             f"{limit / 1e9:.1f} GB")
    return dataclasses.replace(full, n_layers=depth), {
        "copies": DONATED_COPIES, "adamw_slices_gb": slices / 1e9,
        "gb_by_depth": gb, "limit_gb": limit / 1e9,
        "card_gb": card_bytes / 1e9}


def log_depth_cut(arch_id: str, cfg, cut: dict, card: str) -> None:
    from repro_torch.models import transformer

    full = model_cfg(arch_id)
    gb = {d: round(g, 2) for d, g in cut["gb_by_depth"].items()}
    log(f"{arch_id}: DEPTH CUT {full.n_layers} -> {cfg.n_layers} layers at "
        f"full width (d {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv} kv heads "
        f"of {cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.moe_experts} experts, "
        f"window {cfg.window}, vocab {cfg.vocab}): the donated AdamW step "
        f"holds {cut['copies']} fp32 copies of the "
        f"{transformer.param_count(cfg):,} parameters and "
        f"{cut['adamw_slices_gb']:.2f} GB of update slices; GB by depth "
        f"{json.dumps(gb)}, limit {cut['limit_gb']:.1f} of "
        f"{cut['card_gb']:.1f} GB ({card})")


def train_plan(arch_id: str, cfg, b: int, s: int, dev):
    """``arch_id``'s ``train_4k`` plan at ``cfg`` (a depth cut) with its
    batch cut to ``[b, s]``, built at ``make_test_mesh((1, 1))`` on
    ``dev``; its ``fn`` is the donating step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh as lmesh, specs

    arch = dataclasses.replace(get_config(arch_id), model=cfg)
    cell = ShapeCell("train_4k", "train", {"batch": b, "seq": s})
    plan = specs.build_cell(arch, cell,
                            lmesh.make_test_mesh((1, 1), device=dev))
    if plan.donate_argnums != (0, 1) or not plan.fn.donate:
        raise AssertionError(f"{arch_id}/train_4k: the plan donates "
                             f"{plan.donate_argnums}, its step donate="
                             f"{plan.fn.donate}")
    return plan


def stacked_leaf_gb(plan) -> float:
    """GB of the plan's largest stacked (``[L, ...]``) fp32 parameter:
    unbind's backward builds one such gradient at a time from the
    per-layer ones."""
    from repro_torch.launch.specs import tree_paths
    return max(x.numel() * x.element_size()
               for _, x in tree_paths(plan.args[0]["layers"])) / 1e9


def leaf_ptrs(tree) -> list:
    from repro_torch.training.optimizer import tree_leaves
    return [x.data_ptr() for x in tree_leaves(tree)]


def check_storage_kept(before: list, tree, what: str) -> None:
    """Every leaf of ``tree`` (a donated step's parameters and state) at
    the ``data_ptr`` it had before the step."""
    after = leaf_ptrs(tree)
    moved = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
    if len(before) != len(after) or moved:
        raise AssertionError(f"{what}: {len(moved)} of {len(before)} donated "
                             f"leaves moved (first {moved[:5]})")


def clone_donated(args: tuple) -> tuple:
    """A train plan's arguments with the donated trees (0 and 1) cloned,
    the batch as it is."""
    from repro_torch.training.optimizer import tree_map
    return (tree_map(torch.clone, args[0]), tree_map(torch.clone, args[1]),
            *args[2:])


def _leaves_differ(a, b) -> list:
    """Indices of the leaves of two trees that differ in dtype or bits."""
    from repro_torch.training.optimizer import tree_leaves
    return [i for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b)))
            if x.dtype != y.dtype or not torch.equal(x, y)]


def donated_vs_returning(step, init, batches, what: str) -> dict:
    """``len(batches)`` donated steps (``step``: ``make_train_step(...,
    donate=True)``) against as many returning steps of the same loss and
    settings from the same start.  ``init()`` gives the parameters and
    optimizer state from a seed, each call's held here alone: two calls
    must agree bitwise (the start is reproducible: the second is a clone
    of the first), the first takes the returning steps, and a third, with
    the returning steps' results beside it, the donated ones, so no more
    than a returning step's 8 copies or 3 + 4 exist at once.  Each donated
    step must keep every leaf at its storage and return the same tree
    objects; every leaf of the two results and each step's stats must be
    equal bitwise (``torch.equal`` and the same dtype)."""
    from repro_torch.training import optimizer as opt

    t = time.perf_counter()
    p, o = init()
    differ = _leaves_differ((p, o), init())
    if differ:
        raise AssertionError(f"{what}: two seeded inits differ in leaves "
                             f"{differ[:5]}")
    gc.collect()
    returning = opt.make_train_step(step.loss_fn, step.opt_cfg,
                                    step.compression)
    d_stats, r_stats = [], []
    for batch in batches:
        p, o, stats = returning(p, o, batch)
        r_stats.append({k: v.item() for k, v in stats.items()})
    params, opt_state = init()
    before = leaf_ptrs((params, opt_state))
    for batch in batches:
        got = step(params, opt_state, batch)
        check_storage_kept(before, got[:2], what)
        if got[0] is not params or got[1] is not opt_state:
            raise AssertionError(f"{what}: the donated step returned new "
                                 f"trees")
        d_stats.append({k: v.item() for k, v in got[2].items()})
    differ = _leaves_differ((params, opt_state), (p, o))
    del p, o, params, opt_state, got
    if differ or d_stats != r_stats:
        raise AssertionError(f"{what}: the donated steps differ from the "
                             f"returning ones in leaves {differ[:5]}; stats "
                             f"{d_stats} vs {r_stats}")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"steps": len(batches), "leaves": len(before), "bitwise": True,
            "losses": [x["loss"] for x in d_stats],
            "s": time.perf_counter() - t}


def same_bits_at_cut(arch_id: str, dev, card: str) -> dict:
    """``donated_vs_returning`` at ``SAME_BITS_CUTS[arch_id]`` layers of the
    full width: the cut's ``train_4k`` plan at ``[DENSE_TRAIN_BATCH,
    DENSE_TRAIN_SEQ]``, ``ADAMW_STEPS`` batches of ``TokenStream``, the
    parameters from ``PLAN_SEED`` (``stacked_params``)."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.training.optimizer import adamw_init

    cfg = dataclasses.replace(model_cfg(arch_id),
                              n_layers=SAME_BITS_CUTS[arch_id])
    b, s = DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ
    plan = train_plan(arch_id, cfg, b, s, dev)
    stream = TokenStream(cfg.vocab, b, s, seed=0)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in stream.next().items()} for _ in range(ADAMW_STEPS)]
    def init():
        params = stacked_params(cfg, dev)
        return params, adamw_init(params)

    rec = donated_vs_returning(plan.fn, init, batches,
                               f"{arch_id} at {cfg.n_layers} layers")
    rec["layers"] = cfg.n_layers
    log(f"{arch_id}: {ADAMW_STEPS} donated steps == {ADAMW_STEPS} returning "
        f"steps bitwise at {cfg.n_layers} layers, [{b}, {s}] ({card}): "
        f"{json.dumps(rec)}")
    return rec


def adamw_steps(plan, arch_id: str, params, stream, dev, mods) -> tuple:
    """``ADAMW_STEPS`` donated AdamW steps of a cut ``train_4k`` plan
    (``train_plan``) from ``params`` (its stacked parameters), one batch of
    ``stream`` a step.  The kernel counts are set to 0 just before the first
    step and read just after the last; each step is synchronised and timed
    with its loss read back, the last one under ``torch.profiler``; after
    every step each leaf of params, ``mu`` and ``nu`` must keep its storage;
    the peak device memory is read, and what the process held beside the
    parameters before the steps (``other_gb``).  Returns the record and
    the trained parameters."""
    from repro_torch.training.optimizer import adamw_init, tree_leaves

    steps = ADAMW_STEPS
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in stream.next().items()} for _ in range(steps)]
    if _tree_sig(params) != _tree_sig(plan.args[0]):
        raise AssertionError(f"{arch_id}: the parameters differ from the "
                             f"plan's tree")
    gc.collect()
    other = torch.cuda.memory_allocated(dev) - sum(
        x.numel() * x.element_size() for x in tree_leaves(params))
    opt_state = adamw_init(params)
    before = leaf_ptrs((params, opt_state))
    reset_counts(*mods)
    torch.cuda.reset_peak_memory_stats(dev)
    rec = {"step_s": [], "loss": [], "grad_norm": [], "last_step_top_ops": []}
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        session = profile_open() if i == steps - 1 else None
        t = time.perf_counter()
        params, opt_state, stats = plan.fn(params, opt_state, batch)
        rec["loss"].append(float(stats["loss"]))
        sync(dev)
        rec["step_s"].append(time.perf_counter() - t)
        rec["grad_norm"].append(float(stats["grad_norm"]))
        if session is not None:
            rec["last_step_busy"] = profile_close(
                session, top=rec["last_step_top_ops"])
        check_storage_kept(before, (params, opt_state),
                           f"{arch_id} donated step {i}")
    rec.update(s=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               other_gb=other / 1e9, storage_kept=True,
               launches={m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES
                         for m in mods},
               by_body={m.__name__.rsplit(".", 1)[-1]: dict(m.LAUNCHES_BY_BODY)
                        for m in mods if hasattr(m, "LAUNCHES_BY_BODY")})
    del opt_state, batches
    torch.cuda.empty_cache()
    if not np.all(np.isfinite(rec["loss"])):
        raise AssertionError(f"{arch_id} AdamW steps: {json.dumps(rec)}")
    return rec, params


def check_step_peak(arch_id: str, plan, cfg, cut: dict, rec: dict) -> None:
    """The peak gate: ``rec["peak_gb"]`` less ``rec["other_gb"]`` within
    the reckoning at ``cfg``'s depth, the plan's largest stacked leaf and
    ``STEP_TRANSIENT_GB[arch_id]``; the terms and the step's own transient
    over the first two are written into ``rec``."""
    reckoned = cut["gb_by_depth"][cfg.n_layers]
    rec.update(reckoned_gb=reckoned, stacked_leaf_gb=stacked_leaf_gb(plan),
               allowed_transient_gb=STEP_TRANSIENT_GB[arch_id])
    own = rec["peak_gb"] - rec["other_gb"]
    rec["transient_gb"] = own - reckoned - rec["stacked_leaf_gb"]
    if rec["transient_gb"] > rec["allowed_transient_gb"]:
        raise AssertionError(f"{arch_id}: peak {rec['peak_gb']:.2f} GB "
                             f"({rec['other_gb']:.2f} held beside) over the "
                             f"reckoning {reckoned:.2f} + the stacked leaf "
                             f"{rec['stacked_leaf_gb']:.2f} + the allowed "
                             f"transient {rec['allowed_transient_gb']} GB")


def drive_moe_training(dev, card: str) -> dict:
    """Phase 17: the MoE archs' training at full width (``MOE_TRAIN_RUNS``,
    depth and batch cuts labelled): each arch's ``ADAMW_STEPS`` donated
    steps of its cut ``train_4k`` plan (``adamw_steps``; parameters from
    ``PLAN_SEED``, batches of ``TokenStream``), the storage and peak gates.
    The kernel counts are set to 0 just before each arch's steps and read
    just after: K3's wgmma body twice a layer a step (each layer and its
    recompute), its SIMT body, K4 and K5 never.  Then each arch's step is
    held against the plain route at matched routing on the trained
    parameters, mixtral's once more at ``MOE_WINDOW_STEP``, and mixtral's
    same-bits gate (``same_bits_at_cut``).  ``launches`` sums K3's by
    body."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import cin, flash_attention, ops, ref, segment_matmul
    from repro_torch.models import layers, transformer

    t_phase = time.perf_counter()
    mods = (flash_attention, segment_matmul, cin)
    out = {"archs": {}, "launches": {"wgmma": 0, "simt": 0}}
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    for arch_id, b, s in MOE_TRAIN_RUNS:
        t_arch = time.perf_counter()
        cfg, cut = depth_cut(arch_id, card_bytes)
        n_full = model_cfg(arch_id).n_layers
        rec = {"reduced": f"depth {n_full} -> {cfg.n_layers} layers (full "
                          f"width); train_4k [256, 4096] cut to [{b}, {s}]",
               "layers": cfg.n_layers, "cut": cut,
               "cap": layers.moe_capacity(s, cfg.moe_experts,
                                          cfg.moe_top_k, cfg.moe_capacity),
               "params": transformer.param_count(cfg)}
        log_depth_cut(arch_id, cfg, cut, card)
        log(f"{arch_id}: BATCH CUT train_4k [256, 4096] -> [{b}, {s}]; "
            f"capacity {rec['cap']} slots an expert a row")
        plan = train_plan(arch_id, cfg, b, s, dev)
        stream = TokenStream(cfg.vocab, b, s, seed=0)
        rec["train"], params = adamw_steps(plan, arch_id,
                                           stacked_params(cfg, dev), stream,
                                           dev, mods)
        check_step_peak(arch_id, plan, cfg, cut, rec["train"])
        got, loss0 = rec["train"], rec["train"]["loss"][0]
        want = {"wgmma": 2 * cfg.n_layers * ADAMW_STEPS, "simt": 0}
        log(f"phase 17 {arch_id} donated AdamW steps at depth {cfg.n_layers} "
            f"({card}): {json.dumps(rec['train'])}")
        if got["by_body"]["flash_attention"] != want or \
                got["launches"]["segment_matmul"] or got["launches"]["cin"]:
            raise AssertionError(f"{arch_id} training launched "
                                 f"{got['launches']} by body "
                                 f"{got['by_body']}, expected {want}")
        if abs(loss0 - np.log(cfg.vocab)) > FIRST_LOSS_GAP:
            raise AssertionError(f"{arch_id}: first loss {loss0}, expected "
                                 f"within {FIRST_LOSS_GAP} of ln "
                                 f"{cfg.vocab}")
        rec["launches"] = got["by_body"]["flash_attention"]
        for body, n in rec["launches"].items():
            out["launches"][body] += n
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.next().items()}
        t = time.perf_counter()
        vs = lm_step_vs_plain(ops, ref, flash_attention, plan.fn.loss_fn,
                              params, batch, f"{arch_id} step")
        vs["s"] = time.perf_counter() - t
        rec["vs_plain"] = vs
        log(f"{arch_id} step vs plain at matched routing [{b}, {s}] "
            f"({card}; loss rtol {LM_STEP_LOSS_RTOL}, leaves "
            f"{LM_STEP_GRAD_FRO} relative Frobenius): {json.dumps(vs)}")
        del batch
        if cfg.window:
            wb, ws = MOE_WINDOW_STEP
            batch = {k: torch.as_tensor(v, device=dev) for k, v in
                     TokenStream(cfg.vocab, wb, ws, seed=1).next().items()}
            loss_w = lambda p, bb: transformer.loss_fn(  # noqa: E731
                cfg, transformer.unstack_layers(p), bb,
                xent_chunk=min(512, ws))
            t = time.perf_counter()
            vw = lm_step_vs_plain(ops, ref, flash_attention, loss_w,
                                   params, batch, f"{arch_id} [{wb}, {ws}]")
            vw["s"] = time.perf_counter() - t
            rec["window_step"] = vw
            log(f"{arch_id} step vs plain at matched routing [{wb}, {ws}] "
                f"(window {cfg.window} masks) ({card}): {json.dumps(vw)}")
            del batch
        del params, stream, plan
        gc.collect()
        torch.cuda.empty_cache()
        if arch_id in SAME_BITS_CUTS:
            rec["same_bits"] = same_bits_at_cut(arch_id, dev, card)
        rec["s"] = time.perf_counter() - t_arch
        out["archs"][arch_id] = rec
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 18: the dense LM family at full width on the card
# ---------------------------------------------------------------------------

def drive_dense_arch(ops, ref, fa, arch_id: str, batch: int, seq: int, dev,
                     card: str, mods) -> dict:
    """One dense arch from one seeded initialisation on the card.  At full
    width and depth (the parameter count checked): two timed prefill calls
    of ``[batch, seq]`` and one profiled (K3's wgmma body once a layer a
    call, its SIMT body never), the logits against the plain route, and
    ``DecodeEngine`` serving ``SERVE_SLOTS`` requests of ``SERVE_PROMPT +
    SERVE_NEW`` tokens with phase 10's consistency gates; the kernel counts set to 0 just before and read just
    after (``launches["serving"]``).  Then the first layers of the same
    parameters at the depth cut (``depth_cut``), stacked a leaf at a time
    (``stack_leafwise``): the first step's loss and gradients on
    ``[DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ]`` against the plain route
    (``lm_step_vs_plain``), then ``adamw_steps``, the donated steps of the
    cut ``train_4k`` plan, from the same parameters and batches
    (``launches["training"]``: K3's wgmma body twice a layer a step), with
    the storage and peak gates."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer

    cfg = model_cfg(arch_id)
    out = {"launches": {}}
    t = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(dev).manual_seed(0))
    sync(dev)
    n_total = check_param_count(cfg, params, DENSE_PARAMS[arch_id])
    out["params"] = transformer.param_count(cfg)
    log(f"{arch_id}: full width and depth, {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv} kv heads of "
        f"{cfg.head_dim} (a group of {cfg.n_heads // cfg.n_kv}), {cfg.norm}, "
        f"{cfg.mlp} d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied embeddings "
        f"{cfg.tie_embeddings}: param_count {out['params']:,} (+ "
        f"{uncounted_params(cfg):,} norm elements it leaves out = "
        f"{n_total:,}; {4e-9 * n_total:.1f} GB fp32), init "
        f"{time.perf_counter() - t:.1f} s ({card})")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, seq))).to(dev)

    reset_counts(*mods)
    for i in range(2):
        logits, dt = lm_prefill(fa, cfg, params, tokens)
        log(f"{arch_id} prefill [{batch}, {seq}] call {i}: {dt:.3f} s, "
            f"{batch * seq / dt:,.0f} tokens/s, K3's wgmma body launched "
            f"{cfg.n_layers} times, its SIMT body never")
        out.setdefault("prefill_s", []).append(dt)
    out["prefill_tok_s"] = batch * seq / min(out["prefill_s"])
    top = []
    out["prefill_busy"] = profiled(
        lambda: lm_prefill(fa, cfg, params, tokens), top=top)
    out["prefill_top_ops"] = top
    out["vs_plain"] = prefill_vs_plain(ops, cfg, params, tokens, logits)
    del tokens, logits
    torch.cuda.empty_cache()
    t = time.perf_counter()
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT))
    out["serve"] = serve_dense(fa, cfg, params, prompts, SERVE_NEW,
                               SERVE_MAX_SEQ, dev)
    out["serve"]["s"] = time.perf_counter() - t
    out["launches"]["serving"] = dict(fa.LAUNCHES_BY_BODY)
    if any(m.LAUNCHES for m in mods if m is not fa):
        raise AssertionError(f"{arch_id} serving launched "
                             f"{[(m.__name__, m.LAUNCHES) for m in mods]}")

    t = time.perf_counter()
    cut_cfg, cut = depth_cut(arch_id,
                             torch.cuda.get_device_properties(dev).total_memory)
    b, s = DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ
    out["train"] = {"reduced": f"depth {cfg.n_layers} -> {cut_cfg.n_layers} "
                               f"layers (full width); train_4k [256, 4096] "
                               f"cut to [{b}, {s}]",
                    "layers": cut_cfg.n_layers, "cut": cut,
                    "params": transformer.param_count(cut_cfg)}
    log_depth_cut(arch_id, cut_cfg, cut, card)
    params["layers"] = params["layers"][:cut_cfg.n_layers]
    gc.collect()
    params = stack_leafwise(params)
    torch.cuda.empty_cache()
    plan = train_plan(arch_id, cut_cfg, b, s, dev)
    first = {k: torch.as_tensor(v, device=dev)
             for k, v in TokenStream(cfg.vocab, b, s, seed=0).next().items()}
    vs = lm_step_vs_plain(ops, ref, fa, plan.fn.loss_fn, params, first,
                          f"{arch_id} step")
    out["train"]["vs_plain"] = vs
    log(f"{arch_id} first step vs plain [{b}, {s}] ({card}; loss rtol "
        f"{LM_STEP_LOSS_RTOL}, leaves {LM_STEP_GRAD_FRO} relative Frobenius): "
        f"{json.dumps(vs)}")
    del first
    rec, params = adamw_steps(plan, arch_id, params,
                              TokenStream(cfg.vocab, b, s, seed=0), dev, mods)
    check_step_peak(arch_id, plan, cut_cfg, cut, rec)
    out["train"]["steps"] = rec
    want = {"wgmma": 2 * cut_cfg.n_layers * ADAMW_STEPS, "simt": 0}
    if rec["by_body"]["flash_attention"] != want or \
            any(n for name, n in rec["launches"].items()
                if name != "flash_attention"):
        raise AssertionError(f"{arch_id} AdamW steps launched "
                             f"{rec['launches']} by body {rec['by_body']}, "
                             f"expected {want}")
    # the first step's loss is the checked one (same parameters and batch),
    # and on uniform random targets no model's expected loss is below
    # ln(vocab) (Jensen); the batch mean's spread is ~1e-2
    if abs(rec["loss"][0] - vs["loss"]) > FIRST_STEP_RTOL * vs["loss"] or \
            rec["loss"][0] < np.log(cfg.vocab) - FIRST_LOSS_FLOOR:
        raise AssertionError(f"{arch_id}: first step's loss {rec['loss'][0]},"
                             f" the checked step's {vs['loss']}, ln "
                             f"{cfg.vocab} = {np.log(cfg.vocab)}")
    out["launches"]["training"] = rec["by_body"]["flash_attention"]
    out["train"]["s"] = time.perf_counter() - t
    log(f"phase 18 {arch_id} donated AdamW steps at depth {cut_cfg.n_layers} "
        f"({card}): {json.dumps(rec)}; the first step's loss "
        f"{rec['loss'][0]} against {vs['loss']} in the check before it")
    del params, plan
    gc.collect()
    torch.cuda.empty_cache()
    return out


def drive_dense_family(dev, card: str) -> dict:
    """Phase 18: each arch of ``DENSE_RUNS`` through ``drive_dense_arch``,
    built, driven and freed in turn; the same-bits gate of the dense archs
    of ``SAME_BITS_CUTS`` (``same_bits_at_cut``); then K3 at starcoder2-7b's
    layout (``DENSE_K3_LAYOUTS``) against its plain version and timed beside
    its bound and ``scaled_dot_product_attention``."""
    from repro_torch.kernels import cin, flash_attention, ops, ref, segment_matmul

    t_phase = time.perf_counter()
    mods = (flash_attention, segment_matmul, cin)
    out = {"archs": {}}
    for arch_id, batch, seq in DENSE_RUNS:
        t = time.perf_counter()
        res = drive_dense_arch(ops, ref, flash_attention, arch_id, batch,
                               seq, dev, card, mods)
        res["s"] = time.perf_counter() - t
        out["archs"][arch_id] = res
        log(f"phase 18 {arch_id} ({card}): {json.dumps(res)}")
    out["same_bits"] = {a: same_bits_at_cut(a, dev, card)
                        for a in SAME_BITS_CUTS if a not in MOE_ARCHS}
    out["k3"] = time_k3_layouts(ops, ref, flash_attention, dev,
                                DENSE_K3_LAYOUTS)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 19: the GNN family at its cells' global shapes
# ---------------------------------------------------------------------------

def build_host_cells(work: str) -> None:
    """Phase 19's host work, run in a process of its own: for each cell of
    ``HOST_CELLS`` its graph or sample once (``minibatch_sample``,
    ``full_graph_edges``), then each of its archs' batches
    (``gnn_cell_batch``), one ``.npy`` a key under
    ``<work>/<arch>-<cell>/``; last ``<work>/host.json``, what was built
    and the seconds of each part."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config

    t_all = time.perf_counter()
    summary = {"cpu_count": os.cpu_count()}
    for cell_name in HOST_CELLS:
        source = None
        for arch_id in [a for a, c in GNN_CELLS if c == cell_name]:
            arch = get_config(arch_id)
            cell = next(c for c in arch.cells() if c.name == cell_name)
            if source is None:
                t = time.perf_counter()
                source = (minibatch_sample(cell) if cell.kind == "minibatch"
                          else full_graph_edges(cell.params["n_nodes"],
                                                cell.params["n_edges"]))
                summary[cell_name] = {"source_s": time.perf_counter() - t}
            t = time.perf_counter()
            batch, n_graphs, info = gnn_cell_batch(arch, cell, source)
            build_s = time.perf_counter() - t
            t = time.perf_counter()
            d = os.path.join(work, f"{arch_id}-{cell_name}")
            os.makedirs(d)
            for k, v in batch.items():
                np.save(os.path.join(d, f"{k}.npy"), v)
            summary[f"{arch_id}/{cell_name}"] = dict(
                info, n_graphs=n_graphs, batch_s=build_s,
                save_s=time.perf_counter() - t,
                bytes=sum(v.nbytes for v in batch.values()))
            del batch
        del source
    summary["s"] = time.perf_counter() - t_all
    with open(os.path.join(work, "host.json.tmp"), "w") as f:
        json.dump(summary, f)
    os.replace(os.path.join(work, "host.json.tmp"),
               os.path.join(work, "host.json"))


def start_host_cells(work: str) -> dict:
    """``build_host_cells(work)`` in a process of its own with no card
    visible, output to a file; it runs beside the phases that follow its
    start."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke.build_host_cells({work!r})")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    log_path = os.path.join(work, "host.log")
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                cwd=work, stdout=f, stderr=subprocess.STDOUT)
    return {"proc": proc, "t0": time.perf_counter(), "log": log_path,
            "work": work}


def finish_host_cells(run: dict, card: str) -> dict:
    """Wait for the host process (``HOST_TIMEOUT`` after its start) and
    require exit 0: a failure or a timeout fails the smoke, nothing falls
    back to a smaller graph.  Logs the wait and what was built."""
    proc, t = run["proc"], time.perf_counter()
    try:
        rc = proc.wait(timeout=max(1.0, HOST_TIMEOUT
                                   - (time.perf_counter() - run["t0"])))
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    waited = time.perf_counter() - t
    if rc != 0:
        with open(run["log"]) as f:
            raise AssertionError(f"the host build exited {rc} (None: still "
                                 f"running at {HOST_TIMEOUT} s):\n"
                                 f"{f.read()[-4000:]}")
    with open(os.path.join(run["work"], "host.json")) as f:
        summary = json.load(f)
    summary["waited_s"] = waited
    log(f"phase 19 host build ({card}; {summary['cpu_count']} host cores): "
        f"{summary['s']:.1f} s from its start, phase 19 waited {waited:.1f} "
        f"s for it; {json.dumps(summary)}")
    return summary


def load_host_batch(work: str, arch_id: str, cell_name: str, want: dict):
    """The host process's numpy batch of ``arch_id`` on ``cell_name``, the
    keys of ``want``."""
    d = os.path.join(work, f"{arch_id}-{cell_name}")
    return {k: np.load(os.path.join(d, f"{k}.npy")) for k in want}


def drive_gnn_cells(dev, card: str, host_run: dict) -> dict:
    """Phase 19: each of ``GNN_CELLS`` through ``run_plan_on_card`` (the
    host process's batches for ``HOST_CELLS``, waited for at the first
    such cell).  ``launches`` sums K4's launches in the plans' calls."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out = {"cells": {}, "launches": 0, "cut": {
        f"{a}/ogb_products": why for a, why in OGB_CUT.items()}}
    log(f"phase 19 ({card}): ogb_products is cut for {json.dumps(OGB_CUT)}")
    for arch_id, cell_name in GNN_CELLS:
        host_dir = None
        if cell_name in HOST_CELLS:
            if "host" not in out:
                out["host"] = finish_host_cells(host_run, card)
            host_dir = host_run["work"]
        arch = get_config(arch_id)
        cell = next(c for c in arch.cells() if c.name == cell_name)
        r = run_plan_on_card(
            arch, cell_name, dev, card, phase=19, host_dir=host_dir,
            checks=lambda plan, args, res: gnn_cell_checks(arch, cell, plan,
                                                           args, dev))
        out["cells"][f"{arch_id}/{cell_name}"] = r
        out["launches"] += r["launches"]["segment_matmul"]
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 20: the decode cells (decode_32k, long_500k) through their plans
# ---------------------------------------------------------------------------

def decode_cut(arch, cell_name: str, n_layers: int | None,
               card_bytes: int) -> tuple:
    """The LM ``ArchConfig`` ``arch`` at depth ``n_layers`` (``None``: full
    depth) with its decode cell ``cell_name``'s batch cut to
    the largest whose wave fits in ``TRAIN_FIT`` of ``card_bytes``: the
    fp32 parameters, the bf16 weight casts of a wave (one layer's weights
    and the unembedding), and for each sequence its bf16 cache beside the
    fp32 copies of one layer's K and V that the decode attention makes
    (``layers.attention_apply``).  Returns the ``ArchConfig`` whose model
    and one cell are cut, and the reckoning."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import transformer

    cell = next(c for c in arch.cells() if c.name == cell_name)
    cfg = arch.model if n_layers is None else \
        dataclasses.replace(arch.model, n_layers=n_layers)
    c = transformer.cache_len(cfg, cell.params["seq"])
    kv = c * cfg.n_kv * cfg.head_dim      # a layer's K (or V) slots a sequence
    params, casts = lm_fixed_bytes(cfg)
    cache, temps = 2 * 2 * cfg.n_layers * kv, 2 * 4 * kv
    limit = TRAIN_FIT * card_bytes
    need = lambda b: params + casts + b * (cache + temps)  # noqa: E731
    batch = min(cell.params["batch"], int((limit - params - casts)
                                          // (cache + temps)))
    if batch < 1:
        raise AssertionError(f"{arch.arch_id}/{cell_name}: one sequence needs "
                             f"{need(1) / 1e9:.1f} GB, over "
                             f"{limit / 1e9:.1f} GB")
    cut = ShapeCell(cell.name, cell.kind, dict(cell.params, batch=batch))
    gb = {b: need(b) / 1e9 for b in (batch, batch + 1)
          if b <= cell.params["batch"]}
    return dataclasses.replace(arch, model=cfg, shapes=(cut,)), {
        "batch": batch, "full_batch": cell.params["batch"],
        "layers": cfg.n_layers, "full_layers": arch.model.n_layers,
        "cache_slots": c, "params_gb": params / 1e9,
        "weight_casts_gb": casts / 1e9, "cache_gb_a_seq": cache / 1e9,
        "temps_gb_a_seq": temps / 1e9, "gb_by_batch": gb,
        "limit_gb": limit / 1e9, "card_gb": card_bytes / 1e9}


def log_decode_cut(arch, cut: dict, card: str) -> None:
    cfg, cell = arch.model, arch.shapes[0]
    gb = {b: round(g, 2) for b, g in cut["gb_by_batch"].items()}
    depth = ("full depth" if cut["layers"] == cut["full_layers"] else
             f"DEPTH CUT {cut['full_layers']} -> {cut['layers']} layers "
             f"(phase 15's)")
    log(f"{arch.arch_id}/{cell.name}: BATCH CUT {cut['full_batch']} -> "
        f"{cut['batch']} at full width and {depth} (d {cfg.d_model}, "
        f"{cfg.n_heads} q / {cfg.n_kv} kv heads of {cfg.head_dim}, window "
        f"{cfg.window}, vocab {cfg.vocab}; seq {cell.params['seq']}, "
        f"{cut['cache_slots']} cache slots): fp32 parameters "
        f"{cut['params_gb']:.2f} GB, a wave's bf16 weight casts "
        f"{cut['weight_casts_gb']:.2f} GB, a sequence's bf16 cache "
        f"{cut['cache_gb_a_seq']:.3f} GB and fp32 K/V copies of a layer "
        f"{cut['temps_gb_a_seq']:.3f} GB; GB by batch {json.dumps(gb)}, "
        f"limit {cut['limit_gb']:.1f} of {cut['card_gb']:.1f} GB ({card})")


def prefill_seq_bytes(cfg, s: int) -> dict:
    """One sequence's bytes at the peak of a prefill layer of ``cfg`` at
    ``s`` positions (``transformer._layer_fwd`` under ``no_grad``), by
    phase, each the tensors live at its peak; the weight casts are
    ``lm_fixed_bytes``'.  ``norm``: the residual x, x + h and h (bf16)
    beside ``norm_apply``'s three fp32 ``[s, d]`` temporaries.
    ``attention``: x and its norm, q, k and v (bf16) beside ``rope``'s fp32
    temporaries on q (the angles, cos and sin; two half-width products
    each of its two halves, and their concatenation) or, with qk-norm,
    ``norm_apply``'s three on q.  ``ffn``: x, x + h, h and the norm (bf16)
    beside the MLP's intermediates (gated: the activated gate, the up
    projection and their product; GELU: the projection and its
    activation) or the expert block's: ``updates`` and ``buf`` (``xe`` is
    a view of it), then the gate, the up projection and their product over
    the ``E · cap`` slots beside ``ye``, or at the combine ``got`` and
    ``got · gates`` beside the gate, the up projection and ``ye``.  The
    K3 output and ``wo``'s product come after rope's temporaries are
    freed, and take less."""
    from repro_torch.models import layers

    d, dh = cfg.d_model, cfg.head_dim
    sd, sq, sk = s * d, s * cfg.n_heads * dh, s * cfg.n_kv * dh
    out = {"norm": 2 * 3 * sd + 4 * 3 * sd,
           "attention": 2 * (2 * sd + sq + 2 * sk) + max(
               4 * 2 * sq + 4 * 3 * s * dh // 2, 4 * 3 * sq * cfg.qk_norm)}
    if cfg.moe_experts:
        tk = s * cfg.moe_top_k
        slots = cfg.moe_experts * layers.moe_capacity(
            s, cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity)
        inner = 2 * slots * d + max(2 * 3 * slots * cfg.d_ff,
                                    2 * 2 * slots * cfg.d_ff + 2 * 2 * tk * d)
        ffn = 2 * tk * d + 2 * (slots + 1) * d + inner
    else:
        ffn = 2 * s * cfg.d_ff * (3 if cfg.mlp in ("swiglu", "geglu") else 2)
    out["ffn"] = 2 * 4 * sd + ffn
    return out


def prefill_cut(arch, n_layers: int | None, card_bytes: int) -> tuple:
    """The LM ``ArchConfig`` ``arch`` with its ``prefill`` cell's batch cut
    to the largest whose call fits in ``TRAIN_FIT`` of ``card_bytes``: the
    fp32 parameters and the weight casts (``lm_fixed_bytes``) and each
    sequence's peak transients (``prefill_seq_bytes``), at depth
    ``n_layers`` (``None``: full depth) or, where one sequence does not fit
    there, the deepest depth at which it does.  GShard's capacity is per
    row, so the batch changes how many rows run, not what a row computes.
    Returns the ``ArchConfig`` whose model and one cell are cut, and the
    reckoning; raises where one sequence does not fit at one layer."""
    from repro_torch.configs.base import ShapeCell

    cell = next(c for c in arch.cells() if c.kind == "prefill")
    full_batch, s = cell.params["batch"], cell.params["seq"]
    depth = n_layers or arch.model.n_layers
    phases = prefill_seq_bytes(arch.model, s)
    per_seq, limit = max(phases.values()), TRAIN_FIT * card_bytes
    for n in range(depth, 0, -1):
        cfg = dataclasses.replace(arch.model, n_layers=n)
        params, casts = lm_fixed_bytes(cfg)
        batch = min(full_batch, int((limit - params - casts) // per_seq))
        if batch >= 1:
            break
    else:
        raise AssertionError(f"{arch.arch_id}/{cell.name}: one sequence at one "
                             f"layer needs {(params + casts + per_seq) / 1e9:.1f}"
                             f" GB, over {limit / 1e9:.1f} GB")
    need = lambda b: params + casts + b * per_seq  # noqa: E731
    cut = ShapeCell(cell.name, cell.kind, dict(cell.params, batch=batch))
    return dataclasses.replace(arch, model=cfg, shapes=(cut,)), {
        "batch": batch, "full_batch": full_batch, "layers": cfg.n_layers,
        "asked_layers": depth, "full_layers": arch.model.n_layers,
        "params_gb": params / 1e9, "weight_casts_gb": casts / 1e9,
        "seq_gb_by_phase": {k: v / 1e9 for k, v in phases.items()},
        "gb_by_batch": {b: need(b) / 1e9 for b in (batch, batch + 1)
                        if b <= full_batch},
        "limit_gb": limit / 1e9, "card_gb": card_bytes / 1e9}


def log_prefill_cut(arch, cut: dict, card: str) -> None:
    cfg, cell = arch.model, arch.shapes[0]
    gb = {b: round(g, 2) for b, g in cut["gb_by_batch"].items()}
    depth = "full depth" if cut["layers"] == cut["full_layers"] else (
        f"DEPTH CUT {cut['full_layers']} -> {cut['layers']} layers"
        + (" (phase 15's)" if cut["layers"] == cut["asked_layers"] else
           f" (phase 15's {cut['asked_layers']} leave no room for one "
           f"sequence)"))
    log(f"{arch.arch_id}/{cell.name}: BATCH CUT {cut['full_batch']} -> "
        f"{cut['batch']} at full width and {depth} (d {cfg.d_model}, "
        f"{cfg.n_heads} q / {cfg.n_kv} kv heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, {cfg.moe_experts} experts, window {cfg.window}, vocab "
        f"{cfg.vocab}; seq {cell.params['seq']}): fp32 parameters "
        f"{cut['params_gb']:.2f} GB, a call's bf16 weight casts "
        f"{cut['weight_casts_gb']:.2f} GB, a sequence's peak in a layer by "
        f"phase {json.dumps({k: round(v, 3) for k, v in cut['seq_gb_by_phase'].items()})}"
        f" GB; GB by batch {json.dumps(gb)}, limit {cut['limit_gb']:.1f} of "
        f"{cut['card_gb']:.1f} GB ({card})")


def stack_leafwise(params: dict) -> dict:
    """``transformer.stack_layers(params)``, stacked one leaf at a time
    with each layer's copy of it freed as it goes, so the card never holds
    two copies of the layers (mixtral's eight are 47.5 GB)."""
    def stack(trees):
        out = {}
        for k in list(trees[0]):
            leaves = [t.pop(k) for t in trees]
            out[k] = (stack(leaves) if isinstance(leaves[0], dict)
                      else torch.stack(leaves))
            del leaves
        return out

    params["layers"] = stack(params["layers"])
    return params


def stacked_params(cfg, dev) -> dict:
    """``_plan_args``'s LM parameters (``transformer.stack_layers`` of
    ``init_params`` from ``PLAN_SEED``), stacked by ``stack_leafwise``."""
    from repro_torch.models import transformer

    return stack_leafwise(transformer.init_params(
        cfg, torch.Generator(dev).manual_seed(PLAN_SEED)))


def fill_cache(cache: dict, seed: int, start: int = 0) -> None:
    """Slots ``start`` on of every layer and row of ``cache`` (``k``, ``v``:
    ``[L, B, C, Hkv, Dh]``) filled in place with normal values from
    ``seed``, one layer at a time."""
    gen = torch.Generator(cache["k"].device).manual_seed(seed)
    for key in ("k", "v"):
        for layer in cache[key]:
            layer[:, start:].normal_(generator=gen)


def decode_plan_args(arch, params, n_waves: int, dev) -> tuple:
    """A decode cell's plan arguments ``(params, cache, token, pos)``: the
    stacked parameters (``stacked_params``), the cache filled from
    ``PLAN_SEED`` (``fill_cache``), the token of the last of ``n_waves``
    rows of tokens from ``PLAN_SEED`` and the cell's last position; and the
    ``[n_waves, B]`` tokens."""
    from repro_torch.models import transformer

    cfg, cell = arch.model, arch.shapes[0]
    b, s = cell.params["batch"], cell.params["seq"]
    cache = transformer.init_cache(cfg, b, s, device=dev)
    fill_cache(cache, PLAN_SEED)
    tokens = torch.from_numpy(np.random.default_rng(PLAN_SEED).integers(
        0, cfg.vocab, (n_waves, b), dtype=np.int32)).to(dev)
    pos = torch.tensor(s - 1, dtype=torch.int32, device=dev)
    return (params, cache, tokens[-1], pos), tokens


def save_slot(cache: dict, slot: int) -> dict:
    """A copy of ring slot ``slot`` of every layer and row of ``cache``."""
    return {k: v[:, :, slot].clone() for k, v in cache.items()}


def restore_slot(cache: dict, slot: int, saved: dict) -> None:
    for k, v in cache.items():
        v[:, :, slot] = saved[k]


def decode_mask_check(plan, args, pos: int) -> dict:
    """One plan wave at ``pos`` (no ring wrap: every slot past ``pos`` is
    masked), then every slot past ``pos`` of every layer and row refilled
    from another seed and the wave again: the logits must be bitwise
    equal.  The slot the wave writes is restored after each wave."""
    params, cache, token, _ = args
    c = cache["k"].shape[2]
    if pos >= c - 1:
        raise ValueError(f"position {pos} leaves no slot of {c} past it")
    p = torch.tensor(pos, dtype=torch.int32, device=token.device)
    saved = save_slot(cache, pos)
    before, _ = plan.fn(params, cache, token, p)
    restore_slot(cache, pos, saved)
    fill_cache(cache, PLAN_SEED + 1, start=pos + 1)
    after, _ = plan.fn(params, cache, token, p)
    restore_slot(cache, pos, saved)
    if not torch.equal(before, after):
        raise AssertionError(f"{plan.arch_id}/{plan.cell_name}: the wave at "
                             f"{pos} moved by {float((before - after).abs().max())}"
                             f" when the {c - 1 - pos} slots past it were "
                             f"refilled")
    return {"pos": pos, "refilled_slots": c - 1 - pos, "bitwise": True}


def decode_card_vs_cpu(cfg, params, cache, tokens, positions: list,
                       dev) -> dict:
    """The first ``DECODE_CPU_LAYERS`` layers of ``params`` (stacked) and the
    first ``DECODE_CPU_ROWS`` rows of those layers' ``cache``, copied to the
    host: ``decode_step`` on the card (on a copy of those cache rows) and on
    the CPU, one wave a position of ``positions`` (tokens ``tokens[i]``),
    each wave's logits within ``LOGIT_RTOL`` of the CPU's largest.  An MoE
    arch's CPU waves replay the card's expert choices (``layer_routes``),
    their own choices differing only within ``ROUTE_TIE_GAP`` of a tie."""
    from repro_torch.models import layers, transformer

    moe = bool(cfg.moe_experts)
    n = DECODE_CPU_LAYERS["moe" if moe else "dense"]
    rows = min(DECODE_CPU_ROWS, tokens.shape[1])
    cut = dataclasses.replace(cfg, n_layers=n)
    per = transformer.unstack_layers(params)
    p_card = dict(per, layers=list(per["layers"][:n]))
    c_card = {k: v[:n, :rows].clone() for k, v in cache.items()}
    t = time.perf_counter()
    p_host = dict(transformer._map({k: v for k, v in p_card.items()
                                    if k != "layers"}, lambda x: x.cpu()),
                  layers=[transformer._map(lp, lambda x: x.cpu())
                          for lp in p_card["layers"]])
    c_host = {k: v.cpu() for k, v in c_card.items()}
    host_gb = sum(x.numel() * x.element_size()
                  for x in list(_leaves(p_host)) + list(c_host.values())) / 1e9
    out = {"layers": n, "rows": rows, "host_gb": host_gb,
           "copy_s": time.perf_counter() - t, "waves": []}
    routing = []
    t = time.perf_counter()
    for tok, pos in zip(tokens, positions):
        ctx = layer_routes(layers, p_card) if moe else contextlib.nullcontext()
        with ctx as tape_c:
            got, _ = transformer.decode_step(cut, p_card, c_card, tok[:rows],
                                             pos)
        replay = (lambda i, j: tape_c.routes[i][j].gate_idx.cpu()) if moe \
            else None
        ctx = layer_routes(layers, p_host, replay=replay) if moe else \
            contextlib.nullcontext()
        with ctx as tape_h:
            exp, _ = transformer.decode_step(cut, p_host, c_host,
                                             tok[:rows].cpu(), pos)
        err, lmax = float((got.cpu() - exp).abs().max()), float(exp.abs().max())
        out["waves"].append({"pos": int(pos), "max_abs_diff": err,
                             "largest_logit": lmax})
        if not err <= LOGIT_RTOL * lmax:
            raise AssertionError(f"{cfg.name} decode at {int(pos)}: the card "
                                 f"differs from the CPU by {err} > "
                                 f"{LOGIT_RTOL} x {lmax}")
        if moe:
            routing.append(route_differences(
                tape_h.forward, [layers.Routing(None, r.gate_idx.cpu(), None,
                                                None, None, r.cap)
                                 for r in tape_c.forward]))
    out["cpu_s"] = time.perf_counter() - t
    if moe:
        out["routing"] = {"decisions": sum(r["decisions"] for r in routing),
                          "differ": sum(r["differ"] for r in routing),
                          "max_gap": max(r["max_gap"] for r in routing)}
        check_route_gaps(out["routing"], f"{cfg.name} decode, card vs CPU")
    del p_host, c_host, c_card
    gc.collect()
    return out


def decode_wave_bytes(cfg, params, cache: dict, token, tape=None) -> int:
    """The bytes a decode wave must move at the least: the bf16 cache read
    once (every slot is valid in the decode cells) and the slot it writes,
    the fp32 logits ``[B, vocab]`` written, and the fp32 weights of
    ``params`` (stacked) read once, except that an untied embedding table
    gives only the rows of ``token``'s distinct ids and an MoE layer only
    the experts its routing chose (``tape``: ``layer_routes``' record of
    the wave)."""
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    slot = cache_bytes // cache["k"].shape[2]
    weights = sum(4 * x.numel() for x in _leaves(params))
    if not cfg.tie_embeddings:
        weights -= 4 * (cfg.vocab - token.unique().numel()) * cfg.d_model
    if cfg.moe_experts:
        experts = {k: w for k, w in params["layers"]["moe"].items()
                   if k != "router"}
        a_expert = sum(4 * w[0, 0].numel() for w in experts.values())
        for calls in tape.routes:
            unused = cfg.moe_experts - calls[0].gate_idx.unique().numel()
            weights -= unused * a_expert
    return cache_bytes + slot + 4 * token.numel() * cfg.vocab + weights


def rope_card_vs_cpu(cfg, dev) -> dict:
    """``layers.rope`` at ``cfg``'s head dim and theta on the card and on
    the CPU, on the same unit-normal fp32 input ``[64, 2, Dh]`` at the 64
    positions ending at each of ``ROPE_ENDS``: the max abs difference
    within ``ROPE_ATOL``.  Both take the same fp32 angles; what the card
    computes in its own way is cos/sin of angles up to ~5e5 rad."""
    from repro_torch.models import layers

    out = {}
    for end in ROPE_ENDS:
        rng = np.random.default_rng(end)
        x = torch.from_numpy(rng.normal(size=(64, 2, cfg.head_dim)).astype(
            np.float32))
        pos = torch.arange(end - 63, end + 1, dtype=torch.int32)
        exp = layers.rope(x, pos, cfg.rope_theta)
        got = layers.rope(x.to(dev), pos.to(dev), cfg.rope_theta).cpu()
        out[end] = float((got - exp).abs().max())
        if not out[end] <= ROPE_ATOL:
            raise AssertionError(f"{cfg.name}: rope on the card differs from "
                                 f"the CPU's by {out[end]} > {ROPE_ATOL} at "
                                 f"positions ending at {end}")
    return out


def decode_cell_on_card(arch, cut: dict, params, dev, card: str) -> dict:
    """One decode cell (``arch``'s one cell, cut by ``decode_cut``) through
    its plan at ``make_test_mesh((1, 1))`` on ``params`` (stacked), with
    the gates: (1) the cut plan traced on ``meta`` (``dryrun.run_cell``;
    the full cell's trace logged beside it), the card's arguments equal to
    its tree and bytes, the outputs to its shapes; (2) finite logits; (3)
    the plan's wave bitwise equal to a direct ``transformer.decode_step``
    on the same arguments, the slot it writes restored between the two;
    (4) no K3, K4 or K5 launch (the counts set to 0 just before the wave,
    read just after); (5) without a window, ``decode_mask_check`` at
    ``MASK_BACK`` positions before the last; (6) ``decode_card_vs_cpu``;
    (7) ``rope_card_vs_cpu``.
    long_500k runs ``LONG_WAVES`` plan waves at the cell's last positions
    first (ring slots ``pos % C``), the CPU check taking the same waves.
    Readings: the median of ``DECODE_TIMED`` synchronised waves after one
    warm-up, the cache and peak GB, the byte bound
    (``decode_wave_bytes``), one wave profiled."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cin, flash_attention, segment_matmul
    from repro_torch.launch import dryrun, mesh as lmesh, specs
    from repro_torch.launch.specs import tree_paths
    from repro_torch.models import layers, transformer

    cfg, cell = arch.model, arch.shapes[0]
    tag = f"{arch.arch_id}/{cell.name}"
    meta = lmesh.make_test_mesh((1, 1), device="meta")
    rec = dryrun.run_cell(arch, cell.name, meta, "1x1")
    full = dryrun.run_cell(get_config(arch.arch_id), cell.name, meta, "1x1")
    for r in (rec, full):
        if not r["ok"]:
            raise AssertionError(f"{tag} on meta: {r['error']}")
    plan = specs.build_cell(arch, cell, lmesh.make_test_mesh((1, 1),
                                                             device=dev))
    n_waves = LONG_WAVES if cell.kind == "long_decode" else 1
    t = time.perf_counter()
    args, tokens = decode_plan_args(arch, params, n_waves, dev)
    sync(dev)
    res = {"fill_s": time.perf_counter() - t, "batch": cut["batch"],
           "layers": cfg.n_layers}
    if _tree_sig(args) != _tree_sig(plan.args):
        raise AssertionError(f"{tag}: the card's arguments differ from the "
                             f"plan's shapes and dtypes")
    n_bytes = sum(x.numel() * x.element_size() for _, x in tree_paths(args))
    if n_bytes != rec["argument_size_in_bytes"]:
        raise AssertionError(f"{tag}: {n_bytes} argument bytes on the card, "
                             f"the dry-run says {rec['argument_size_in_bytes']}")
    cache, token, pos = args[1], args[2], args[3]
    last = int(pos)
    c = cache["k"].shape[2]
    positions = list(range(last - n_waves + 1, last + 1))
    res.update(arg_bytes=n_bytes, dryrun_arg_bytes=rec["argument_size_in_bytes"],
               dryrun_out_bytes=rec["output_size_in_bytes"],
               full_cell_dryrun_arg_bytes=full["argument_size_in_bytes"],
               full_cell_dryrun_out_bytes=full["output_size_in_bytes"],
               positions=[positions[0], last],
               slots=[p % c for p in (positions[0], last)])
    # (6) first, on host copies of the cache as filled
    res["vs_cpu"] = decode_card_vs_cpu(cfg, args[0], cache, tokens,
                                       positions, dev)
    mods = (flash_attention, segment_matmul, cin)
    torch.cuda.reset_peak_memory_stats(dev)
    for p_i, tok in zip(positions[:-1], tokens[:-1]):
        plan.fn(args[0], cache, tok, torch.tensor(p_i, dtype=torch.int32,
                                                  device=dev))
    saved = save_slot(cache, last % c)
    reset_counts(*mods)
    out = plan.fn(*args)
    sync(dev)
    launches = {"flash_attention": dict(flash_attention.LAUNCHES_BY_BODY),
                "segment_matmul": segment_matmul.LAUNCHES, "cin": cin.LAUNCHES}
    res["launches"] = launches
    if launches != {"flash_attention": {"wgmma": 0, "simt": 0},
                    "segment_matmul": 0, "cin": 0}:
        raise AssertionError(f"{tag}: the decode wave launched {launches}")
    got = dryrun._shape_tree(out)
    if got != rec["outputs"]:
        raise AssertionError(f"{tag}: outputs {got}, the meta trace's "
                             f"{rec['outputs']}")
    logits = out[0]
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: logits not finite")
    written = save_slot(cache, last % c)
    restore_slot(cache, last % c, saved)
    per = transformer.unstack_layers(args[0])
    ctx = layer_routes(layers, per) if cfg.moe_experts else \
        contextlib.nullcontext()
    with ctx as tape:
        direct, _ = transformer.decode_step(cfg, per, cache, token, pos)
    if not torch.equal(direct, logits) or not all(
            torch.equal(cache[k][:, :, last % c], written[k]) for k in cache):
        raise AssertionError(f"{tag}: the plan's wave differs from a direct "
                             f"decode_step by "
                             f"{float((direct - logits).abs().max())}")
    res["bitwise_vs_direct"] = True
    bound_bytes = decode_wave_bytes(cfg, args[0], cache, token, tape)
    if cfg.moe_experts:
        res["experts_chosen"] = [r[0].gate_idx.unique().numel()
                                 for r in tape.routes]
    del out, direct, written, per
    ms = []
    plan.fn(*args)
    for _ in range(DECODE_TIMED):
        sync(dev)
        t = time.perf_counter()
        plan.fn(*args)
        sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    res.update(wave_ms=ms, wave_ms_median=float(np.median(ms)),
               cache_gb=cache_bytes / 1e9,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               reckoned_gb=cut["gb_by_batch"][cut["batch"]],
               bound_gb=bound_bytes / 1e9,
               bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes", largest_logit=float(logits.abs().max()))
    top = []
    res["busy"] = profiled(lambda: plan.fn(*args), top=top)
    res["top_ops"] = top
    res["rope_vs_cpu"] = rope_card_vs_cpu(cfg, dev)
    if cfg.window is None:
        res["mask_check"] = decode_mask_check(plan, args, last - MASK_BACK)
    log(f"phase 20 plan {tag} on the card ({card}): {json.dumps(res)}")
    del args, cache, logits
    return res


def prefill_checks(arch, cut: dict, plan, args, res: dict, card: str) -> dict:
    """Phase 20's gates of a ``prefill_32k`` plan past ``run_plan_on_card``'s
    (the meta trace's arguments and outputs, finite logits, K3's wgmma body
    once a layer and no other kernel, rows 0-1 against a direct prefill):
    the peak gate, the call's peak (``res``) less what the process held
    beside its arguments within ``prefill_cut``'s reckoning and
    ``PREFILL_TRANSIENT_GB``; the plain route on the first
    ``DECODE_CPU_LAYERS`` layers of the same parameters at row 0
    (``prefill_vs_plain``, an MoE arch at matched routing).  Readings: the
    median of ``PREFILL_TIMED`` synchronised calls after the gated one,
    prefill tokens/s; for ``PREFILL_PROFILED``, one call profiled."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg, cell = arch.model, arch.shapes[0]
    tag = f"{arch.arch_id}/{cell.name}"
    out = {"reckoned_gb": cut["gb_by_batch"][cut["batch"]],
           "allowed_transient_gb": PREFILL_TRANSIENT_GB[arch.arch_id],
           "other_gb": res["peak_gb"] - res["peak_above_args_gb"]
           - res["arg_bytes"] / 1e9}
    out["transient_gb"] = res["peak_gb"] - out["other_gb"] - out["reckoned_gb"]
    if out["transient_gb"] > out["allowed_transient_gb"]:
        raise AssertionError(f"{tag}: peak {res['peak_gb']:.2f} GB "
                             f"({out['other_gb']:.2f} held beside) over the "
                             f"reckoning {out['reckoned_gb']:.2f} + the allowed"
                             f" transient {out['allowed_transient_gb']} GB")
    n = DECODE_CPU_LAYERS["moe" if cfg.moe_experts else "dense"]
    per = transformer.unstack_layers(args[0])
    t = time.perf_counter()
    out["vs_plain"] = dict(prefill_vs_plain(
        ops, dataclasses.replace(cfg, n_layers=n),
        dict(per, layers=list(per["layers"][:n])), args[1][:1]), layers=n,
        rows=1, s=time.perf_counter() - t)
    del per
    ms = _time_call(lambda: plan.fn(*args), PREFILL_TIMED)
    tokens = args[1].numel()
    out.update(call_ms=ms, call_s_median=float(np.median(ms)) / 1e3,
               tokens_per_s=tokens / (float(np.median(ms)) / 1e3))
    if arch.arch_id in PREFILL_PROFILED:
        top = []
        out["busy"] = profiled(lambda: plan.fn(*args), top=top)
        out["top_ops"] = top[:5]
    log(f"phase 20 {tag} [{cut['batch']}, {cell.params['seq']}] at "
        f"{cfg.n_layers} layers ({card}): {out['call_s_median']:.3f} s a call "
        f"(median of {ms}), {out['tokens_per_s']:,.0f} tokens/s; peak "
        f"{res['peak_gb']:.2f} GB against the reckoning "
        f"{out['reckoned_gb']:.2f} GB (transient {out['transient_gb']:.2f}, "
        f"allowed {out['allowed_transient_gb']})")
    return out


def drive_decode_cells(dev, card: str) -> dict:
    """Phase 20: each arch of ``DECODE_RUNS`` from one seeded
    initialisation (``stacked_params``), its decode cells (``decode_32k``;
    mixtral-8x7b's ``long_500k`` too, on the same parameters) cut by
    ``decode_cut`` and driven by ``decode_cell_on_card``, then, for
    ``PREFILL_ARCHS``, its ``prefill_32k`` cut by ``prefill_cut`` through
    ``run_plan_on_card`` on the same parameters (their first layers where
    the cut is deeper) with ``prefill_checks``; then freed.
    ``prefill_launches`` holds each prefill call's K3 launches by body."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    out = {"cells": {}, "prefill_launches": {}}
    for arch_id, n_layers in DECODE_RUNS:
        params = None
        for cell in get_config(arch_id).cells():
            if cell.kind not in ("decode", "long_decode"):
                continue
            t = time.perf_counter()
            arch, cut = decode_cut(get_config(arch_id), cell.name, n_layers,
                                   card_bytes)
            log_decode_cut(arch, cut, card)
            if params is None:
                params = stacked_params(arch.model, dev)
                check_param_count(arch.model, params)
            res = decode_cell_on_card(arch, cut, params, dev, card)
            res["cut"], res["s"] = cut, time.perf_counter() - t
            out["cells"][f"{arch_id}/{cell.name}"] = res
            gc.collect()
            torch.cuda.empty_cache()
        if arch_id in PREFILL_ARCHS:
            t = time.perf_counter()
            arch, cut = prefill_cut(get_config(arch_id), n_layers, card_bytes)
            log_prefill_cut(arch, cut, card)
            first = dict(params, layers=transformer._map(
                params["layers"], lambda x: x[:cut["layers"]]))
            with expandable_segments():
                res = run_plan_on_card(
                    arch, "prefill_32k", dev, card, phase=20, params=first,
                    checks=lambda plan, args, res: prefill_checks(
                        arch, cut, plan, args, res, card))
            del first
            res["cut"], res["s"] = cut, time.perf_counter() - t
            out["cells"][f"{arch_id}/prefill_32k"] = res
            out["prefill_launches"][arch_id] = \
                res["launches"]["flash_attention"]
            gc.collect()
            torch.cuda.empty_cache()
        del params
        gc.collect()
        torch.cuda.empty_cache()
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
    # phase 19's host work (minibatch_lg's sample, ogb_products's graph and
    # batches: ~340 s on the card's host, more than phases 13-18 take)
    # starts here, a process of its own with no card visible, on a core the
    # host-bound phases leave free
    host_work = tempfile.mkdtemp(prefix="chip_smoke_gnn_")
    host = start_host_cells(host_work)

    def stop_host():
        if host["proc"].poll() is None:
            host["proc"].kill()
            host["proc"].wait()
        shutil.rmtree(host_work, ignore_errors=True)

    atexit.register(stop_host)
    # the truss phases' phi == oracle gates (~85 s of pure Python) run in a
    # worker from phase 17 on, beside device-bound phases, read at the end
    oracle = OracleChecks()
    atexit.register(oracle.pool.shutdown, cancel_futures=True)
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
    g, sec, initial = drive_main_path(core, edges, dev, oracle)
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
    oracle.submit("the truss path's final phi", g,
                  map(tuple, g.edge_list().tolist()))
    log(f"final phi to the oracle check; phases {sec}")
    del g
    torch.cuda.empty_cache()

    reset_counts(peel_wave, bitmap_support, flash_attention)
    t = time.perf_counter()
    svc_out = drive_service_path(edges, dev, oracle)
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
    cl_out = drive_cluster_path(edges, dev, oracle)
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
    lm = drive_lm_path(ops, flash_attention, dev)
    wgmma_paths = {f"{LM_ARCH} prefill":
                   flash_attention.LAUNCHES_BY_BODY["wgmma"]}
    log(f"LM path: {time.perf_counter() - t:.1f} s, launches "
        f"{flash_attention.LAUNCHES_BY_BODY}; {json.dumps(lm)}")

    # the SIMT body's path: gemma-2b's smoke config (gemma-2b at full width
    # runs in phase 18), with the counts set to 0 first
    reset_counts(peel_wave, bitmap_support, flash_attention)
    t = time.perf_counter()
    res = drive_simt_prefill(ops, flash_attention, dev)
    simt_paths = {f"{GEMMA_ARCH} smoke config prefill":
                  flash_attention.LAUNCHES_BY_BODY["simt"]}
    log(f"{GEMMA_ARCH} smoke config prefill path: "
        f"{time.perf_counter() - t:.1f} s, launches "
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

    # the cell plans: the dry-run's result, four plans on the card (K3,
    # K4's gathered and rows entries, K5; the counts set to 0 just before
    # each plan's call and read just after it), the expert branches
    plans = drive_plans(dev, card, dry, lt["recsys"]["peak_gb"])
    stop_dryrun()
    for cell, r in plans["plans"].items():
        if r["launches"]["flash_attention"]["wgmma"]:
            wgmma_paths[f"{cell} plan"] = r["launches"]["flash_attention"]["wgmma"]
    launches["flash_attention_wgmma"] += plans["launches"]["flash_attention_wgmma"]
    launches["segment_matmul_plans"] = plans["launches"]["segment_matmul"]
    launches["cin_plans"] = plans["launches"]["cin"]
    log(f"cell plans ({card}): {plans['phase_s']:.1f} s; launches "
        f"{plans['launches']}")

    # MoE training at full width (K3's wgmma body on mixtral's and
    # llama4-scout's donated AdamW steps); the counts are set to 0 inside, just
    # before each arch's run, and read just after it
    oracle.start()
    with expandable_segments():
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

    # the dense LM family at full width (K3's wgmma body on starcoder2-7b's
    # and gemma-2b's prefills and AdamW steps); the counts are set to 0
    # inside, just before each arch's serving and its steps, and read just
    # after them
    with expandable_segments():
        dn = drive_dense_family(dev, card)
    dense_paths = {}
    for arch_id, r in dn["archs"].items():
        for path, by in r["launches"].items():
            name = f"{arch_id} {path}" + (
                f" (depth {r['train']['layers']})" if path == "training"
                else "")
            if by["simt"]:
                raise AssertionError(f"{name} launched K3's SIMT body "
                                     f"{by['simt']} times")
            dense_paths[name] = by["wgmma"]
    wgmma_paths.update(dense_paths)
    launches["flash_attention_wgmma"] += sum(dense_paths.values())
    log(f"dense LM family ({card}): {dn['phase_s']:.1f} s; K3's wgmma body "
        f"launched {dense_paths}")

    # the GNN family at its cells' global shapes (K4's rows entry); the
    # counts are set to 0 inside, just before each plan's call, and read
    # just after it
    gnn_cells = drive_gnn_cells(dev, card, host)
    stop_host()
    launches["segment_matmul_cells"] = gnn_cells["launches"]
    log(f"GNN cells ({card}): {gnn_cells['phase_s']:.1f} s; K4 launched "
        f"{gnn_cells['launches']} times in {len(gnn_cells['cells'])} plan steps")
    # decode_32k for the five LM archs and mixtral-8x7b's long_500k through
    # their plans (decode bypasses K3: no kernel may launch), and
    # prefill_32k for the four archs of PREFILL_ARCHS (K3's wgmma body once
    # a layer a call); the counts are set to 0 inside, just before each
    # cell's plan call, and read just after it
    dc = drive_decode_cells(dev, card)
    for arch_id, by in dc["prefill_launches"].items():
        wgmma_paths[f"{arch_id} prefill_32k plan"] = by["wgmma"]
        launches["flash_attention_wgmma"] += by["wgmma"]
    log(f"decode and prefill cells ({card}): {dc['phase_s']:.1f} s; "
        + "; ".join(
            f"{cell} batch {r['batch']} at {r['layers']} layers: wave "
            f"{r['wave_ms_median']:.1f} ms (bound {r['bound_ms']:.1f} ms), "
            f"peak {r['peak_gb']:.2f} GB" if "wave_ms_median" in r else
            f"{cell} batch {r['cut']['batch']} at {r['cut']['layers']} layers:"
            f" {r['call_s_median']:.3f} s a call, {r['tokens_per_s']:,.0f} "
            f"tokens/s, peak {r['peak_gb']:.2f} GB (reckoned "
            f"{r['reckoned_gb']:.2f})" for cell, r in dc["cells"].items()))

    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its path")
    t = time.perf_counter()
    oracle_s = oracle.finish()
    log(f"phi == oracle ({card}; the worker's seconds each, from phase 17 "
        f"on; waited for {time.perf_counter() - t:.1f} s at the end): "
        f"{json.dumps(oracle_s)}")

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
    for k3 in (moe["k3"], dn["k3"]):       # the MoE and dense model layouts
        for key, r in k3["layouts"].items():
            kernels[2]["layouts"][r["layout"]] = {
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["sdpa_ms"]}
        kernels[2]["max_abs_err"] = max([kernels[2]["max_abs_err"]] + [
            e for name, e in k3["errs"].items() if "SDPA" not in name])
    # K4: the recsys path's entry (declared sorted, the mean fused) at
    # bulk; the sum and sorting entries and the p99 shape under "entries";
    # the training path's rows entry under "training_rows_entry"
    k4 = k45_time["segment_matmul serve_bulk"]
    k4_timing = (k4["ms"]["mean"], k4["ms"]["plain_mean"],
                 k4["ms"]["embedding_bag_mean"], k4["bound_ms"], k4["bound_by"])
    extra_errs = {"segment_matmul": [v["max_abs_err"] for v in
                                     tr["k4_shapes"].values()] + [
        e for a in list(tr["arch_vs_plain"].values())
        + [c["vs_plain"] for c in gnn_cells["cells"].values()]
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
            + launches[f"{name}_plans"] + launches.get(f"{name}_cells", 0),
            "max_abs_err": max([e for k, e in k45_errs.items()
                                if k.startswith(name)] + extra_errs[name]),
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lms})
    kernels[-2]["path"] = {"recsys": launches["segment_matmul"],
                           "training": tr_launches["segment_matmul"],
                           "recsys training": rs_tr["segment_matmul"],
                           "cell plans": launches["segment_matmul_plans"],
                           "gnn cells": launches["segment_matmul_cells"]}
    kernels[-2]["gnn_cells_rows_entry"] = gnn_cells["cells"][
        "/".join(PROFILED_CELL)]["k4_shapes"]
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
        f" s), phase 17 {mt['phase_s']:.1f} s, phase 18 "
        f"{dn['phase_s']:.1f} s, phase 19 {gnn_cells['phase_s']:.1f} s, "
        f"phase 20 {dc['phase_s']:.1f} s ({os.cpu_count()} host cores)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
