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
6. Times the attention kernel's bodies at ``[64, 4096, 128]`` bf16, at the
   prefill's GQA layout and at ``gemma-2b``'s layout (the wgmma body and
   the SIMT body asked for by name, in turns), each beside its bound, its
   plain version and ``scaled_dot_product_attention``.
7. Drives the LM serving path at the full width and depth of
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
8. Holds the recsys kernels against their plain versions on the
   reference's sweeps: the segment sum (``segment_matmul``, fp32 and fp16,
   ids outside the range, gathered entry; on the same ids sorted, the
   declared-sorted entry bitwise against the sorting entry and the mean
   entry against the plain mean; runs of up to 30,000 rows against a
   float64 sum; indices outside the table giving NaN bags; unsorted ids
   declared sorted giving an all-NaN output) and the CIN layer (``cin``).
9. Drives the xDeepFM serving path at full width (39 fields of 1,000,000
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
10. Fails unless every kernel was launched by its path (K1 and K2 on the
    truss path and on the service path), prints the kernels line, the
    card line, and last the device line.

Every failed check raises, so the exit code is non-zero.  The script needs
a CUDA device, ``nvcc`` and the rest of this checkout; it imports no JAX.
"""
from __future__ import annotations

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


def profiled(fn, forbid: str | None = None, require: str | None = None,
             detail: tuple = ()) -> float:
    """Run ``fn`` under ``torch.profiler``; log the device's busy share of
    the wall time and the device ops that took the most time.  Busy is the
    union of the intervals in which a kernel, copy or fill of ``fn`` ran
    on the card, over the host's wall time; a lower bound, since the
    profiler slows the host.  Raises if a launch, copy or fill of ``fn``
    lacks its device record (see ``PROFILE_WARMUP_S``), if a device op's
    name holds ``forbid`` or if none holds ``require`` (case ignored);
    logs the device time of the ops whose names hold each string of
    ``detail``.  Returns the busy share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync("cuda")
    warm = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        end = time.perf_counter() + PROFILE_WARMUP_S
        while time.perf_counter() < end:
            warm.add_(1)
            sync("cuda")
        time.sleep(PROFILE_GAP_S)
        with record_function(WORK_SPAN):
            t0 = time.perf_counter()
            fn()
            sync("cuda")
            wall = time.perf_counter() - t0
        time.sleep(PROFILE_GAP_S)
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
    """The port's main path at full width; returns the graph and the
    seconds of each phase."""
    sec = {}
    rng = np.random.default_rng(1)
    t = time.perf_counter()
    g = core.DynamicGraph(N_NODES, edges, support_method="bitmap", device=dev)
    sync(dev)
    sec["decompose"] = time.perf_counter() - t
    stats = core.stats_dict(g.last_peel_stats)
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
    return g, sec


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


def reset_counts(*mods) -> None:
    """Set the launch counts of the kernel modules to 0 (and K3's by body)."""
    for mod in mods:
        mod.LAUNCHES = 0
        for body in getattr(mod, "LAUNCHES_BY_BODY", ()):
            mod.LAUNCHES_BY_BODY[body] = 0


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
    g, sec = drive_main_path(core, edges, dev)
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on its path")

    sources = {"peel_wave": "src/repro/kernels/peel_wave.py:50",
               "bitmap_support": "src/repro/kernels/bitmap_support.py:41"}
    kernels = []
    # K1/K2: the top-level time is the digest body's (the path's) on a full
    # wave; "bodies" has both bodies in turns, K1 also at 10% and 1% alive,
    # host us a call, and the probe mappings; launches are the truss
    # path's and the service path's ("path" has each)
    for name in ("peel_wave", "bitmap_support"):
        f = full[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/bitmap_popcount.cu",
            "replaces": sources[name],
            "launches": launches[name] + svc_launches[name],
            "max_abs_err": max(f["err"], err), "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": None,
            "path": {"truss": launches[name],
                     "service": svc_launches[name]},
            "launches_by_body": {
                body: by_body[name][body] + svc_by_body[name][body]
                for body in by_body[name]},
            "bodies": f["bodies"]})
    kernels[0]["nonzero"] = full["nonzero"]
    kernels[0]["id_check_host_us"] = full["id_check_host_us"]
    # K3's bodies: the top-level times of the wgmma body are at qwen3's
    # [64, 4096, 128], those of the SIMT body at gemma-2b's MQA layout (in
    # turns with the wgmma body there); "layouts" has each body at each
    # layout it was timed at, "path" the paths that launched it
    layouts = {"flat": f"{list(K3_SHAPE)}",
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
                for key in ("flat", "gemma")}})
    # K4: the path's entry (declared sorted, the mean fused) at bulk; the
    # sum and sorting entries and the p99 shape under "entries"
    k4 = k45_time["segment_matmul serve_bulk"]
    k4_timing = (k4["ms"]["mean"], k4["ms"]["plain_mean"],
                 k4["ms"]["embedding_bag_mean"], k4["bound_ms"], k4["bound_by"])
    for name, source, replaces, timing in (
            ("segment_matmul", "segment_sum.cu",
             "src/repro/kernels/segment_matmul.py:44", k4_timing),
            ("cin", "cin.cu", "src/repro/kernels/cin.py:46", k45_time["cin"])):
        ms, pms, lms, bms, by = timing
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(e for k, e in k45_errs.items()
                               if k.startswith(name)),
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lms})
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
                        "compile": k5_compile})
    log(f"recsys outputs: {json.dumps(out_errs)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
