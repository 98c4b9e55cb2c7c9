#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Reads the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/csrc`` with ``nvcc`` and prints the build seconds.
2. Holds each kernel (``peel_wave``, ``bitmap_support``) bitwise against its
   plain PyTorch version on the card: at the unit-test shapes (row and word
   slabs, words with bit 31 set) and at the slice's width on a 65,536-row
   chunk of the slashdot-like bitmap; then times one full wave of each at
   that shape (CUDA events, median) beside its bound and the plain version.
3. Drives the main path: ``DynamicGraph(support_method="bitmap")`` on the
   slashdot-like power-law graph (77,360 nodes, 980,614 edges), checked
   against the pure-Python oracle; three fused 2,000-update batches, a few
   progressive single updates, one batch with ``engine="recompute"``, one
   more batch of each engine under ``torch.profiler``, then
   ``max_truss``/``k_truss``/``index.query`` checked against a host
   connected-components pass, and a final from-scratch oracle check.
4. Fails unless both kernels were launched by the main path, prints the
   kernels line, the card line, and last the device line.

Every failed check raises, so the exit code is non-zero.  The script needs
a CUDA device, ``nvcc`` and the rest of this checkout; it imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_NODES, M_PER_NODE, N_EDGES = 77_360, 12, 980_614   # configs SLASHDOT analogue
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT_OPS_PER_S = 67e12         # the card's non-tensor-core peak (fp32 table row)
TEST_SHAPES = ((1, 1), (7, 3), (64, 32), (130, 37), (513, 129))
CHUNK_ROWS = 65_536


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


def bound_ms(bitmap, rows_used: int, slot_bytes: int, n_slots: int,
             word_pairs: int):
    """Least time for the work: bitmap rows the inputs touch read once plus
    the per-slot inputs and outputs, over device-memory bandwidth; or one
    AND, one POPC and one add per word pair over the peak rate.  Returns
    (ms, 'bytes' | 'operations', bytes)."""
    n_bytes = rows_used * bitmap.shape[1] * 4 + slot_bytes * n_slots
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 3 * word_pairs / INT_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", n_bytes)


def full_width_checks(core, ops, ref, edges, dev):
    """Parity on a 65,536-row chunk of the real bitmap and one full wave of
    each kernel timed at the slice's shape (all edges alive)."""
    spec = core.GraphSpec(N_NODES, d_max=2 * int(np.bincount(
        edges.reshape(-1)).max()), e_cap=2 * len(edges))
    st = core.from_edge_list(spec, edges, dev)
    bm = core.build_bitmap(spec, st, st.active)
    eu = torch.clamp(st.edges[:, 0], max=N_NODES - 1).contiguous()
    ev = torch.clamp(st.edges[:, 1], max=N_NODES - 1).contiguous()
    alive = st.active.clone()
    k = torch.tensor(3, dtype=torch.int32, device=dev)
    log(f"bitmap {tuple(bm.shape)} int32 = {bm.numel() * 4 / 1e6:.0f} MB, "
        f"e_cap {spec.e_cap}, alive {int(alive.sum())}")

    c = slice(0, CHUNK_ROWS)
    err1 = 0
    for g, x, name in zip(ops.peel_wave_gathered(bm, eu[c], ev[c], alive[c], k),
                          ref.peel_wave_gathered_ref(bm, eu[c], ev[c], alive[c], k),
                          ("sup", "kill")):
        err1 = max(err1, check_equal(g, x, f"K1 full-width chunk {name}"))
    err2 = check_equal(ops.bitmap_support_gathered(bm, eu[c], ev[c]),
                       ref.bitmap_support_gathered_ref(bm, eu[c], ev[c]),
                       "K2 full-width chunk")
    log(f"full-width chunk ({CHUNK_ROWS} rows, W {bm.shape[1]}): kernels == "
        f"plain versions (tolerance: bitwise; max abs err {max(err1, err2)})")

    timings = {}
    for name, call in (
            ("peel_wave",
             lambda: ops.peel_wave_gathered(bm, eu, ev, alive, k,
                                            chunk=CHUNK_ROWS)),
            ("bitmap_support",
             lambda: ops.bitmap_support_gathered(bm, eu, ev,
                                                 chunk=CHUNK_ROWS))):
        ms = time_ms(call, 10)
        ops.use_kernels(False)       # the same call through the plain version
        try:
            plain_ms = time_ms(call, 3)
        finally:
            ops.use_kernels(True)
        timings[name] = (ms, plain_ms)
    # data-dependent bounds: K1 loads rows of alive edges only; K2 (no
    # mask) loads every slot's pair, sentinel slots reading node n-1
    n_alive, w = int(alive.sum()), bm.shape[1]
    rows1 = int(torch.unique(torch.cat([eu[alive], ev[alive]])).numel())
    rows2 = int(torch.unique(torch.cat([eu, ev])).numel())
    b1 = bound_ms(bm, rows1, 4 + 4 + 1 + 4 + 1, spec.e_cap, n_alive * w)
    b2 = bound_ms(bm, rows2, 4 + 4 + 4, spec.e_cap, spec.e_cap * w)
    stream = 2 * n_alive * w * 4
    log(f"streaming both rows of every alive edge instead: {stream / 1e9:.2f} "
        f"GB = {1e3 * stream / HBM_BYTES_PER_S:.2f} ms at device bandwidth")
    for name, (ms, pms), (bms, by, nb) in (
            ("peel_wave", timings["peel_wave"], b1),
            ("bitmap_support", timings["bitmap_support"], b2)):
        log(f"{name}: one full wave {ms:.3f} ms (bound {bms:.3f} ms by {by}: "
            f"{nb / 1e6:.1f} MB; plain {pms:.1f} ms)")
    del st, bm
    torch.cuda.empty_cache()
    return {"peel_wave": (err1, *timings["peel_wave"], *b1[:2]),
            "bitmap_support": (err2, *timings["bitmap_support"], *b2[:2])}


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


def profiled(fn):
    """Run ``fn`` under ``torch.profiler``; log the device's busy share of
    the wall time (a lower bound: the profiler slows the host) and the
    kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    sync("cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync("cuda")
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    log(f"profile: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%); top device time:")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"  {us / 1e3:9.1f} ms  x{n:<6d} {key[:90]}")


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
        if profile:
            profiled(lambda: g.apply_batch(ups, **kw))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import core
    from repro_torch.data.synthetic import powerlaw_graph
    from repro_torch.kernels import _build, bitmap_support, ops, peel_wave, ref

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t = time.perf_counter()
    lib_path = _build.build("bitmap_popcount")
    _build.library()
    log(f"kernels built in {time.perf_counter() - t:.1f} s -> {lib_path}")
    log((lib_path.parent / "build.log").read_text().strip())

    err = check_test_shapes(ops, ref, dev)
    log(f"test shapes: kernels == plain versions (tolerance: bitwise; "
        f"max abs err {err})")

    edges = powerlaw_graph(N_NODES, M_PER_NODE, seed=0)
    if len(edges) != N_EDGES:
        raise AssertionError(f"powerlaw_graph gave {len(edges)} edges, "
                             f"expected {N_EDGES}")
    full = full_width_checks(core, ops, ref, edges, dev)

    peel_wave.LAUNCHES = bitmap_support.LAUNCHES = 0
    t = time.perf_counter()
    g, sec = drive_main_path(core, edges, dev)
    launches = {"peel_wave": peel_wave.LAUNCHES,
                "bitmap_support": bitmap_support.LAUNCHES}
    log(f"main path: {time.perf_counter() - t:.1f} s, launches {launches}")
    t = time.perf_counter()
    final = g.edge_list()
    if g.phi_dict() != core.oracle.scratch_phi(N_NODES, map(tuple, final.tolist())):
        raise AssertionError("final phi differs from a from-scratch oracle")
    log(f"final phi == oracle over {len(final)} edges "
        f"({time.perf_counter() - t:.1f} s); phases {sec}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    sources = {"peel_wave": "src/repro/kernels/peel_wave.py:50",
               "bitmap_support": "src/repro/kernels/bitmap_support.py:41"}
    kernels = []
    for name in ("peel_wave", "bitmap_support"):
        err_k, ms, pms, bms, by = full[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/bitmap_popcount.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": max(err_k, err), "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
