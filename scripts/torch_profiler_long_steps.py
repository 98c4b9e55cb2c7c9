#!/usr/bin/env python
"""Whether a ``torch.profiler`` session loses device records in the cases a
long training step meets: a card whose memory is full, a host that waits
on the card for seconds in the middle of the session, launches from
autograd's device thread, and the truss-filtered GCN step itself.

Variants (``REPS`` sessions each; pick some by name on the command line):

* ``free``: ``PRE`` small launches, ten 8192² products (the host runs
  ahead), one fresh 1.5 GiB allocation, ``POST`` small launches, with
  nothing in PyTorch's cache before the session;
* ``cached``: the same after the caching allocator has reserved the whole
  card in 1 GiB blocks and freed them into its cache (the fresh allocation
  then fails, the allocator releases its cache and retries);
* ``cached_no_grow``: that cache, the work without the fresh allocation;
* ``cached_then_empty``: ``cached``, then ``torch.cuda.empty_cache()``
  just before the session;
* ``long_wait``: ``WAIT_S`` of products queued, a host read of their
  result (the host waits on the card), then ``POST`` small launches;
* ``long_wait_thread``: the same, the launches after the read made from
  another host thread (as autograd's backward is);
* ``gcn_hub``: one AdamW step of gcn-cora at full width on a batch of
  77,360 nodes (1,433 features) whose 3,922,456 edge rows hold ~4,700 real
  edges and a padding hub, the step ``chip_smoke.py`` profiles in its
  training phase.

Each session opens as ``chip_smoke.profile_open`` does (20 ms of small
launches, a 2 ms gap, then the work's annotation).  A record is lost when
a CUDA runtime call inside the annotation that launched a kernel, a copy
or a fill has no device record with its correlation id.  Prints one JSON
line a session (free MiB before it; calls; lost; the first lost call's ms
after the work's first call; the threads of the calls and of the lost
ones; the longest gap between two calls and where it ends), then one
summary line a variant.  Needs a CUDA card::

    PYTHONPATH=src python scripts/torch_profiler_long_steps.py [REPS] [VARIANT ...]
"""
from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
SPAN = "work"
PRE, POST = 200, 2000
GROW_GB = 1.5
BLOCK = 1 << 30
WAIT_S = 1.8
WARMUP_S, GAP_S = 0.02, 0.002


def session_records(prof) -> dict:
    """The launch, copy and fill calls inside ``SPAN`` of one finished
    session, and those without a device record."""
    events = prof.profiler.kineto_results.events()
    span = next(e for e in events if e.name() == SPAN
                and e.device_type() == DeviceType.CPU)
    on_card = {e.correlation_id() for e in events
               if e.device_type() == DeviceType.CUDA and e.name() != SPAN}
    calls = sorted((e for e in events if e.device_type() == DeviceType.CPU
                    and span.start_ns() <= e.start_ns() <= span.end_ns()
                    and any(s in e.name() for s in ("LaunchKernel", "Memcpy",
                                                    "Memset"))),
                   key=lambda e: e.start_ns())
    first = calls[0].start_ns() if calls else 0
    lost = [e for e in calls if e.correlation_id() not in on_card]
    gaps = [(b.start_ns() - a.start_ns(), b.start_ns() - first)
            for a, b in zip(calls, calls[1:])]
    gap, at = max(gaps, default=(0, 0))
    return {"calls": len(calls), "lost": len(lost),
            "first_lost_ms": round((lost[0].start_ns() - first) / 1e6, 3)
            if lost else None,
            "threads": sorted({e.start_thread_id() for e in calls}),
            "lost_threads": sorted({e.start_thread_id() for e in lost}),
            "longest_gap_ms": round(gap / 1e6, 3),
            "gap_ends_ms": round(at / 1e6, 3)}


def session(work) -> dict:
    torch.cuda.synchronize()
    free_mib = torch.cuda.mem_get_info()[0] / 2**20
    warm = torch.zeros(1, device="cuda")
    with profile(activities=ACTIVITIES) as prof:
        end = time.perf_counter() + WARMUP_S
        while time.perf_counter() < end:
            warm.add_(1)
            torch.cuda.synchronize()
        time.sleep(GAP_S)
        with record_function(SPAN):
            work()
            torch.cuda.synchronize()
        time.sleep(GAP_S)
    return {"free_mib_before": round(free_mib, 1)} | session_records(prof)


def small_launches(n: int) -> None:
    x = torch.ones(1 << 16, device="cuda")
    for i in range(n):
        x = x + i


def products(seconds: float) -> torch.Tensor:
    """About ``seconds`` of fp32 8192² products, queued."""
    a = torch.randn(8192, 8192, device="cuda") / 90.0
    for _ in range(max(1, int(seconds / 0.018))):
        a = torch.tanh(a @ a)
    return a


def grow_work(grow: bool):
    def work():
        small_launches(PRE)
        products(0.18)
        if grow:
            y = torch.empty(int(GROW_GB * BLOCK) // 4, device="cuda")
            y.fill_(1.0)
            del y
        small_launches(POST)
    return work


def long_wait(thread: bool):
    def work():
        float(products(WAIT_S).sum())           # the host waits on the card
        if thread:
            t = threading.Thread(target=small_launches, args=(POST,))
            t.start()
            t.join()
        else:
            small_launches(POST)
    return work


def fill_cache() -> None:
    """Reserve the whole card in 1 GiB blocks, then free them into the
    caching allocator's cache."""
    held = []
    try:
        while True:
            held.append(torch.empty(BLOCK // 4, device="cuda"))
    except torch.OutOfMemoryError:
        pass
    del held


def gcn_hub_work():
    """The truss-filtered GCN step: gcn-cora at full width, 77,360 nodes
    of 1,433 features, ~4,700 real edges among 300 nodes padded to
    3,922,456 rows (the padding on node 77,359)."""
    from repro_torch.configs import get_config
    from repro_torch.data import sampler
    from repro_torch.models import gnn
    from repro_torch.training import optimizer as opt

    cfg = get_config("gcn-cora").model
    rng = np.random.default_rng(0)
    pairs = {tuple(sorted(p)) for p in rng.integers(0, 300, (6000, 2))
             if p[0] != p[1]}
    edges = np.asarray(sorted(pairs), np.int64)[:4700]
    nb = sampler.make_gnn_batch(edges, 77_360, 1_433, n_classes=cfg.n_classes,
                                pad_nodes=77_360, pad_edges=3_922_456, seed=0)
    batch = gnn.batch_to_torch(nb, "cuda")
    params = gnn.init_params(cfg, torch.Generator("cuda").manual_seed(0), 1_433)
    state = opt.adamw_init(params)
    step = opt.make_train_step(lambda p, b: gnn.loss_fn(cfg, p, b),
                               opt.AdamWConfig())
    step(params, state, batch)                   # build K4, warm the caches
    torch.cuda.synchronize()
    return lambda: step(params, state, batch)


def main() -> int:
    args = sys.argv[1:]
    reps = int(args.pop(0)) if args and args[0].isdigit() else 3
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {
        "free": (None, grow_work(True)),
        "cached": (fill_cache, grow_work(True)),
        "cached_no_grow": (fill_cache, grow_work(False)),
        "cached_then_empty": ("empty", grow_work(True)),
        "long_wait": (None, long_wait(False)),
        "long_wait_thread": (None, long_wait(True)),
        "gcn_hub": (None, None),
    }
    names = args or list(variants)
    grow_work(False)()                   # kernels loaded, cuBLAS set up
    torch.cuda.synchronize()
    rows = {}
    for name in names:
        prepare, work = variants[name]
        if name == "gcn_hub":
            work = gcn_hub_work()
        for rep in range(reps):
            torch.cuda.empty_cache()
            if prepare is fill_cache or prepare == "empty":
                fill_cache()
            if prepare == "empty":
                torch.cuda.empty_cache()
            r = {"variant": name, "rep": rep} | session(work)
            print(json.dumps(r), flush=True)
            rows.setdefault(name, []).append(r)
        work = None
        torch.cuda.empty_cache()
    for name, rr in rows.items():
        print(json.dumps({
            "variant": name, "sessions": len(rr),
            "sessions_with_lost": sum(1 for r in rr if r["lost"]),
            "lost": sum(r["lost"] for r in rr),
            "calls": sum(r["calls"] for r in rr)}))
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
