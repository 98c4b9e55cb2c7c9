#!/usr/bin/env python
"""How often a ``torch.profiler`` session loses the device records of its
first kernels, and what the session can do about it.

Runs, for ``SECONDS`` (default 120), rounds of: a few large matrix
products outside the profiler, then three profiler sessions around the
same small piece of work (seven PyTorch kernels, one K2 launch of
``repro_torch``, one copy back to the host):

* ``plain``: the work right after the session starts;
* ``warm``: a scheduled warm-up step first (``schedule(wait=0, warmup=1,
  active=1)``), the work in the active step;
* ``pause``: the session idles 5 ms before the work.

A record is lost when a CUDA runtime call that launched a kernel or a copy
has no device record with its correlation id.  Prints each session that
lost records, then per variant the sessions, those that lost records, the
records lost and the device record counts seen.  Needs a CUDA card::

    PYTHONPATH=src python scripts/torch_profiler_window.py [SECONDS]
"""
from __future__ import annotations

import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch.kernels import bitmap_support as bs

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
PAUSE_S = 0.005


def records(prof) -> dict:
    """Device records, runtime launches and copies, and the launches
    without a device record, of one finished session."""
    events = prof.profiler.kineto_results.events()
    on_card = {e.correlation_id() for e in events
               if e.device_type() == DeviceType.CUDA}
    issued = [e for e in events if e.device_type() == DeviceType.CPU
              and any(s in e.name() for s in ("LaunchKernel", "Memcpy",
                                              "Memset"))]
    return {"device": len(on_card), "issued": len(issued),
            "lost": sum(e.correlation_id() not in on_card for e in issued)}


def main() -> int:
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 120.0
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = "cuda"
    bm = torch.randint(-2**31, 2**31 - 1, (1000, 64), dtype=torch.int32,
                       device=dev)
    ids = torch.randint(0, 1000, (5000,), dtype=torch.int32, device=dev)
    big = torch.randn(4096, 4096, device=dev)

    def work():
        x = torch.ones(1000, device=dev)
        for i in range(6):
            x = x + i
        bs.bitmap_support_cuda(bm, bm, ids, ids, body="direct")
        torch.cuda.synchronize()

    def plain():
        with profile(activities=ACTIVITIES) as p:
            work()
        return p

    def warm():
        with profile(activities=ACTIVITIES, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as p:
            torch.cuda.synchronize()
            p.step()
            work()
            p.step()
        return p

    def pause():
        with profile(activities=ACTIVITIES) as p:
            time.sleep(PAUSE_S)
            work()
        return p

    work()
    variants = {"plain": plain, "warm": warm, "pause": pause}
    rows = {name: [] for name in variants}
    t0, rnd = time.time(), 0
    while time.time() - t0 < seconds:
        for _ in range(5):
            big @ big
        torch.cuda.synchronize()
        for name, fn in variants.items():
            r = records(fn())
            rows[name].append(r)
            if r["lost"]:
                print(json.dumps({"variant": name, "round": rnd,
                                  "t_s": round(time.time() - t0, 1)} | r),
                      flush=True)
        rnd += 1
    for name, rr in rows.items():
        print(json.dumps({
            "variant": name, "sessions": len(rr),
            "sessions_with_lost": sum(1 for r in rr if r["lost"]),
            "lost": sum(r["lost"] for r in rr),
            "issued": sum(r["issued"] for r in rr),
            "device_counts": sorted({r["device"] for r in rr})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
