"""The traced part of a ``--trace 1`` run: a ``torch.profiler`` session
over the window's first calls, read into device-op intervals.

Copied from the port's smoke script (``chip_smoke.profile_open`` /
``profiled``): a session can lack the device records of its first
launches, so it launches small kernels for ``WARMUP_S`` and idles
``GAP_S`` before the traced work, and only calls inside the work's
annotation count.  Busy time is the union of the device intervals of those
calls; an idle gap is named by the innermost host event that covers its
start.
"""
from __future__ import annotations

import time

import torch

from .drive import sync

WARMUP_S = 0.02
GAP_S = 0.002
WORK_SPAN = "perfbench.traced"
TOP = 10


class Session:
    """A profiler session open from construction to ``close``; on a CPU
    (the harness's tests) it records host events only."""

    def __init__(self, device="cuda"):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.device = device
        on_card = torch.device(device).type == "cuda"
        sync(device)
        warm = torch.zeros(1, device=device)
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))
        self.prof.__enter__()
        end = time.perf_counter() + WARMUP_S
        while time.perf_counter() < end:
            warm.add_(1)
            sync(device)
        time.sleep(GAP_S)
        self.span = record_function(WORK_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()
        self.wall = None

    def close(self) -> None:
        sync(self.device)
        self.wall = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        time.sleep(GAP_S)
        self.prof.__exit__(None, None, None)


class Trace:
    """What a closed ``Session`` recorded: ``ops`` as ``(name, start_ns,
    end_ns)`` device records of the calls inside the work span, ``lost``
    calls without a device record, ``busy_s``, ``wall_s``, ``by_name``
    (name -> seconds), ``gaps`` (the longest idle intervals, named)."""

    def __init__(self, session: Session):
        from torch.autograd import DeviceType

        events = session.prof.profiler.kineto_results.events()
        span = next(e for e in events if e.name() == WORK_SPAN
                    and e.device_type() == DeviceType.CPU)
        lo, hi = span.start_ns(), span.end_ns()
        on_card = {e.correlation_id(): e for e in events
                   if e.device_type() == DeviceType.CUDA
                   and not e.name().startswith("perfbench.")}
        host = [e for e in events if e.device_type() == DeviceType.CPU
                and lo <= e.start_ns() <= hi and e.name() != WORK_SPAN]
        # the benchmark's spans have device-side copies (annotations), which
        # are no device work
        calls = [e for e in host if any(s in e.name() for s in
                                        ("LaunchKernel", "Memcpy", "Memset"))]
        self.ops, self.lost = [], 0
        for e in calls:
            r = on_card.get(e.correlation_id())
            if r is None:
                self.lost += 1
            else:
                self.ops.append((r.name(), r.start_ns(), r.end_ns()))
        self.ops.sort(key=lambda r: r[1])
        self.wall_s = session.wall
        self.by_name: dict = {}
        for name, a, b in self.ops:
            self.by_name[name] = self.by_name.get(name, 0.0) + (b - a) / 1e9
        busy, last, gaps = 0, None, []
        for _, a, b in self.ops:
            if last is not None and a > last:
                gaps.append((last, a))
            busy += max(b - (a if last is None else max(a, last)), 0)
            last = b if last is None else max(last, b)
        if self.ops:
            gaps += [(lo, self.ops[0][1]), (last, hi)]
        self.busy_s = busy / 1e9
        spans = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in host
                        if not any(s in e.name() for s in ("cuda", "Cuda"))),
                       key=lambda s: s[0])
        named = []
        gaps = [g for g in gaps if g[1] > g[0]]
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
            inner = [s for s in spans if s[0] <= a <= s[1]]
            name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "host idle"
            outer = [s[2] for s in inner if s[2].startswith("perfbench.")]
            if outer and outer[-1] != name:
                name = f"{outer[-1]} / {name}"
            named.append([name, (b - a) / 1e9])
        self.gaps = named

    def top_ops(self, n: int = TOP) -> list:
        return [[k, v] for k, v in sorted(self.by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def seconds_of(self, part: str) -> float:
        """Device seconds of the ops whose names hold ``part``."""
        return sum(v for k, v in self.by_name.items() if part in k)
