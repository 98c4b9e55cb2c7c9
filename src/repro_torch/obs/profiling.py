"""Gated ``torch.profiler`` hooks around the stack's expensive regions (the
twin of ``repro.obs.profiling``'s ``jax.profiler`` hooks).

Off by default: ``profile_region("flush")`` is a no-op until
``configure(profile_dir)`` arms it (the ``serve_truss --profile-dir`` flag
does).  Once armed, entering a region starts a ``torch.profiler`` session
and exiting stops it and writes one Chrome trace to
``<profile_dir>/<region>-<n>.json`` (``chrome://tracing`` or Perfetto), so
a serving run leaves one trace per flush/decompose beside the host-side
span trace from ``obs.trace``.

Two guards keep this safe in a serving loop, as in the reference: sessions
don't nest, so a region entered inside an active region records nothing
extra (reentrance guard); and ``max_traces`` caps how many traces a long
run writes.

With a card present the session records the device too, behind a guard:
``torch.profiler`` can drop the device records of a session's first
launches (up to 14, within the first 4.4 ms of work, on an H100).  So the
session first launches small kernels for ``WARMUP_S`` and idles
``GAP_S``, the region runs inside a ``WORK_SPAN`` annotation, and after
the export ``lost_records`` matches every launch, copy and fill issued
inside that annotation to its device record by correlation id; a region
whose trace lacks one raises ``RuntimeError`` (its file is kept).

**Unlike the reference**, a profiler that fails to start raises
``RuntimeError`` instead of silently recording nothing (ROADMAP R5): an
armed run either leaves its traces or fails.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager

_DIR: str | None = None
_MAX = 8
_COUNT = 0
_ACTIVE = False

WARMUP_S = 0.02     # small launches before the work (see module docstring)
GAP_S = 0.002       # idle time on either side of the work
WORK_SPAN = "profile_region.work"
_CALLS = ("LaunchKernel", "Memcpy", "Memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def configure(profile_dir: str | None, max_traces: int = 8):
    """Arm (or, with ``None``, disarm) profiling into ``profile_dir``;
    at most ``max_traces`` traces are recorded per process."""
    global _DIR, _MAX, _COUNT
    _DIR = profile_dir
    _MAX = int(max_traces)
    _COUNT = 0
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)


def is_configured() -> bool:
    """Whether a profile directory is armed and under its trace cap."""
    return _DIR is not None and _COUNT < _MAX


def lost_records(path: str) -> tuple[int, list]:
    """Read one Chrome trace this module wrote and match each runtime call
    that launches a kernel, a copy or a fill inside ``WORK_SPAN`` to its
    device record by correlation id.  Returns ``(issued, lost)``: the
    number of such calls and the ``(name, correlation)`` of each without a
    record.  A trace without device activity has no calls to match."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("name") == WORK_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        return 0, []
    t0 = min(float(e["ts"]) for e in spans)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in spans)
    on_card = {(e.get("args") or {}).get("correlation") for e in events
               if e.get("cat") in _DEVICE_CATS}
    calls = [e for e in events if e.get("cat") in _RUNTIME_CATS
             and any(s in e.get("name", "") for s in _CALLS)
             and t0 <= float(e["ts"]) <= t1]
    lost = [(e["name"], (e.get("args") or {}).get("correlation"))
            for e in calls
            if (e.get("args") or {}).get("correlation") not in on_card]
    return len(calls), lost


def _warm_up():
    """Launch small kernels for ``WARMUP_S``, then idle ``GAP_S``."""
    import torch

    warm = torch.zeros(1, device="cuda")
    end = time.perf_counter() + WARMUP_S
    while time.perf_counter() < end:
        warm.add_(1)
        torch.cuda.synchronize()
    time.sleep(GAP_S)


@contextmanager
def profile_region(name: str):
    """Context manager: a ``torch.profiler`` trace around the block when
    armed (no-op otherwise; reentrant regions record once).  Raises
    ``RuntimeError`` when the profiler fails to start, and after the block
    when the trace lacks a device record of the work."""
    global _COUNT, _ACTIVE
    if not is_configured() or _ACTIVE:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    path = os.path.join(_DIR, f"{name}-{_COUNT}.json")
    _COUNT += 1
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    _ACTIVE = True
    try:
        try:
            prof.start()
        except Exception as exc:
            raise RuntimeError(
                f"profile_region({name!r}): torch.profiler failed to start "
                f"({exc!r}); an armed run records every region or fails "
                "(call configure(None) to disarm)") from exc
        try:
            if on_card:
                _warm_up()
            with record_function(WORK_SPAN):
                yield
            if on_card:
                torch.cuda.synchronize()
                time.sleep(GAP_S)
        finally:
            prof.stop()
        prof.export_chrome_trace(path)
    finally:
        _ACTIVE = False
    issued, lost = lost_records(path)
    if lost:
        raise RuntimeError(
            f"profile_region({name!r}): {path} lacks the device records of "
            f"{len(lost)} of the {issued} launches and copies issued in the "
            f"region: {lost[:20]}")
