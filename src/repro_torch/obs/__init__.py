"""Observability for the port: the metrics registry, the span trace and
the flight recorder, copied from ``repro.obs`` (``state``, ``metrics``,
``trace``, ``flightrec``), the profiler hook's API (``profiling``: a no-op
until armed, and armed it raises until its ``torch.profiler`` twin lands,
ROADMAP item 12), plus the process-wide enable switch.  The exposition
server and SLOs are ROADMAP item 12 too."""
from __future__ import annotations

from contextlib import contextmanager

from . import metrics, trace  # noqa: F401 — re-exports
from .state import STATE


def is_enabled() -> bool:
    """Whether telemetry recording is currently on."""
    return STATE.enabled


def enable(on: bool = True):
    """Turn telemetry recording on/off process-wide."""
    STATE.enabled = bool(on)


@contextmanager
def disabled():
    """Context manager: suspend all telemetry recording inside the block
    (metrics increments, span recording, instants all become no-ops)."""
    prev = STATE.enabled
    STATE.enabled = False
    try:
        yield
    finally:
        STATE.enabled = prev
