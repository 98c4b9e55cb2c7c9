"""Observability for the port: the metrics registry and the span trace,
copied from ``repro.obs`` (``state``, ``metrics``, ``trace``), plus the
process-wide enable switch.  The exposition server, SLOs, flight recorder
and the profiler hook arrive with the service layer."""
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
