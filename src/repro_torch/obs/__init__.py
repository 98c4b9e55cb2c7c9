"""Observability for the port: copies of ``repro.obs``'s host-side plane
(``state``, ``metrics``, ``trace``, ``flightrec``, ``expo``: Prometheus
text and the ``/metrics`` + ``/healthz`` server, ``slo``: burn-rate
objectives, ``merge``: the cross-process trace merge), the
``torch.profiler`` twin of its profiler hooks (``profiling``), plus the
process-wide enable switch."""
from __future__ import annotations

from contextlib import contextmanager

from . import (expo, flightrec, merge, metrics,  # noqa: F401 — re-exports
               profiling, slo, trace)
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
