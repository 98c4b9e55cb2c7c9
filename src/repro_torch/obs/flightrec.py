"""Flight recorder: always-on activity ring + postmortem bundle dumps.

The recorder keeps a bounded, always-on ring of recent operational facts
(WAL-op summaries noted by the engine at each commit, periodic metric
deltas) next to the span ring the tracer already maintains.  Recording is
O(1) deque appends gated on the same ``repro_torch.obs`` enable flag as every
other telemetry site, so the hot-path cost shows up in — and is bounded
by — ``benchmarks/obs_overhead.py``.

When the degradation ladder fires (circuit-breaker open, generation
quarantine, scrub violation, SLO violation), the owner of the failure
calls :meth:`FlightRecorder.trip`.  If a postmortem directory has been
configured (``serve_truss --postmortem-dir``), ``trip`` freezes the
evidence into one self-contained JSON bundle: the trigger and its context,
a trace excerpt (most recent spans), a full metrics-registry snapshot, the
ring of WAL-op summaries and metric deltas, plus whatever *providers* the
stack registered — commit frontier, engine config, scrub report, SLO
state, and the chaos schedule when a seeded ``FaultyIO`` is active.
Without a directory, ``trip`` only counts (``truss_postmortem_*``
metrics) — the ring keeps flying either way.

Bundles are written atomically (tmp + rename) and capped at ``max_dumps``
per process so a flapping breaker cannot fill a disk.  See
"Reading a postmortem" in ``docs/OBSERVABILITY.md``.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque

from . import metrics as _metrics
from . import trace as _trace
from .state import STATE

_TRIP_N = _metrics.counter(
    "truss_postmortem_trips_total",
    "degradation-ladder firings seen by the flight recorder, by trigger",
    labels=("trigger",))
_DUMP_N = _metrics.counter(
    "truss_postmortem_dumps_total", "postmortem bundles written to disk")

#: Number of most-recent spans frozen into a bundle's trace excerpt.
TRACE_EXCERPT = 256


def _jsonable(obj):
    """Best-effort JSON coercion for numpy scalars and exotic values."""
    for cast in (int, float):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return repr(obj)


class FlightRecorder:
    """Bounded ring of recent operational facts + postmortem dumping."""

    def __init__(self, capacity: int = 512, tracer=None, registry=None,
                 wall_clock=time.time):
        self.capacity = int(capacity)
        self.tracer = tracer if tracer is not None else _trace.TRACER
        self.registry = registry if registry is not None else _metrics.REGISTRY
        self.wall_clock = wall_clock
        self._notes: deque = deque(maxlen=self.capacity)
        self._deltas: deque = deque(maxlen=64)
        self._last_counts: dict | None = None
        self._last_tick = None
        self.min_tick_s = 0.25
        self.out_dir: str | None = None
        self.max_dumps = 16
        self.providers: dict = {}
        self.dumps: list[str] = []

    # -- configuration --------------------------------------------------------

    def configure(self, out_dir: str | None = None, max_dumps: int = 16,
                  **providers) -> "FlightRecorder":
        """Set the postmortem directory (created if missing) and register
        named providers — zero-arg callables whose results are embedded in
        every bundle under their name.  ``out_dir=None`` leaves any
        previously configured directory in place, so providers can be
        registered in a later call (``reset`` clears the directory).
        Returns self for chaining."""
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self.out_dir = out_dir
        self.max_dumps = int(max_dumps)
        self.providers.update(providers)
        return self

    def provider(self, name: str, fn):
        """Register/replace one named bundle provider."""
        self.providers[name] = fn

    def reset(self):
        """Forget everything: ring, deltas, dumps, directory, providers.
        (Tests use this; the process-global ``FLIGHT`` is long-lived.)"""
        self._notes.clear()
        self._deltas.clear()
        self._last_counts = None
        self._last_tick = None
        self.out_dir = None
        self.max_dumps = 16
        self.providers = {}
        self.dumps = []

    # -- always-on recording --------------------------------------------------

    def note(self, kind: str, **fields):
        """Append one WAL-op/operational summary to the ring (O(1); no-op
        while obs is disabled)."""
        if STATE.enabled:
            self._notes.append({"kind": kind, "t_wall": self.wall_clock(),
                                **fields})

    def tick(self):
        """Record a metric-delta sample (counter movements since the last
        tick) into the delta ring; internally rate-limited so callers can
        invoke it from any periodic hook without thinking about cost."""
        if not STATE.enabled:
            return
        now = self.wall_clock()
        if self._last_tick is not None and now - self._last_tick < self.min_tick_s:
            return
        self._last_tick = now
        counts = {}
        for name, fam in self.registry.families().items():
            if fam.kind != "counter":
                continue
            counts[name] = sum(c.value for c in fam.children().values())
        if self._last_counts is not None:
            delta = {k: v - self._last_counts.get(k, 0)
                     for k, v in counts.items()
                     if v != self._last_counts.get(k, 0)}
            self._deltas.append({"t_wall": now, "delta": delta})
        self._last_counts = counts

    # -- tripping -------------------------------------------------------------

    def trip(self, trigger: str, **context) -> str | None:
        """The degradation ladder fired: count it, and when a postmortem
        directory is configured, dump a bundle.  Returns the bundle path
        (or ``None`` when only counted)."""
        _TRIP_N.labels(trigger=trigger).inc()
        if self.out_dir is None or len(self.dumps) >= self.max_dumps:
            return None
        bundle = self._bundle(trigger, context)
        path = os.path.join(
            self.out_dir, f"postmortem-{len(self.dumps):03d}-{trigger}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=1, default=_jsonable)
        os.replace(tmp, path)
        self.dumps.append(path)
        _DUMP_N.inc()
        return path

    def _bundle(self, trigger: str, context: dict) -> dict:
        events = self.tracer.events()[-TRACE_EXCERPT:]
        snap = {}
        for name, fam in self.registry.snapshot().items():
            snap[name] = {**fam,
                          "values": {",".join(k): v
                                     for k, v in fam["values"].items()}}
        out = {
            "format": "truss-postmortem-v1",
            "trigger": trigger,
            "trigger_context": context,
            "t_wall": self.wall_clock(),
            "trace_excerpt": [_trace.event_dict(e) for e in events],
            "trace_dropped": self.tracer.dropped(),
            "metrics": snap,
            "wal_ops": list(self._notes),
            "metric_deltas": list(self._deltas),
        }
        for name, fn in self.providers.items():
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — a postmortem must not raise
                out[name] = {"error": repr(e)}
        return out


FLIGHT = FlightRecorder()
