"""Ring-buffered structured trace: spans, JSONL, Chrome trace_event export.

``span("gen.dispatch", gen=7)`` opens a context-managed span; on exit a
``SpanEvent`` (name, start, duration, parent/depth, attributes) lands in a
fixed-capacity ring buffer — old events are overwritten, recording never
blocks or grows.  The clock is injectable (``Tracer(clock=...)``) so tests
drive nesting and durations deterministically; the default is
``time.perf_counter_ns`` (monotonic).

Spans nest per tracer via an explicit stack: ``parent`` is the enclosing
span's ``seq`` (-1 at top level) and ``depth`` its stack depth, so the
flush→dispatch→land overlap of the pipelined service reads directly off
the event list.  Attributes set after work completes
(``sp.set(waves=3)``) attach per-wave ``PeelStats`` data to the span that
ran the peel instead of a return value callers must remember to keep.

Exports:

* ``TraceWriter`` — incremental JSONL (one event dict per line);
* ``chrome_trace``/``write_chrome`` — Chrome ``trace_event`` JSON ("X"
  complete events, microsecond timestamps) loadable in ``chrome://tracing``
  / Perfetto; see ``docs/OBSERVABILITY.md`` for how to read one.

Recording is a no-op (a shared null span) while ``repro.obs`` is disabled.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import NamedTuple

from . import metrics as _metrics
from .state import STATE

_DROPPED_N = _metrics.counter(
    "truss_trace_dropped_total",
    "spans overwritten by trace ring wrap-around (never re-exportable)")
_RING_HW_G = _metrics.gauge(
    "truss_trace_ring_highwater",
    "high-water mark of buffered spans in the trace ring")


class TraceContext(NamedTuple):
    """W3C-traceparent-style identity for one end-to-end request.

    ``trace_id`` (32 lowercase hex chars) names the whole router -> primary
    -> replica journey; ``span_id`` (16 hex chars) names the hop that is
    currently propagating it.  Minted once at the serving edge
    (``QueryRouter``/``serve_truss``), carried on ``QueryRequest``/
    ``WriteAck``, stamped into the WAL as an annotation record, and bound
    onto a tracer (``Tracer.bind``) so every span recorded under it carries
    a ``trace_id`` attribute that ``repro.obs.merge`` can join on.
    """

    trace_id: str
    span_id: str

    @classmethod
    def mint(cls) -> "TraceContext":
        """A fresh random context (new trace id, new span id)."""
        return cls(os.urandom(16).hex(), os.urandom(8).hex())

    def child(self) -> "TraceContext":
        """Same trace, new hop id — what a downstream component binds."""
        return TraceContext(self.trace_id, os.urandom(8).hex())

    def to_header(self) -> str:
        """``00-<trace_id>-<span_id>-01`` traceparent wire form."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_header(cls, header: str) -> "TraceContext | None":
        """Parse a traceparent header; ``None`` when malformed."""
        parts = header.strip().split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        try:
            int(parts[1], 16), int(parts[2], 16)
        except ValueError:
            return None
        return cls(parts[1], parts[2])


class SpanEvent(NamedTuple):
    """One completed span: identity, nesting, timing, attributes."""
    seq: int        # creation order, unique per tracer
    parent: int     # seq of the enclosing span, -1 at top level
    depth: int      # nesting depth (0 = top level)
    name: str
    t0_ns: int      # clock() at entry
    dur_ns: int     # clock() delta entry -> exit
    attrs: dict | None


class _NullSpan:
    """Shared no-op span handed out while obs is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kv):
        """No-op."""


_NULL_SPAN = _NullSpan()


class _Span:
    """A live (entered, not yet exited) span; records itself on exit."""

    __slots__ = ("_tracer", "name", "attrs", "seq", "parent", "depth", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict | None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self._tracer
        self.parent = tr._stack[-1] if tr._stack else -1
        self.depth = len(tr._stack)
        self.seq = tr._seq
        tr._seq += 1
        tr._stack.append(self.seq)
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = tr.clock()
        tr._stack.pop()
        tr._record(SpanEvent(self.seq, self.parent, self.depth, self.name,
                             self.t0, t1 - self.t0, self.attrs))
        return False

    def set(self, **kv):
        """Attach/overwrite attributes on the live span (e.g. results known
        only after the spanned work completes)."""
        self.attrs = {**(self.attrs or {}), **kv}


class Tracer:
    """Span recorder around one ring buffer and one nesting stack."""

    def __init__(self, capacity: int = 65536, clock=time.perf_counter_ns):
        self.capacity = int(capacity)
        self.clock = clock
        self._buf: list = [None] * self.capacity
        self._n = 0          # total events ever recorded
        self._seq = 0        # span ids handed out
        self._stack: list[int] = []
        self._hw = 0         # ring-occupancy high-water (never resets)
        self._ctx: TraceContext | None = None

    @property
    def ctx(self) -> "TraceContext | None":
        """The currently bound trace context (``None`` outside ``bind``)."""
        return self._ctx

    @contextmanager
    def bind(self, ctx: "TraceContext | None"):
        """Bind a trace context for the duration of the block: every span
        and instant recorded inside carries a ``trace_id`` attribute.
        Binding ``None`` is a no-op passthrough (callers need not branch)."""
        prev, self._ctx = self._ctx, (ctx if ctx is not None else self._ctx)
        try:
            yield ctx
        finally:
            self._ctx = prev

    def span(self, name: str, **attrs) -> "_Span | _NullSpan":
        """Open a context-managed span (null span while obs is disabled)."""
        if not STATE.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs or None)

    def instant(self, name: str, **attrs):
        """Record a zero-duration event at the current time/nesting (e.g.
        an admission-control shed)."""
        if not STATE.enabled:
            return
        parent = self._stack[-1] if self._stack else -1
        seq, self._seq = self._seq, self._seq + 1
        self._record(SpanEvent(seq, parent, len(self._stack), name,
                               self.clock(), 0, attrs or None))

    def _record(self, ev: SpanEvent):
        ctx = self._ctx
        if ctx is not None and (ev.attrs is None
                                or "trace_id" not in ev.attrs):
            ev = ev._replace(attrs={**(ev.attrs or {}),
                                    "trace_id": ctx.trace_id})
        n = self._n
        if n >= self.capacity:
            _DROPPED_N.inc()
        self._buf[n % self.capacity] = ev
        self._n = n + 1
        if self._hw < self.capacity and n + 1 > self._hw:
            self._hw = n + 1
            _RING_HW_G.set(min(self._hw, self.capacity))

    def events(self) -> list[SpanEvent]:
        """Buffered events in recording (completion) order, oldest first."""
        if self._n <= self.capacity:
            return [e for e in self._buf[:self._n]]
        i = self._n % self.capacity
        return self._buf[i:] + self._buf[:i]

    def dropped(self) -> int:
        """Events overwritten by ring wrap-around since the last clear."""
        return max(0, self._n - self.capacity)

    def clear(self):
        """Drop all buffered events (the nesting stack is left alone so a
        clear inside an open span stays consistent)."""
        self._buf = [None] * self.capacity
        self._n = 0


TRACER = Tracer()


def span(name: str, **attrs):
    """Open a span on the default tracer."""
    return TRACER.span(name, **attrs)


def instant(name: str, **attrs):
    """Record an instant event on the default tracer."""
    TRACER.instant(name, **attrs)


def event_dict(ev: SpanEvent) -> dict:
    """Plain-dict form of one event (the JSONL line payload)."""
    return {"seq": ev.seq, "parent": ev.parent, "depth": ev.depth,
            "name": ev.name, "t0_ns": ev.t0_ns, "dur_ns": ev.dur_ns,
            "attrs": ev.attrs or {}}


class TraceWriter:
    """Incremental JSONL emitter: ``drain()`` appends events recorded since
    the previous drain (by ``seq`` high-water mark) to ``path``, one JSON
    object per line.  Survives ring wrap — wrapped-away events are simply
    gone, never re-written.

    The first line of a fresh file is a ``clock_sync`` header pairing this
    process's wall clock (``time.time_ns``) with its span clock
    (``time.perf_counter_ns``) at the same instant, plus the pid and an
    optional ``proc`` label.  ``repro.obs.merge`` uses the pair to rebase
    every process's monotonic span timestamps onto one shared wall
    timeline, which is what makes cross-process Chrome traces line up.
    """

    def __init__(self, path: str, tracer: Tracer | None = None,
                 proc: str = ""):
        self.path = path
        self.tracer = tracer if tracer is not None else TRACER
        self._f = open(path, "a")
        self._written_seq = -1
        if self._f.tell() == 0:
            self._f.write(json.dumps({
                "clock_sync": {"wall_ns": time.time_ns(),
                               "perf_ns": time.perf_counter_ns()},
                "pid": os.getpid(), "proc": proc}) + "\n")
            self._f.flush()

    def drain(self) -> int:
        """Append all new events; returns how many were written."""
        new = [e for e in self.tracer.events() if e.seq > self._written_seq]
        for ev in new:
            self._f.write(json.dumps(event_dict(ev)) + "\n")
        if new:
            self._f.flush()
            self._written_seq = max(e.seq for e in new)
        return len(new)

    def close(self):
        """Final drain + close the file."""
        self.drain()
        self._f.close()


def chrome_trace(events=None, tracer: Tracer | None = None) -> dict:
    """Chrome ``trace_event``-format dict ("X" complete events, µs units)
    from ``events`` (default: the tracer's buffer).  Span attributes land
    in ``args``; nesting is reconstructed by the viewer from ts/dur on one
    pid/tid, so correctly stacked spans in the source appear stacked in
    ``chrome://tracing``."""
    if events is None:
        events = (tracer if tracer is not None else TRACER).events()
    tev = []
    for ev in sorted(events, key=lambda e: (e.t0_ns, e.seq)):
        tev.append({
            "name": ev.name,
            "ph": "X",
            "ts": ev.t0_ns / 1e3,
            "dur": ev.dur_ns / 1e3,
            "pid": 0,
            "tid": 0,
            "args": {**(ev.attrs or {}), "seq": ev.seq,
                     "parent": ev.parent, "depth": ev.depth},
        })
    return {"traceEvents": tev, "displayTimeUnit": "ms"}


def write_chrome(path: str, events=None, tracer: Tracer | None = None):
    """Write ``chrome_trace`` JSON to ``path``; returns the event count."""
    doc = chrome_trace(events, tracer)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])
