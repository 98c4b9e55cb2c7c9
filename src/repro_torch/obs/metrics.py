"""Process-wide metrics registry: named counters, gauges, histograms.

Zero-dependency (stdlib only) and deliberately tiny: a **family** is a
named metric with a declared label schema; a family with no labels acts as
its own single child (``counter("x").inc()`` just works), a labeled family
hands out children via ``labels(**kv)``.  Families are **get-or-create**
(two modules asking for ``truss_wal_fsync_total`` share one object), so
instrumented modules can create their metric objects at import time and
``Registry.reset()`` zeroes values *in place* without invalidating anyone's
reference.

Recording is gated on ``repro.obs.state.STATE.enabled`` — a disabled
registry costs one attribute read per call site (see ``repro.obs.disabled``
and ``benchmarks/obs_overhead.py`` for the measured cost when enabled).

Thread-safety: family creation is locked; recording is a bare int/float
add, which is atomic enough under the GIL for the single-writer +
scrape-thread pattern the serving stack uses (the exposition server reads
``snapshot()`` from its own thread).

``snapshot()`` returns plain dicts (no live objects) keyed by family name;
``repro.obs.expo`` renders the same structure as Prometheus text and
parses it back for round-trip tests.
"""
from __future__ import annotations

import bisect
import threading

from .state import STATE

# Latency histograms: 100us .. 2.5s, roughly log-spaced (seconds).
DEFAULT_LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                           0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
# Size histograms: record counts per flush/batch.
DEFAULT_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                        256.0, 512.0, 1024.0, 4096.0)


class Counter:
    """Monotonically increasing value (events since process start)."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1):
        """Add ``n`` (>= 0) to the counter; no-op while obs is disabled."""
        if STATE.enabled:
            self.value += n

    def _reset(self):
        self.value = 0

    def _snap(self):
        return self.value


class Gauge:
    """Point-in-time value (queue depth, lag, committed generation)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v: int | float):
        """Overwrite the gauge; no-op while obs is disabled."""
        if STATE.enabled:
            self.value = v

    def inc(self, n: int | float = 1):
        """Adjust the gauge by ``n`` (may be negative)."""
        if STATE.enabled:
            self.value += n

    def _reset(self):
        self.value = 0

    def _snap(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts plus sum/count.

    ``bounds`` are upper bucket edges (ascending); one extra overflow
    bucket catches everything past the last edge (``+Inf`` in exposition).
    """

    kind = "histogram"
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds=DEFAULT_LATENCY_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bucket bounds must be ascending")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        """Record one observation; no-op while obs is disabled."""
        if not STATE.enabled:
            return
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def _reset(self):
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def _snap(self):
        return {"buckets": list(self.counts), "bounds": list(self.bounds),
                "sum": self.sum, "count": self.count}


class Family:
    """A named metric family: label schema + one child per label-value set.

    A family declared with no labels delegates ``inc``/``set``/``observe``
    to its single implicit child, so the common unlabeled case reads like a
    bare metric object.
    """

    def __init__(self, name: str, kind_cls, help: str = "",
                 labelnames: tuple = (), **kw):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kind_cls = kind_cls
        self._kw = kw
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            self._children[()] = kind_cls(**kw)

    @property
    def kind(self) -> str:
        """'counter' | 'gauge' | 'histogram'."""
        return self._kind_cls.kind

    def labels(self, **kv):
        """The child metric for one label-value assignment (get-or-create).
        Values are stringified; every declared label must be provided."""
        if set(kv) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(kv)} != declared "
                             f"{sorted(self.labelnames)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._children.setdefault(key, self._kind_cls(**self._kw))
        return child

    def children(self) -> dict[tuple, object]:
        """Live children keyed by label-value tuple (declared-name order)."""
        return dict(self._children)

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled "
                             f"{self.labelnames} — use .labels(...)")
        return self._children[()]

    # unlabeled-family conveniences ------------------------------------------
    def inc(self, n: int | float = 1):
        """Counter/gauge convenience on an unlabeled family."""
        self._only().inc(n)

    def set(self, v: int | float):
        """Gauge convenience on an unlabeled family."""
        self._only().set(v)

    def observe(self, v: float):
        """Histogram convenience on an unlabeled family."""
        self._only().observe(v)

    @property
    def value(self):
        """Current scalar of an unlabeled counter/gauge."""
        return self._only().value


class Registry:
    """Get-or-create home for metric families; snapshot/reset the lot."""

    def __init__(self):
        self._families: dict[str, Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name, kind_cls, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind_cls, help=help,
                             labelnames=labelnames, **kw)
                self._families[name] = fam
                return fam
        if fam._kind_cls is not kind_cls:
            raise ValueError(f"{name} already registered as {fam.kind}")
        if fam.labelnames != tuple(labelnames):
            raise ValueError(f"{name} already registered with labels "
                             f"{fam.labelnames}")
        return fam

    def counter(self, name: str, help: str = "", labels: tuple = ()) -> Family:
        """Get-or-create a counter family."""
        return self._get_or_create(name, Counter, help, labels)

    def gauge(self, name: str, help: str = "", labels: tuple = ()) -> Family:
        """Get-or-create a gauge family."""
        return self._get_or_create(name, Gauge, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets=DEFAULT_LATENCY_BUCKETS) -> Family:
        """Get-or-create a histogram family with fixed ``buckets`` edges."""
        return self._get_or_create(name, Histogram, help, labels,
                                   bounds=buckets)

    def families(self) -> dict[str, Family]:
        """Live families by name (insertion-ordered)."""
        with self._lock:
            return dict(self._families)

    def value(self, name: str, default=0):
        """Sum of a counter/gauge family's children (``default`` when the
        family does not exist yet) — the convenience benchmarks use to diff
        totals across a run without touching family internals."""
        fam = self._families.get(name)
        if fam is None:
            return default
        return sum(c.value for c in fam._children.values())

    def snapshot(self) -> dict:
        """Plain-data view of every family: ``{name: {type, help,
        labelnames, values: {label-tuple: scalar | histogram-dict}}}``."""
        out = {}
        for name, fam in self.families().items():
            out[name] = {
                "type": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "values": {key: child._snap()
                           for key, child in fam.children().items()},
            }
        return out

    def reset(self):
        """Zero every child's value **in place** — module-level references
        to families/children stay valid (used by tests and the overhead
        benchmark to diff runs)."""
        for fam in self.families().values():
            for child in fam.children().values():
                child._reset()


REGISTRY = Registry()


def counter(name: str, help: str = "", labels: tuple = ()) -> Family:
    """Get-or-create a counter on the default registry."""
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: tuple = ()) -> Family:
    """Get-or-create a gauge on the default registry."""
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: tuple = (),
              buckets=DEFAULT_LATENCY_BUCKETS) -> Family:
    """Get-or-create a histogram on the default registry."""
    return REGISTRY.histogram(name, help, labels, buckets=buckets)
