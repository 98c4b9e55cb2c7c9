"""SLO engine: declarative objectives, multi-window burn-rate evaluation.

An :class:`Objective` declares a target ("99% of queries under 50 ms over
the serving window") against an existing metric family — no new
instrumentation at the call sites.  :class:`SLOEngine` periodically
snapshots the registry, converts each objective's family into a cumulative
``(errors, total)`` pair, and evaluates the classic SRE **multi-window
burn rate**: the error-budget consumption speed over a *fast* window (is
the problem happening right now?) and a *slow* window (is it sustained,
not a blip?).  An objective is

* ``ok``        — at least one window is under its burn threshold;
* ``burning``   — both windows exceed the threshold;
* ``violated``  — it has been burning for ``violate_after_s`` seconds.

Recovery is **hysteretic**: a burning/violated objective returns to ``ok``
only after both windows have stayed below the threshold for ``clear_s``
continuous seconds, so a flapping latency tail cannot flap the health
endpoint.  The clock is injectable, so tests drive windows deterministically.

State is surfaced three ways: ``truss_slo_*`` metrics (burn-rate gauge,
state gauge, transition counter), ``SLOEngine.state_dict()`` (wired into
``TrussService.stats()["slo"]``), and ``SLOEngine.health()`` (the
``/healthz`` payload of ``repro_torch.obs.expo.MetricsServer``).  A transition
into ``violated`` trips the flight recorder
(``repro_torch.obs.flightrec.FLIGHT``) so the evidence is on disk before anyone
asks.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from . import flightrec as _flightrec
from . import metrics as _metrics

OK, BURNING, VIOLATED = "ok", "burning", "violated"
_STATE_CODE = {OK: 0, BURNING: 1, VIOLATED: 2}

_BURN_G = _metrics.gauge(
    "truss_slo_burn_rate",
    "fast-window error-budget burn rate per objective", labels=("slo",))
_STATE_G = _metrics.gauge(
    "truss_slo_state",
    "objective state (0 ok, 1 burning, 2 violated)", labels=("slo",))
_TRANS_N = _metrics.counter(
    "truss_slo_transitions_total",
    "objective state transitions, by objective and new state",
    labels=("slo", "to"))
_EVAL_N = _metrics.counter(
    "truss_slo_evaluations_total", "SLO evaluation passes run")


@dataclass(frozen=True)
class Objective:
    """One declarative service-level objective over a metric family.

    ``kind`` selects how ``family`` becomes a cumulative (errors, total)
    stream:

    * ``latency`` — ``family`` is a histogram; an observation is an error
      when it lands above ``threshold`` seconds (bucket-boundary
      resolution).  The target is the good fraction (p-quantile bound).
    * ``availability`` — ``family`` is the good-event counter (a histogram
      counts via its ``count``); ``bad_family`` is the failed/shed-event
      counter.  Errors are bad events.
    * ``gauge`` — ``family`` is sampled at each evaluation; a sample whose
      maximum child value exceeds ``threshold`` is one error out of one
      total (lag-style objectives).

    ``fast_s``/``slow_s`` are the two burn windows, ``burn_threshold`` the
    budget-consumption multiple both must exceed to count as burning,
    ``violate_after_s`` the sustained-burn horizon before ``violated``,
    and ``clear_s`` the hysteresis hold before recovery.
    """

    name: str
    kind: str
    family: str
    target: float = 0.99
    threshold: float = 0.05
    bad_family: str | None = None
    fast_s: float = 30.0
    slow_s: float = 300.0
    burn_threshold: float = 2.0
    violate_after_s: float = 60.0
    clear_s: float = 60.0


def default_objectives() -> tuple:
    """The serving stack's stock SLO catalog (docs/OBSERVABILITY.md)."""
    return (
        Objective("query-p99", "latency", "truss_query_seconds",
                  target=0.99, threshold=0.05),
        Objective("write-ack-p99", "latency", "truss_write_ack_seconds",
                  target=0.99, threshold=0.1),
        Objective("replica-lag", "gauge", "truss_replica_lag_gens",
                  target=0.99, threshold=8.0),
        Objective("committed-read-availability", "availability",
                  "truss_query_seconds", target=0.999,
                  bad_family="truss_degraded_shed_total"),
    )


def _family_count(snap: dict, name: str) -> float:
    """Total event count of a family: histogram ``count`` summed across
    children, else the counter/gauge child values summed."""
    fam = snap.get(name)
    if fam is None:
        return 0.0
    total = 0.0
    for val in fam["values"].values():
        total += val["count"] if isinstance(val, dict) else val
    return total


def _latency_cumulative(snap: dict, family: str, threshold: float):
    """(errors, total) from a histogram family: errors are observations in
    buckets whose upper edge exceeds ``threshold``."""
    fam = snap.get(family)
    if fam is None:
        return 0.0, 0.0
    errors = total = 0.0
    for val in fam["values"].values():
        if not isinstance(val, dict):
            continue
        total += val["count"]
        good = sum(cnt for bound, cnt in zip(val["bounds"], val["buckets"])
                   if bound <= threshold)
        errors += val["count"] - good
    return errors, total


def _gauge_max(snap: dict, family: str) -> float:
    fam = snap.get(family)
    if fam is None or not fam["values"]:
        return 0.0
    return max(fam["values"].values())


class SLOEngine:
    """Evaluates a set of objectives over the live metrics registry."""

    def __init__(self, objectives=None, registry=None, clock=time.monotonic,
                 min_interval_s: float = 1.0):
        self.objectives = tuple(objectives if objectives is not None
                                else default_objectives())
        self.registry = registry if registry is not None else _metrics.REGISTRY
        self.clock = clock
        self.min_interval_s = float(min_interval_s)
        self._samples: deque = deque()  # (t, {name: (errors, total)})
        self._state = {o.name: OK for o in self.objectives}
        self._burn = {o.name: (0.0, 0.0) for o in self.objectives}
        self._burn_since: dict = {o.name: None for o in self.objectives}
        self._clear_since: dict = {o.name: None for o in self.objectives}
        self._gauge_cum = {o.name: [0.0, 0.0] for o in self.objectives
                           if o.kind == "gauge"}
        self._last_eval = None
        self._max_window = max((max(o.fast_s, o.slow_s)
                                for o in self.objectives), default=300.0)

    # -- sampling -------------------------------------------------------------

    def _cumulative(self, snap: dict, o: Objective):
        if o.kind == "latency":
            return _latency_cumulative(snap, o.family, o.threshold)
        if o.kind == "availability":
            bad = _family_count(snap, o.bad_family) if o.bad_family else 0.0
            good = _family_count(snap, o.family)
            return bad, good + bad
        if o.kind == "gauge":
            cum = self._gauge_cum[o.name]
            cum[0] += 1.0 if _gauge_max(snap, o.family) > o.threshold else 0.0
            cum[1] += 1.0
            return cum[0], cum[1]
        raise ValueError(f"unknown objective kind {o.kind!r}")

    def _window_burn(self, name: str, target: float, now: float,
                     window: float, cum_now) -> float:
        """Burn rate over ``[now - window, now]``: the error rate in the
        window divided by the error budget (1 - target)."""
        base = None
        for t, cum in self._samples:  # oldest first; last sample <= start
            if t <= now - window:
                base = cum.get(name, (0.0, 0.0))
            else:
                break
        if base is None:  # window predates history: burn from the origin
            base = (0.0, 0.0)
        d_err = cum_now[0] - base[0]
        d_tot = cum_now[1] - base[1]
        if d_tot <= 0:
            return 0.0
        return (d_err / d_tot) / max(1.0 - target, 1e-9)

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, force: bool = False) -> dict:
        """Run one evaluation pass (rate-limited to ``min_interval_s``
        unless ``force``); returns ``state_dict()``."""
        now = self.clock()
        if (not force and self._last_eval is not None
                and now - self._last_eval < self.min_interval_s):
            return self.state_dict()
        self._last_eval = now
        _EVAL_N.inc()
        snap = self.registry.snapshot()
        cum = {o.name: self._cumulative(snap, o) for o in self.objectives}
        self._samples.append((now, cum))
        # keep exactly one sample at/behind the slowest window start
        horizon = now - self._max_window
        while len(self._samples) >= 2 and self._samples[1][0] <= horizon:
            self._samples.popleft()
        for o in self.objectives:
            fast = self._window_burn(o.name, o.target, now, o.fast_s,
                                     cum[o.name])
            slow = self._window_burn(o.name, o.target, now, o.slow_s,
                                     cum[o.name])
            self._burn[o.name] = (fast, slow)
            self._step(o, now, fast, slow)
            _BURN_G.labels(slo=o.name).set(fast)
            _STATE_G.labels(slo=o.name).set(_STATE_CODE[self._state[o.name]])
        return self.state_dict()

    def _step(self, o: Objective, now: float, fast: float, slow: float):
        """One objective's state-machine step with hysteretic recovery."""
        name, state = o.name, self._state[o.name]
        burning_now = fast >= o.burn_threshold and slow >= o.burn_threshold
        if burning_now:
            self._clear_since[name] = None
            if self._burn_since[name] is None:
                self._burn_since[name] = now
            if state == OK:
                self._transition(o, BURNING)
            elif (state == BURNING
                  and now - self._burn_since[name] >= o.violate_after_s):
                self._transition(o, VIOLATED)
            return
        self._burn_since[name] = None
        if state == OK:
            return
        if self._clear_since[name] is None:
            self._clear_since[name] = now
        elif now - self._clear_since[name] >= o.clear_s:
            self._clear_since[name] = None
            self._transition(o, OK)

    def _transition(self, o: Objective, to: str):
        self._state[o.name] = to
        _TRANS_N.labels(slo=o.name, to=to).inc()
        if to == VIOLATED:
            fast, slow = self._burn[o.name]
            _flightrec.FLIGHT.trip(
                "slo_violation", slo=o.name, burn_fast=round(fast, 3),
                burn_slow=round(slow, 3), target=o.target)

    # -- surfacing ------------------------------------------------------------

    def overall(self) -> str:
        """Worst objective state: ok < burning < violated."""
        return max(self._state.values(), key=_STATE_CODE.__getitem__,
                   default=OK) if self._state else OK

    def state_dict(self) -> dict:
        """Plain-data view for ``stats()["slo"]`` and postmortem bundles."""
        return {
            "overall": self.overall(),
            "objectives": {
                o.name: {"state": self._state[o.name],
                         "burn_fast": round(self._burn[o.name][0], 4),
                         "burn_slow": round(self._burn[o.name][1], 4),
                         "target": o.target, "kind": o.kind,
                         "family": o.family}
                for o in self.objectives},
        }

    def health(self) -> dict:
        """``/healthz`` payload: overall status + per-objective states."""
        return {"status": self.overall(),
                "objectives": {o.name: self._state[o.name]
                               for o in self.objectives}}
