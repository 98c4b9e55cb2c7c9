"""Retry and circuit-breaker primitives for the serving stack.

``RetryPolicy`` implements capped *decorrelated-jitter* backoff (each
pause is drawn uniformly from ``[base, 3 * previous]`` and clipped to a
cap) with two hard bounds — a maximum attempt count and a wall-clock
deadline — so no caller can spin forever against a dead disk or an
overloaded primary.  The jitter source is a seeded PRNG and the sleep and
clock functions are injectable, which makes every retry sequence
deterministic and instantly testable.

``CircuitBreaker`` is the classic closed → open → half-open machine the
service uses for graceful degradation: consecutive failures trip it open
(writes shed, committed reads keep serving), a cooldown later it admits a
single half-open trial, and the trial's outcome either closes it again or
re-opens it for another cooldown.
"""
from __future__ import annotations

import random
import time

from ..obs import metrics as obs_metrics

_RETRY_N = obs_metrics.counter(
    "truss_retries_total", "backoff retries taken, by caller scope",
    labels=("scope",))

#: breaker states (also the ``truss_breaker_state`` gauge encoding).
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class RetryExhausted(Exception):
    """Raised by ``RetryPolicy.call`` when every attempt failed.

    ``__cause__`` carries the last underlying exception.
    """


class RetryPolicy:
    """Capped decorrelated-jitter backoff with attempt and deadline bounds.

    Deterministic under a fixed ``seed``; ``sleep``/``clock`` are
    injectable so tests (and the chaos harness) run it at virtual time.
    ``scope`` labels the ``truss_retries_total`` counter.
    """

    def __init__(self, max_attempts: int = 5, base_ms: float = 1.0,
                 cap_ms: float = 100.0, deadline_s: float | None = None,
                 seed: int = 0, sleep=time.sleep, clock=time.monotonic,
                 scope: str = "default"):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_ms) / 1e3
        self.cap_s = float(cap_ms) / 1e3
        self.deadline_s = deadline_s
        self.scope = scope
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock

    def next_delay(self, prev_s: float | None) -> float:
        """One decorrelated-jitter pause: ``min(cap, U(base, 3*prev))``."""
        prev = self.base_s if prev_s is None else prev_s
        return min(self.cap_s,
                   self._rng.uniform(self.base_s, max(self.base_s, 3 * prev)))

    def attempts(self):
        """Yield attempt indices ``0..max_attempts-1``, sleeping the jittered
        backoff between them.  The caller ``break``s (or returns) on
        success; exhausting the generator means every attempt was used.
        The deadline bounds *total* elapsed time: no pause is taken that
        would start an attempt past it."""
        start = self._clock()
        prev: float | None = None
        for attempt in range(self.max_attempts):
            yield attempt
            if attempt == self.max_attempts - 1:
                return
            delay = self.next_delay(prev)
            prev = delay
            if (self.deadline_s is not None
                    and self._clock() - start + delay > self.deadline_s):
                return
            _RETRY_N.labels(scope=self.scope).inc()
            self._sleep(delay)

    def call(self, fn, *, retry_on=(OSError,)):
        """Run ``fn()`` under the policy; re-raise as ``RetryExhausted``
        (with the last error as ``__cause__``) when every attempt fails."""
        last: BaseException | None = None
        for _ in self.attempts():
            try:
                return fn()
            except retry_on as exc:  # noqa: PERF203 — the loop IS the policy
                last = exc
        raise RetryExhausted(
            f"{self.scope}: all {self.max_attempts} attempts failed") from last


class CircuitBreaker:
    """Closed/open/half-open breaker with an injectable clock.

    * **closed** — everything flows; ``failure_threshold`` *consecutive*
      failures trip it open.
    * **open** — ``allow()`` returns False until ``cooldown_s`` elapses,
      then transitions to half-open and admits the caller.
    * **half-open** — a trial is in progress: ``allow()`` keeps returning
      True (the trial operation may probe several times) until the caller
      reports the outcome; success closes, failure re-opens.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 0.05,
                 clock=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.trips = 0  # lifetime count of closed/half-open -> open

    @property
    def state(self) -> str:
        """Current state name (``closed`` / ``half_open`` / ``open``)."""
        return self._state

    @property
    def state_code(self) -> int:
        """Gauge encoding of the state (0 closed, 1 half-open, 2 open)."""
        return STATE_CODES[self._state]

    @property
    def failures(self) -> int:
        """Length of the current consecutive-failure run."""
        return self._failures

    def allow(self) -> bool:
        """Whether the protected operation may run right now (open state
        flips to half-open once the cooldown has elapsed)."""
        if self._state == OPEN:
            if self._clock() - self._opened_at >= self.cooldown_s:
                self._state = HALF_OPEN
                return True
            return False
        return True

    def trip(self):
        """Force the breaker open immediately (poisoned generation, retry
        exhaustion): no need to accumulate threshold failures when the
        failure is already known to be persistent."""
        self._state = OPEN
        self._opened_at = self._clock()
        self._failures = 0
        self.trips += 1

    def record_failure(self):
        """Count one failure; trips open at the threshold, and instantly
        from half-open (the trial failed)."""
        self._failures += 1
        if self._state == HALF_OPEN or self._failures >= self.failure_threshold:
            self.trip()

    def record_success(self):
        """Report success: closes the breaker and clears the failure run."""
        self._state = CLOSED
        self._failures = 0
