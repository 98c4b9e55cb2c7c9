"""TrussService — the online truss query engine (PyTorch port of
``repro.service.engine``).

One long-lived object multiplexes a write stream and a query API over a
single maintained truss oracle:

* **Writes** are acknowledged immediately: validated against the logical
  edge set (present edges + pending effects), WAL-appended with the
  generation they will commit in, and queued.  An admission policy flushes
  the queue as **one fused batch** (``DynamicGraph.apply_batch``, netted)
  every ``flush_every`` writes — the paper's batch-amortized streaming
  ingestion (Jakkula & Karypis framing).  The flush runs the delta-peel
  engine (``core/peel.py``) with donated GraphState buffers, so a
  generation commit re-peels only the affected set's triangles and reuses
  the previous generation's arrays instead of copying them; ``stats()``
  surfaces the last flush's ``PeelStats``.
* **Reads** happen only at generation boundaries: every query first flushes
  pending writes, so a client always reads its own writes and never observes
  a half-applied batch (same discipline as the slot-admission fix in
  ``serving.engine.DecodeEngine._fill_slots`` — no request joins
  mid-generation).
* **Durability** is delegated to ``TrussStore``: crash at any point, then
  ``TrussService.restore(store)`` = last snapshot + WAL-tail replay, which
  reconstructs phi and component labels exactly (tested against the
  pure-Python oracle at randomized kill points).

``indexed=False`` turns the service into the recompute-per-query baseline
(progressiveUpdate's query path) — the reference's
``benchmarks/service_throughput`` measures what the index buys with it.

**Pipelined ingest** (``pipeline=True``) double-buffers generations: the
fused re-peel of generation g is *dispatched* (``apply_batch(...,
defer_sync=True)``), a CUDA event is recorded behind it, and generation g
lands when the event has completed; meanwhile the host keeps admitting,
WAL-appending and netting generation g+1.  On the card this buys no
overlap yet: the peel loop reads its frontier on the host every wave, so
the dispatch returns only once the re-peel has (almost) run.  On the CPU
the result is ready when ``apply_batch`` returns.  Three invariants are
preserved exactly:

* **acked-before-applied** — every record is WAL-appended (and fsynced at
  its generation's dispatch) before the batch that applies it runs;
* **commit-after-land** — ``commit.json`` advances only when g's device
  result has landed, so replicas and crash recovery still see a frontier
  below which the log holds only fully-applied generation groups (the WAL
  tail may run *ahead* of the frontier by the in-flight + queued
  generations — tailers must simply not read past it, which they never
  did);
* **reads-at-boundaries** — a query drains the pipeline first, so
  read-your-writes semantics are unchanged (``handle_committed`` only
  waits for the in-flight generation to land, never dispatches).

The generation boundary itself adapts (``target_p99_ms``): instead of the
fixed ``flush_every`` constant, the dispatch threshold tracks the measured
balance point — the EWMA of per-generation commit latency times the EWMA
host arrival rate, i.e. the records that arrive while one peel runs — and
doubles when the latency EWMA breaches the p99 target (amortization is all
that helps once a single peel blows the budget).  Admission control bounds
the pending queue (``max_pending``): when it is full and the device is
still busy, ``submit`` sheds load with an explicit ``Overloaded`` ack
(nothing hits the WAL) instead of stalling the whole ingest path.

**Graceful degradation** (``repro_torch.faults``): every apply runs a
delta->recompute fallback ladder; a generation that fails both engines is
*quarantined* — its records are durable in the WAL and stay queued — and
the circuit breaker trips the service into degraded mode, where committed
reads keep serving and writes shed with ``Overloaded(reason=...)``.  A
half-open probe retries the quarantined group; failures that invalidate
the in-memory oracle (a lost in-flight landing, an invariant violation at
a commit boundary) instead *self-heal*: reload the snapshot and replay the
full acked WAL tail, preserving the log's generation tags so replicas stay
bitwise-equal.  fsyncs run under a capped-jitter ``RetryPolicy``;
exhaustion degrades the same way.  ``scrub()`` audits the whole plane.

The same machinery feeds the replicated serving tier (the reference's
``repro.cluster``, ported as ``repro_torch.cluster``):
every flush publishes the committed frontier to the store (``commit.json``)
so read replicas can tail complete generation groups, every ``WriteAck``
doubles as a read-your-writes generation token, and ``stats()`` reports
per-replica lag from the lease files tailers publish.

``device`` (default ``"cuda"``) is where the graph state and every peel
live; ``restore`` and the self-heal rebuild on it too.  ``mesh`` (a
``ShardMesh``) runs every flush's re-peel over its shards, the state on
its first shard's device; ``partition="nodes"`` splits the adjacency
bitmap into one word slab per shard.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import DynamicGraph, component_labels
from ..core import representatives as core_representatives
from ..core.graph import GraphSpec, GraphState, lookup_edge
from ..core.maintenance import OP_INSERT
from ..core.peel import stats_dict as peel_stats_dict
from ..faults.retry import (CLOSED, CircuitBreaker, RetryExhausted,
                            RetryPolicy)
from ..obs import flightrec as obs_flightrec
from ..obs import metrics as obs_metrics, profiling as obs_profiling
from ..obs import trace as obs_trace
from .api import (COMMUNITY, MAX_K, MEMBERS, REPRESENTATIVES, Overloaded,
                  QueryRequest, QueryResponse, Unavailable, WriteAck,
                  WriteRequest)
from ..core import index as truss_index
from .store import TrussStore

_INF = int(truss_index._INF)  # non-member label sentinel (host-side int)

_EWMA_ALPHA = 0.3  # smoothing for the adaptive-flush latency/rate estimates

# registry families (get-or-create: shared with any other service in the
# process; see docs/OBSERVABILITY.md for the catalog)
_FLUSH_N = obs_metrics.counter(
    "truss_flush_total", "committed generations (fused or progressive)")
_FLUSH_SIZE = obs_metrics.histogram(
    "truss_flush_size_records", "WAL records per committed generation",
    buckets=obs_metrics.DEFAULT_SIZE_BUCKETS)
_PEEL_S = obs_metrics.histogram(
    "truss_peel_seconds",
    "dispatch-to-land wall time of one generation's maintenance")
_PEEL_WAVES = obs_metrics.counter(
    "truss_peel_waves_total", "peel-engine while-loop waves")
_PEEL_KILLS = obs_metrics.counter(
    "truss_peel_kills_total", "edges assigned a phi by the peel engine")
_PEEL_DELTAS = obs_metrics.counter(
    "truss_peel_deltas_total", "scatter-subtracted support updates")
_Q_DEPTH = obs_metrics.gauge(
    "truss_pipeline_queue_depth",
    "acked-but-unapplied records queued (pipeline mode)")
_FLUSH_TARGET_G = obs_metrics.gauge(
    "truss_pipeline_flush_target", "adaptive generation-size target")
_SHED_N = obs_metrics.counter(
    "truss_pipeline_shed_total",
    "writes shed by admission control (Overloaded)")
_GEN_G = obs_metrics.gauge("truss_committed_gen", "committed generation")
_EDGES_G = obs_metrics.gauge(
    "truss_edges", "active edges at the committed generation")
_QUERY_S = obs_metrics.histogram(
    "truss_query_seconds", "query latency by kind (flush-inclusive)",
    labels=("kind",))
_WRITE_ACK_S = obs_metrics.histogram(
    "truss_write_ack_seconds",
    "write admission-to-ack latency (WAL append inclusive; batch submits "
    "observe one sample for the whole batch)")
_BREAKER_G = obs_metrics.gauge(
    "truss_breaker_state",
    "circuit-breaker state (0 closed, 1 half-open, 2 open)")
_DEGRADED_N = obs_metrics.counter(
    "truss_degraded_total", "entries into degraded mode, by reason",
    labels=("reason",))
_DEGRADED_SHED_N = obs_metrics.counter(
    "truss_degraded_shed_total",
    "writes shed while the circuit breaker was open")
_PEEL_FAULT_N = obs_metrics.counter(
    "truss_peel_fault_total",
    "generation apply failures (before any engine fallback)")
_FALLBACK_N = obs_metrics.counter(
    "truss_engine_fallback_total",
    "generations recovered by the delta->recompute engine fallback")
_HEAL_N = obs_metrics.counter(
    "truss_self_heal_total",
    "in-place rebuilds from the durable store (snapshot + full WAL replay)")


def _host(x: torch.Tensor) -> np.ndarray:
    """A host (numpy) copy of a tensor on any device."""
    return x.detach().cpu().numpy()


class InvariantViolation(RuntimeError):
    """A committed-state invariant failed its boundary check (phi below 2
    on an active edge, or the device active count diverging from the host
    present-set mirror) — the in-memory oracle can no longer be trusted and
    must be rebuilt from the durable store."""


class GenerationPoisoned(RuntimeError):
    """One generation's apply failed on the primary engine *and* on the
    recompute fallback.  The records are durable in the WAL (acked before
    applied), so the generation is quarantined — kept queued for a
    half-open retry or a self-heal replay — rather than dropped."""

    def __init__(self, gen: int, n: int, cause: BaseException):
        super().__init__(f"generation {gen} poisoned ({n} records): {cause!r}")
        self.gen = gen
        self.n = n


class _Inflight(NamedTuple):
    """One dispatched-but-unlanded generation (pipeline mode).

    ``hi`` is the device-side index-invalidation bound returned by the
    deferred ``apply_batch`` — reading it (``int(hi)``) blocks until the
    whole fused re-peel has landed, which is exactly the completion wait.
    ``event`` is a CUDA event recorded behind the dispatch (``None`` on the
    CPU, where the result is ready once ``apply_batch`` returns).
    """
    gen: int     # generation tag this batch commits as
    n: int       # WAL records it covers
    hi: object   # 0-d int32 tensor on the graph's device
    t0: float    # perf_counter at dispatch
    event: object = None  # torch.cuda.Event, or None off the card


class TrussService:
    """The online truss engine: write admission, batched flush, queries,
    durability.  See the module docstring for the consistency model and
    the pipelined-ingest design."""

    def __init__(self, n_nodes: int, edges=(), *, tracked_ks=(),
                 flush_every: int = 16, strategy: str = "auto",
                 store: TrussStore | None = None, indexed: bool = True,
                 d_max: int | None = None, e_cap: int | None = None,
                 support_method: str = "sorted", mesh=None,
                 partition: str = "replicated",
                 pipeline: bool = False, target_p99_ms: float | None = None,
                 max_pending: int | None = None, chaos=None,
                 breaker: CircuitBreaker | None = None,
                 retry: RetryPolicy | None = None, device="cuda"):
        if store is not None and (store.wal_len
                                  or os.path.exists(store.snap_path)):
            raise ValueError(
                "store already holds state — use TrussService.restore(store)")
        # mesh: every flush's fused re-peel shards over the mesh; snapshots
        # record the (mesh-padded) capacities only, so replicas and
        # restores on any shard count stay bitwise equal to this primary.
        # partition: "nodes" splits the adjacency bitmap's word axis over
        # the mesh (O(N·W/S) a device; a wave sums the shards' partial
        # supports)
        self.graph = DynamicGraph(n_nodes, edges, d_max=d_max, e_cap=e_cap,
                                  support_method=support_method,
                                  tracked_ks=tuple(tracked_ks), mesh=mesh,
                                  partition=partition, device=device)
        self.store = store
        self.flush_every = int(flush_every)
        self.strategy = strategy
        self.indexed = indexed
        self.support_method = support_method  # self-heal rebuilds need it
        self.partition = partition            # ditto
        self.gen = 0                 # committed generation
        self._pending: list = []     # acked, not yet applied
        self._applied_wal = 0        # global WAL index of the committed frontier
        self._view = set(self.graph._present)  # present + pending effects
        self.stream_state = None     # input-stream state from a snapshot
        self.replayed_records = 0    # WAL records restore replayed past the snapshot
        self._init_faults(chaos, breaker, retry)
        self._init_pipeline(pipeline, target_p99_ms, max_pending)
        if store is not None:
            self.snapshot()          # baseline: restore never needs gen 0 WAL

    def _init_faults(self, chaos, breaker, retry):
        """Degradation-plane state shared by both constructors: the (test-
        injectable) peel-chaos hook, the circuit breaker gating writes, and
        the fsync retry policy.  Every service gets a breaker and a retry
        policy even when no chaos is configured — real disks fail too."""
        self.chaos = chaos
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_ms=0.5, cap_ms=20.0, scope="fsync")
        self._degraded_reason: str | None = None
        self._needs_heal = False
        self.slo = None              # attach_slo wires the burn-rate engine
        self._annotated_gen: int | None = None  # last WAL-annotated gen
        # gen -> {"n", "records", "reason", "status"}; status flips to
        # "recovered" once the generation commits after all
        self._quarantined: dict[int, dict] = {}
        _BREAKER_G.set(self.breaker.state_code)

    def _init_pipeline(self, pipeline: bool, target_p99_ms, max_pending):
        """Pipeline-mode state (no-ops when ``pipeline=False``).  In
        pipeline mode ``_pending`` holds ``(gen, op, a, b)`` records — the
        tag is assigned at admission, exactly as it hits the WAL, so the
        dispatched batches reproduce the WAL's generation groups."""
        self.pipeline = bool(pipeline)
        self.target_p99_ms = target_p99_ms
        self.max_pending = (int(max_pending) if max_pending is not None
                            else 8 * self.flush_every)
        # adaptive dispatch threshold; clamped so the open generation can
        # never grow past the admission bound before it seals
        self._flush_target = min(self.flush_every, self.max_pending)
        self._open_gen = self.gen + 1  # tag for the next admitted record
        self._open_count = 0           # records so far in the open generation
        self._inflight: _Inflight | None = None
        self._ewma_gen_s: float | None = None   # per-generation commit latency
        self._ewma_rate: float | None = None    # host arrival rate, records/s
        self._last_seal_t: float | None = None
        self.overloaded = 0            # writes shed by admission control
        self._last_shed_gen: int | None = None  # committed gen at last shed
        self._stats_seen = None  # identity of the last counted PeelStats
        if self.pipeline:
            _FLUSH_TARGET_G.set(self._flush_target)
        # both constructors funnel through here with the graph built and
        # ``gen`` set, so this is where the committed snapshot is seeded
        self._capture_committed()

    def _capture_committed(self, peel: dict | None = None):
        """Refresh the atomic committed-state snapshot ``stats()`` serves
        from.  Called only at generation boundaries (constructor, commit,
        replay), where ``self.graph.state`` arrays are landed — reading
        edge counts / max phi here can never block on an in-flight
        dispatch the way reading them inside ``stats()`` could.

        This boundary is also where the cheap state invariants are
        enforced (the arrays are already being pulled for ``max_truss``,
        so the checks are free): every active edge carries phi >= 2, and
        the device active count matches the host present-set mirror.  A
        violation means the in-memory oracle diverged from the log and
        raises ``InvariantViolation`` — commit paths catch it, degrade,
        and rebuild from the store."""
        if peel is None:
            peel = peel_stats_dict(self.graph.last_peel_stats)
        act = _host(self.graph.state.active)
        phi = _host(self.graph.state.phi)
        n_active = int(act.sum())
        if n_active != len(self.graph._present):
            raise InvariantViolation(
                f"active count {n_active} != present-set size "
                f"{len(self.graph._present)} at gen {self.gen}")
        phis = phi[act]
        if n_active and int(phis.min()) < 2:
            raise InvariantViolation(
                f"phi < 2 on an active edge at gen {self.gen}")
        self._committed = {
            "gen": self.gen,
            "wal_applied": self._applied_wal,
            "n_edges": n_active,
            "max_truss": int(phis.max(initial=0)),
            "peel": peel,
        }
        _GEN_G.set(self.gen)
        _EDGES_G.set(self._committed["n_edges"])

    def _record_commit_metrics(self, n: int, dur_s: float | None) -> dict:
        """Registry side of one committed generation; returns the peel
        stats dict for the committed snapshot.  Peel counters advance only
        when ``last_peel_stats`` is a *new* object — a netted no-op commit
        leaves the previous generation's stats in place and must not
        double-count them."""
        _FLUSH_N.inc()
        _FLUSH_SIZE.observe(n)
        if dur_s is not None:
            _PEEL_S.observe(dur_s)
        ps = self.graph.last_peel_stats
        d = peel_stats_dict(ps)
        if ps is not self._stats_seen:
            _PEEL_WAVES.inc(d["waves"])
            _PEEL_KILLS.inc(d["kills"])
            _PEEL_DELTAS.inc(d["deltas"])
            self._stats_seen = ps
        return d

    # -- graceful degradation -------------------------------------------------
    def _breaker_blocks(self) -> bool:
        """Whether writes must shed right now.  The closed-and-healthy fast
        path never touches the gauge; an open breaker probes ``allow()`` so
        the cooldown can flip it half-open (the probe that lets one retry
        through)."""
        if self._degraded_reason is None and self.breaker.state == CLOSED:
            return False
        ok = self.breaker.allow()
        _BREAKER_G.set(self.breaker.state_code)
        return not ok

    def _degrade(self, reason: str, exc: BaseException | None = None):
        """Enter degraded mode: breaker open, writes shed with an explicit
        ``Overloaded(reason=...)``, committed reads keep serving."""
        if self.breaker.state != "open":
            self.breaker.trip()
        first = self._degraded_reason is None
        self._degraded_reason = reason
        _BREAKER_G.set(self.breaker.state_code)
        _DEGRADED_N.labels(reason=reason).inc()
        obs_trace.instant("service.degraded", reason=reason,
                          err="" if exc is None else repr(exc)[:120])
        if first:  # one bundle per healthy->degraded transition, not per shed
            obs_flightrec.FLIGHT.trip(
                "breaker_open", reason=reason, gen=self.gen,
                err="" if exc is None else repr(exc)[:200])

    def _recovered(self):
        """Leave degraded mode after a definitive success: close the
        breaker and mark quarantined generations that have since committed
        (half-open retry or self-heal replay) as recovered — in memory and
        in their on-disk sidecars."""
        self.breaker.record_success()
        _BREAKER_G.set(self.breaker.state_code)
        if self._degraded_reason is not None:
            obs_trace.instant("service.recovered", was=self._degraded_reason)
            self._degraded_reason = None
        for g, meta in self._quarantined.items():
            if meta["status"] == "quarantined" and g <= self.gen:
                meta["status"] = "recovered"
                if self.store is not None:
                    try:
                        self.store.write_quarantine_gen(
                            g, meta["records"], meta["reason"],
                            status="recovered")
                    except OSError:
                        pass  # sidecar is advisory

    def _degraded_retry_ms(self) -> float:
        """Retry hint for shed writes: the breaker cooldown (the soonest a
        half-open probe can possibly be admitted)."""
        return 1e3 * max(self.breaker.cooldown_s, 1e-3)

    def _shed(self, reason_default: str = "degraded") -> Overloaded:
        """Refuse one write while degraded (nothing hits the WAL)."""
        self.overloaded += 1
        self._last_shed_gen = self.gen
        _DEGRADED_SHED_N.inc()
        reason = self._degraded_reason or reason_default
        obs_trace.instant("service.shed", gen=self.gen, reason=reason)
        return Overloaded(retry_after_ms=self._degraded_retry_ms(),
                          gen=self.gen, reason=reason)

    def _append_failed(self, exc: OSError) -> Overloaded:
        """One WAL append failed (rolled back — nothing acked).  Count it
        toward the breaker's consecutive-failure threshold; repeated
        failures trip into io-degraded mode."""
        self.breaker.record_failure()
        _BREAKER_G.set(self.breaker.state_code)
        if self.breaker.state == "open":
            self._degrade("io", exc)
        obs_trace.instant("wal.append_failed", err=repr(exc)[:120])
        return Overloaded(retry_after_ms=self._degraded_retry_ms(),
                          gen=self.gen, reason="io")

    def _fsync_retry(self):
        """fsync under the retry policy; re-raises the last ``OSError``
        when the policy exhausts (callers degrade on it)."""
        if self.store is None:
            return
        try:
            self.retry.call(self.store.fsync, retry_on=(OSError,))
        except RetryExhausted as exc:
            cause = exc.__cause__
            raise cause if isinstance(cause, OSError) else exc

    def _guarded_apply(self, group, gen: int, defer_sync: bool = False):
        """``apply_batch`` with the degradation ladder: a failure on the
        configured engine retries once as a forced fused **recompute**
        (the delta engine's affected-region bookkeeping is the usual
        culprit; a from-scratch re-peel of the batch sidesteps it and
        produces the same phi).  If the fallback also fails the generation
        is poisoned — the caller quarantines it."""
        try:
            if self.chaos is not None:
                self.chaos.check_dispatch(gen, "auto")
            return self.graph.apply_batch(group, strategy=self.strategy,
                                          defer_sync=defer_sync)
        except Exception as first:
            _PEEL_FAULT_N.inc()
            obs_trace.instant("peel.fault", gen=gen, err=repr(first)[:120])
            try:
                if self.chaos is not None:
                    self.chaos.check_dispatch(gen, "recompute")
                out = self.graph.apply_batch(group, strategy="fused",
                                             engine="recompute",
                                             defer_sync=defer_sync)
            except Exception as second:
                raise GenerationPoisoned(gen, len(group), second) from first
            _FALLBACK_N.inc()
            obs_trace.instant("peel.fallback", gen=gen, engine="recompute")
            return out

    def _quarantine_gen(self, gen: int, records, exc: BaseException):
        """Quarantine one poisoned generation.  The records are *kept* —
        they are durable in the WAL and stay queued for the half-open
        retry (or get re-derived by a self-heal replay); the on-disk
        sidecar makes the poison visible to operators and ``scrub``."""
        cause = getattr(exc, "__cause__", None) or exc
        reason = repr(cause)[:200]
        self._quarantined[gen] = {"n": len(records),
                                  "records": [tuple(r) for r in records],
                                  "reason": reason, "status": "quarantined"}
        if self.store is not None:
            try:
                self.store.write_quarantine_gen(gen, records, reason)
            except OSError:
                pass  # sidecar is advisory; the WAL already has the records
        obs_flightrec.FLIGHT.trip("quarantine", gen=gen, n=len(records),
                                  reason=reason)
        self._degrade("poisoned", exc)

    def _self_heal(self) -> bool:
        """Rebuild the in-memory oracle from the durable store: reload the
        snapshot and replay the **full** acked WAL tail through the normal
        grouped replay.  The log's generation tags are preserved — pending
        and quarantined generations are re-derived rather than re-acked —
        so replicas tailing the same log stay bitwise-equal to the healed
        primary.  Returns True when the service recovered (breaker closed,
        quarantined generations marked recovered)."""
        if self.store is None:
            return False  # nothing to rebuild from: degraded until restart
        _HEAL_N.inc()
        try:
            with obs_trace.span("service.self_heal", gen=self.gen):
                tree = self.store.load_snapshot()
                if tree is None:
                    return False
                n, d, e = (int(x) for x in tree["spec"])
                state = GraphState(*tree["state"])
                self.graph = DynamicGraph.from_state(
                    GraphSpec(n, d, e), state, self.support_method,
                    tuple(int(k) for k in tree["tracked"]),
                    mesh=self.graph.mesh, partition=self.partition,
                    device=self.graph.device)
                self.gen = int(tree["gen"])
                self._applied_wal = int(tree["wal_len"])
                self._pending = []
                self._inflight = None
                self._stats_seen = None
                self._replay(
                    self.store.read_wal(start=self._applied_wal),
                    annotations=self.store.read_trace_annotations())
                self._open_gen = self.gen + 1
                self._open_count = 0
                try:
                    self.store.publish_commit(self.gen, self._applied_wal)
                except OSError:
                    pass  # advisory: replicas lag until the next commit
        except Exception as exc:
            obs_trace.instant("service.self_heal_failed",
                              err=repr(exc)[:120])
            if self.breaker.state != "open":
                self.breaker.trip()
            _BREAKER_G.set(self.breaker.state_code)
            return False
        self._needs_heal = False
        self._recovered()
        self._capture_committed()  # _replay skips it when the tail is empty
        return True

    def attach_slo(self, engine) -> "TrussService":
        """Wire an SLO engine (``repro.obs.slo.SLOEngine``'s interface;
        ported as ``repro_torch.obs.slo``): it is evaluated (internally
        rate-limited) at every commit and inside ``stats()``, which then
        reports ``stats()["slo"]``.  Returns self for chaining."""
        self.slo = engine
        return self

    def _annotate_gen(self, gen: int):
        """Stamp the currently bound trace context into the WAL as a
        ``# trace`` annotation, once per generation and *before* the
        generation's first record — tailers learn the originating trace id
        ahead of the group they will replay, so replica apply spans join
        the writer's trace.  Advisory: an annotation append failure never
        fails the write it precedes (the record append decides the ack)."""
        ctx = obs_trace.TRACER.ctx
        if ctx is None or self.store is None or gen == self._annotated_gen:
            return
        try:
            self.store.append_annotation(gen, ctx.trace_id)
            self._annotated_gen = gen
        except OSError:
            pass

    # -- writes ---------------------------------------------------------------
    @staticmethod
    def _admit(view: set, op: int, a: int, b: int) -> tuple[int, int]:
        """Admission validation against a logical view (committed + pending
        effects): self-loops, insert-of-present, delete-of-absent.  Returns
        the canonical edge key; the caller folds the effect into the view
        once the write is durable."""
        if a == b:
            raise ValueError("self-loops are not allowed")
        key = (min(a, b), max(a, b))
        if op == OP_INSERT:
            if key in view:
                raise ValueError(f"insert of present edge {key}")
        elif key not in view:
            raise ValueError(f"delete of absent edge {key}")
        return key

    def submit(self, op: int, a: int, b: int) -> WriteAck | Overloaded:
        """Acknowledge one update.  Validation runs against the *logical*
        view (committed + pending), so an ack is a commitment: the write is
        durable in the WAL and will apply at the next generation boundary.
        In pipeline mode a full pending queue with the device busy returns
        ``Overloaded`` instead (the write is NOT acked — nothing appended,
        view unchanged); retry after ``retry_after_ms``.  A degraded
        service (breaker open) sheds every write the same way, with
        ``reason`` naming why — committed reads keep serving throughout."""
        op, a, b = int(op), int(a), int(b)
        if self.pipeline:
            return self._submit_pipelined(op, a, b)
        if self._breaker_blocks():
            return self._shed()
        if self._needs_heal and not self._self_heal():
            return self._shed()
        t0 = time.perf_counter()
        key = self._admit(self._view, op, a, b)
        self._annotate_gen(self.gen + 1)
        # WAL first: if the append fails (disk full, closed store) the view
        # and pending queue are untouched and the submit can be retried
        try:
            wal_index = (self.store.append(self.gen + 1, [(op, a, b)])
                         if self.store is not None else -1)
        except OSError as exc:
            return self._append_failed(exc)
        if self.breaker.failures:
            self.breaker.record_success()  # the failure run was transient
        if op == OP_INSERT:
            self._view.add(key)
        else:
            self._view.discard(key)
        ack = WriteAck(gen=self.gen + 1, wal_index=wal_index)
        _WRITE_ACK_S.observe(time.perf_counter() - t0)
        self._pending.append((op, a, b))
        if len(self._pending) >= self.flush_every:
            self.flush()
        return ack

    # -- pipelined ingest (pipeline=True) -------------------------------------
    def _submit_pipelined(self, op: int, a: int, b: int) -> WriteAck | Overloaded:
        """Admit one write while an earlier generation's re-peel may still
        be running on the device.  The host path (validate, WAL-append,
        queue) never waits for the device; ``_pump`` opportunistically lands
        a finished generation and dispatches the next sealed one."""
        if self._breaker_blocks():
            return self._shed()
        if self._needs_heal and not self._self_heal():
            return self._shed()
        self._pump()
        if (len(self._pending) >= self.max_pending
                and self._inflight is not None):
            # bounded queue is full and the device is mid-generation: shed
            # load explicitly rather than stalling every later writer
            self.overloaded += 1
            self._last_shed_gen = self.gen
            _SHED_N.inc()
            obs_trace.instant("pipeline.shed", gen=self.gen,
                              queue=len(self._pending))
            retry = 1e3 * (self._ewma_gen_s or 1e-3)
            return Overloaded(retry_after_ms=retry, gen=self.gen)
        t0 = time.perf_counter()
        key = self._admit(self._view, op, a, b)
        gen = self._open_gen
        self._annotate_gen(gen)
        # WAL first (acked-before-applied): a failed append leaves the view
        # and queue untouched, so the submit can simply be retried
        try:
            wal_index = (self.store.append(gen, [(op, a, b)])
                         if self.store is not None else -1)
        except OSError as exc:
            return self._append_failed(exc)
        if self.breaker.failures:
            self.breaker.record_success()  # the failure run was transient
        if op == OP_INSERT:
            self._view.add(key)
        else:
            self._view.discard(key)
        _WRITE_ACK_S.observe(time.perf_counter() - t0)
        self._pending.append((gen, op, a, b))
        self._open_count += 1
        if self._open_count >= self._flush_target:
            self._seal()
        self._pump()
        _Q_DEPTH.set(len(self._pending))
        return WriteAck(gen=gen, wal_index=wal_index)

    def _seal(self):
        """Close the open generation: later records tag the next one.  The
        host arrival rate is sampled here (records per wall-second between
        seals) — one half of the adaptive-flush balance point."""
        now = time.perf_counter()
        if self._last_seal_t is not None and self._open_count > 0:
            inst = self._open_count / max(now - self._last_seal_t, 1e-9)
            self._ewma_rate = (inst if self._ewma_rate is None else
                               (1 - _EWMA_ALPHA) * self._ewma_rate
                               + _EWMA_ALPHA * inst)
        self._last_seal_t = now
        self._open_gen += 1
        self._open_count = 0

    def _dispatch_next(self) -> bool:
        """Dispatch the oldest queued generation group to the device without
        blocking on the result (requires no generation in flight).  Records
        leave ``_pending`` here; they count as applied only at completion.
        Returns whether the pipeline made progress — False means the
        service degraded (fsync exhausted, generation poisoned) and the
        caller must stop pumping; the group's records are back at the head
        of the queue for the half-open retry."""
        tag = self._pending[0][0]
        n = 0
        while n < len(self._pending) and self._pending[n][0] == tag:
            n += 1
        group = [rec[1:] for rec in self._pending[:n]]
        if self.store is not None:
            # durable before applied — and *before* the records leave the
            # queue, so an exhausted fsync degrades with nothing half-dequeued
            try:
                self._fsync_retry()
            except OSError as exc:
                self._degrade("io", exc)
                return False
        del self._pending[:n]
        if tag == self._open_gen:
            # draining a still-open partial group (explicit flush): later
            # submits start a fresh generation
            self._seal()
        _Q_DEPTH.set(len(self._pending))
        t0 = time.perf_counter()
        try:
            with obs_trace.span("gen.dispatch", gen=tag, n=n):
                hi = self._guarded_apply(group, tag, defer_sync=True)
        except GenerationPoisoned as exc:
            self._pending[:0] = [(tag, op, a, b) for op, a, b in group]
            _Q_DEPTH.set(len(self._pending))
            self._quarantine_gen(tag, group, exc)
            return False
        try:
            if hi is None:
                # netted no-op or progressive path: already applied and
                # synced — this dispatch doubles as the landing, so the
                # chaos land hook fires here, and commit is immediate
                if self.chaos is not None:
                    self.chaos.check_land(tag)
                self._commit_generation(tag, n,
                                        dur_s=time.perf_counter() - t0)
                return True
        except Exception as exc:
            reason = ("invariant" if isinstance(exc, InvariantViolation)
                      else "poisoned")
            obs_trace.instant("gen.land_failed", gen=tag,
                              err=repr(exc)[:120])
            self._degrade(reason, exc)
            self._needs_heal = True
            self._self_heal()
            return False
        event = None
        if hi.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(hi.device))
        self._inflight = _Inflight(gen=tag, n=n, hi=hi, t0=t0, event=event)
        return True

    def _commit_generation(self, gen: int, n: int,
                           dur_s: float | None = None):
        """Advance the committed frontier: generation ``gen`` (``n`` WAL
        records) has fully landed.  All commit paths (serial flush,
        pipelined land, netted no-op dispatch, replay) funnel through here,
        so this is where the registry counters advance and the committed
        stats snapshot refreshes.

        ``_capture_committed`` may raise ``InvariantViolation`` — in that
        case the durable frontier is *not* published (replicas never see a
        frontier covering a suspect state) and the caller degrades.  A
        failed ``commit.json`` write is tolerated: the frontier file is
        advisory (replicas just lag until the next successful publish),
        losing it must not fail an already-landed generation."""
        self.gen = gen
        self._applied_wal += n
        peel = self._record_commit_metrics(n, dur_s)
        self._capture_committed(peel)
        obs_flightrec.FLIGHT.note("commit", gen=self.gen, n=n,
                                  wal=self._applied_wal)
        obs_flightrec.FLIGHT.tick()
        if self.slo is not None:
            self.slo.evaluate()
        if self.store is not None:
            try:
                self.store.publish_commit(self.gen, self._applied_wal)
            except OSError as exc:
                self.breaker.record_failure()
                _BREAKER_G.set(self.breaker.state_code)
                obs_trace.instant("commit.publish_failed",
                                  gen=self.gen, err=repr(exc)[:120])
        # a full commit is the definitive success signal: close the breaker
        # and flip any retried quarantined generations to recovered (skipped
        # mid-heal — the heal reports success itself once the replay is done)
        if not self._needs_heal and (
                self._degraded_reason is not None
                or self.breaker.state != CLOSED or self.breaker.failures):
            self._recovered()

    def _complete(self, wait: bool = True) -> bool:
        """Land the in-flight generation.  ``wait=False`` only completes a
        generation whose device result is already materialized (the
        opportunistic path ``_pump`` uses); ``wait=True`` blocks.  Returns
        whether a generation was committed."""
        inf = self._inflight
        if inf is None:
            return False
        if not wait and inf.event is not None and not inf.event.query():
            return False
        # int(hi) blocks until the stream has reached it (the re-peel's
        # phi is written before it), then the deferred index invalidation
        # runs before any query can read labels
        try:
            with obs_trace.span("gen.land", gen=inf.gen, n=inf.n) as sp:
                if self.chaos is not None:
                    self.chaos.check_land(inf.gen)
                self.graph.index.invalidate(2, max(int(inf.hi), 1))
                dt = time.perf_counter() - inf.t0
                self._inflight = None
                self._commit_generation(inf.gen, inf.n, dur_s=dt)
                sp.set(**self._committed["peel"])
        except Exception as exc:
            # a device-side failure surfacing at the blocking read, or an
            # invariant violation at commit: the generation's result is
            # lost/untrusted but its records are durable in the WAL
            # (acked-before-applied), so rebuild the oracle from the store
            self._inflight = None
            reason = ("invariant" if isinstance(exc, InvariantViolation)
                      else "poisoned")
            _PEEL_FAULT_N.inc()
            obs_trace.instant("gen.land_failed", gen=inf.gen,
                              err=repr(exc)[:120])
            self._degrade(reason, exc)
            self._needs_heal = True
            return self._self_heal()
        self._observe_gen_latency(dt)
        return True

    def _observe_gen_latency(self, dt: float):
        """EWMA the per-generation commit latency and retune the adaptive
        dispatch threshold: the balance point is the number of records that
        arrive while one generation commits (rate x latency) — dispatching
        less than that grows the queue without bound, much more only adds
        latency.  When the latency EWMA breaches ``target_p99_ms``, a
        single peel already blows the budget, so amortize harder (double
        past the balance point) — throughput is all that can improve."""
        self._ewma_gen_s = (dt if self._ewma_gen_s is None else
                            (1 - _EWMA_ALPHA) * self._ewma_gen_s
                            + _EWMA_ALPHA * dt)
        if self.target_p99_ms is None or self._ewma_rate is None:
            return
        balance = self._ewma_rate * self._ewma_gen_s
        need = max(1, int(np.ceil(balance * 1.25)))  # keep-up + headroom
        if self._ewma_gen_s * 1e3 > float(self.target_p99_ms):
            need *= 2
        self._flush_target = int(min(max(need, 1), self.max_pending))
        _FLUSH_TARGET_G.set(self._flush_target)

    def _pump(self):
        """Non-blocking pipeline advance: land the in-flight generation if
        its result has materialized, then (device free) dispatch the oldest
        sealed generation.  This is the whole overlap mechanism — every
        host-side admission step calls it, so device completion is noticed
        at the next write rather than at the next read barrier."""
        if self._inflight is not None:
            self._complete(wait=False)
        while (self._inflight is None and self._pending
               and self._pending[0][0] < self._open_gen
               and not self._breaker_blocks()):
            if not self._dispatch_next():
                break

    def submit_many(self, updates) -> list[WriteAck]:
        """Batch admission: validate every record against the logical view
        first (all-or-nothing — a bad record acks nothing), WAL-append the
        whole batch as **one** ``append_tagged`` write, then net it into
        generations exactly as per-record ``submit`` would.  The gen tags
        are simulated up front so they track auto-flush boundaries
        record-for-record (replay regroups by tag), and the store's dirty
        tracking collapses the internal flushes to a single fsync for the
        whole call.

        Pipeline mode keeps the same all-or-nothing admission and single
        WAL write, but feeds the queue through the non-blocking ``_pump``
        path; when the bounded queue fills mid-batch it *drains* (waits for
        the device) instead of shedding — the whole batch was already acked
        by the one append, so bulk loads degrade to cooperative blocking
        rather than returning ``Overloaded``."""
        ups = [(int(op), int(a), int(b)) for op, a, b in updates]
        if not ups:
            return []
        # a batch cannot be partially acked, so degraded mode refuses it as
        # a unit (per-record submit returns Overloaded instead)
        if self._breaker_blocks() or (self._needs_heal
                                      and not self._self_heal()):
            raise Unavailable(
                f"service degraded ({self._degraded_reason or 'breaker open'})")
        if self.pipeline:
            return self._submit_many_pipelined(ups)
        view = set(self._view)
        tagged = []
        gen, pend = self.gen, len(self._pending)
        for op, a, b in ups:
            key = self._admit(view, op, a, b)
            if op == OP_INSERT:
                view.add(key)
            else:
                view.discard(key)
            tagged.append((gen + 1, op, a, b))
            pend += 1
            if pend >= self.flush_every:  # mirror submit's auto-flush
                gen += 1
                pend = 0
        t0 = time.perf_counter()
        for g in dict.fromkeys(t[0] for t in tagged):
            self._annotate_gen(g)
        # WAL first (one write, rollback on failure leaves nothing acked)
        try:
            start = (self.store.append_tagged(tagged)
                     if self.store is not None else -1)
        except OSError as exc:
            self._append_failed(exc)
            raise
        _WRITE_ACK_S.observe(time.perf_counter() - t0)
        self._view = view
        acks = []
        for i, (tag, op, a, b) in enumerate(tagged):
            acks.append(WriteAck(gen=tag,
                                 wal_index=start + i if start >= 0 else -1))
            self._pending.append((op, a, b))
            if len(self._pending) >= self.flush_every:
                self.flush()
        return acks

    def _submit_many_pipelined(self, ups) -> list[WriteAck]:
        """Pipelined twin of ``submit_many``: simulate the generation tags
        up front (sealing at the *current* adaptive target), append the
        whole batch once, then walk the tags through the live queue.  The
        pre-computed tags are authoritative — the adaptive target may
        retune mid-walk (a completion inside ``_pump`` does that) — so
        seals are driven by tag changes, not by re-reading the threshold."""
        view = set(self._view)
        tagged = []
        gen, cnt = self._open_gen, self._open_count
        target = self._flush_target  # frozen for the simulation
        for op, a, b in ups:
            key = self._admit(view, op, a, b)
            if op == OP_INSERT:
                view.add(key)
            else:
                view.discard(key)
            tagged.append((gen, op, a, b))
            cnt += 1
            if cnt >= target:
                gen += 1
                cnt = 0
        t0 = time.perf_counter()
        for g in dict.fromkeys(t[0] for t in tagged):
            self._annotate_gen(g)
        # WAL first (one write, rollback on failure leaves nothing acked)
        try:
            start = (self.store.append_tagged(tagged)
                     if self.store is not None else -1)
        except OSError as exc:
            self._append_failed(exc)
            raise
        _WRITE_ACK_S.observe(time.perf_counter() - t0)
        self._view = view
        acks = []
        for i, (tag, op, a, b) in enumerate(tagged):
            acks.append(WriteAck(gen=tag,
                                 wal_index=start + i if start >= 0 else -1))
            if tag != self._open_gen:
                self._seal()
                self._open_gen = tag  # tags are authoritative (see above)
            self._pending.append((tag, op, a, b))
            self._open_count += 1
            if len(self._pending) >= self.max_pending:
                # cooperative bulk-load backpressure: every record is
                # already durable, so wait for the device instead of
                # shedding acked work
                self._complete(wait=True)
            self._pump()
        # land the simulation's final open-generation bookkeeping (the last
        # group may have sealed exactly at the target boundary)
        if cnt == 0:
            self._seal()
        self._open_gen, self._open_count = gen, cnt
        self._pump()
        return acks

    def handle_write(self, req: WriteRequest) -> WriteAck:
        """Typed-request form of ``submit`` (mirror of ``handle``)."""
        return self.submit(req.op, req.a, req.b)

    def flush(self) -> int:
        """Commit pending writes as one netted fused batch; bump generation.
        No-op when nothing is pending.  Returns the committed generation.
        Each commit advances the store's published frontier so replica
        tailers know the WAL prefix below it holds only complete
        generation groups.

        Pipeline mode: **drain** — land the in-flight generation, then
        dispatch-and-land every queued group (including a partial open one)
        in WAL order.  This is the read barrier every query takes, so reads
        keep happening at generation boundaries with read-your-writes.

        Degraded mode: a blocked breaker makes flush a no-op (reads serve
        the committed state, queued records wait for the half-open probe);
        the probe itself arrives here too — it retries the quarantined
        head group, or self-heals from the store when the in-memory oracle
        is marked untrusted."""
        if self._breaker_blocks():
            if self.pipeline and self._inflight is not None:
                # bounded wait for work already running: landing it keeps
                # the committed state consistent with the arrays queries read
                self._complete(wait=True)
            return self.gen
        if self._needs_heal:
            # everything pending is re-derived from the WAL by the heal —
            # nothing left to flush on success, still degraded on failure
            self._self_heal()
            return self.gen
        if self.pipeline:
            if self._inflight is None and not self._pending:
                return self.gen
            with obs_trace.span("flush", mode="drain",
                                pending=len(self._pending)):
                with obs_profiling.profile_region("flush"):
                    self._complete(wait=True)
                    while self._pending and not self._breaker_blocks():
                        if not self._dispatch_next():
                            break
                        self._complete(wait=True)
            _Q_DEPTH.set(len(self._pending))
            return self.gen
        if not self._pending:
            return self.gen
        with obs_trace.span("flush", mode="serial", n=len(self._pending)):
            with obs_profiling.profile_region("flush"):
                if self.store is not None:
                    try:
                        self._fsync_retry()
                    except OSError as exc:
                        self._degrade("io", exc)
                        return self.gen
                t0 = time.perf_counter()
                try:
                    self._guarded_apply(self._pending, self.gen + 1)
                except GenerationPoisoned as exc:
                    # records stay pending: durable in the WAL, retried at
                    # the next half-open probe
                    self._quarantine_gen(self.gen + 1, list(self._pending),
                                         exc)
                    return self.gen
                n_applied = len(self._pending)
                self._pending = []
                try:
                    self._commit_generation(self.gen + 1, n_applied,
                                            dur_s=time.perf_counter() - t0)
                except InvariantViolation as exc:
                    self._degrade("invariant", exc)
                    self._needs_heal = True
                    self._self_heal()
                    return self.gen
        return self.gen

    # -- queries (read-your-writes: flush first) ------------------------------
    def _labels(self, k: int) -> np.ndarray:
        if self.indexed:
            self.graph.index.track(k)
            return _host(self.graph.index.query(self.graph.state, k))
        return _host(component_labels(self.graph.spec, self.graph.state, k))

    def k_truss_members(self, k: int) -> np.ndarray:
        """[m, 2] edges with phi >= k."""
        self.flush()
        return self.graph.k_truss(k)

    def max_k(self, a: int, b: int) -> int:
        """phi(e): the largest k such that edge (a, b) is in a k-truss."""
        self.flush()
        u, v = min(int(a), int(b)), max(int(a), int(b))
        dev = self.graph.device
        slot, found = lookup_edge(self.graph.spec, self.graph.state,
                                  torch.tensor(u, dtype=torch.int32, device=dev),
                                  torch.tensor(v, dtype=torch.int32, device=dev))
        return int(self.graph.state.phi[int(slot)]) if bool(found) else 0

    def community_of(self, k: int, node: int | None = None,
                     edge: tuple[int, int] | None = None) -> np.ndarray:
        """[m, 2] edges of the k-truss component containing ``node`` or
        ``edge`` (empty when the seed is not in any k-truss).  Connectivity
        is node-sharing, so a node belongs to at most one component."""
        self.flush()
        lab = self._labels(k)
        edges = _host(self.graph.state.edges)
        member = _host(self.graph.state.active) & (lab < _INF)
        if edge is not None:
            u, v = min(int(edge[0]), int(edge[1])), max(int(edge[0]), int(edge[1]))
            hit = member & (edges[:, 0] == u) & (edges[:, 1] == v)
        else:
            hit = member & ((edges[:, 0] == int(node)) | (edges[:, 1] == int(node)))
        if not hit.any():
            return np.zeros((0, 2), edges.dtype)
        target = lab[hit].min()
        return edges[member & (lab == target)]

    def representatives(self, k: int) -> np.ndarray:
        """[c, 2] one representative (min-slot) edge per k-truss component."""
        self.flush()
        if self.indexed:
            self.graph.index.track(k)
            rep, _ = self.graph.index.query_representatives(self.graph.state, k)
        else:
            rep, _ = core_representatives(self.graph.spec, self.graph.state, k)
        return _host(self.graph.state.edges)[_host(rep)]

    def handle(self, req: QueryRequest) -> QueryResponse:
        """Dispatch one typed query (the CLI/benchmark entry point)."""
        t0 = time.perf_counter()
        try:
            with obs_trace.span("query", kind=str(req.kind), k=req.k):
                return self._handle(req)
        finally:
            _QUERY_S.labels(kind=str(req.kind)).observe(
                time.perf_counter() - t0)

    def _handle(self, req: QueryRequest) -> QueryResponse:
        if req.kind == MEMBERS:
            edges = self.k_truss_members(req.k)
        elif req.kind == COMMUNITY:
            edges = self.community_of(req.k, node=req.node, edge=req.edge)
        elif req.kind == MAX_K:
            value = self.max_k(*req.edge)
            return QueryResponse(req, self.gen, value=value)
        elif req.kind == REPRESENTATIVES:
            edges = self.representatives(req.k)
        else:
            raise ValueError(f"unknown query kind {req.kind!r}")
        # self.gen is read *after* the query flushed (read-your-writes)
        return QueryResponse(req, self.gen, edges=edges)

    def handle_committed(self, req: QueryRequest) -> QueryResponse:
        """Serve one query from the *committed* state only — no flush, so
        acked-but-pending writes stay queued on the admission schedule.
        This is the bounded-staleness read path on a primary (lag 0 from
        the committed generation, and it never interferes with write
        batching the way the flush-first ``handle`` does).

        Pipeline mode: the arrays in ``self.graph.state`` belong to the
        *in-flight* generation (dispatched, possibly unlanded, not yet
        committed), so this first waits for that generation to land and
        commits it — a bounded wait for work already running, never a new
        dispatch.  Queued/sealed generations stay queued."""
        if self.pipeline:
            self._complete(wait=True)
        pending, self._pending = self._pending, []
        try:
            return self.handle(req)
        finally:
            self._pending = pending

    # -- durability -----------------------------------------------------------
    def snapshot(self, stream_state: dict | None = None) -> str:
        """Flush, then checkpoint (spec, state, gen, WAL high-water mark,
        tracked levels[, input-stream state]) atomically.  The store then
        compacts the WAL prefix the snapshot covers; restore replays only
        the tail past the high-water mark."""
        if self.store is None:
            raise ValueError("service has no store")
        self.flush()
        if self._pending or self._inflight is not None:
            # degraded flush is a no-op: the WAL holds acked records the
            # state does not cover, and a snapshot stamped with the current
            # wal_len would make restore skip them — refuse instead
            raise Unavailable(
                f"cannot snapshot while degraded "
                f"({self._degraded_reason or 'breaker open'}): "
                f"{len(self._pending)} acked records unapplied")
        self.store.fsync()
        spec = self.graph.spec
        tree = {
            "spec": [spec.n_nodes, spec.d_max, spec.e_cap],
            "state": tuple(self.graph.state),
            "gen": self.gen,
            "wal_len": self.store.wal_len,
            "tracked": [int(k) for k in self.graph.index.tracked],
        }
        if stream_state is not None:
            tree["stream"] = stream_state
        self.store.snapshot(tree)
        self.store.publish_commit(self.gen, self._applied_wal)
        return self.store.snap_path

    @classmethod
    def _from_snapshot_tree(cls, tree: dict, *, store: TrussStore | None,
                            flush_every: int = 16, strategy: str = "auto",
                            indexed: bool = True,
                            support_method: str = "sorted",
                            mesh=None, partition: str = "replicated",
                            pipeline: bool = False,
                            target_p99_ms=None,
                            max_pending: int | None = None, chaos=None,
                            breaker: CircuitBreaker | None = None,
                            retry: RetryPolicy | None = None,
                            device="cuda") -> "TrussService":
        """Rebuild a service around a snapshot tree — no WAL replay.  Shared
        by ``restore`` and the cluster ``Replica`` (which bootstraps with
        ``store=None`` and tails the primary's WAL itself)."""
        n, d, e = (int(x) for x in tree["spec"])
        state = GraphState(*tree["state"])
        svc = cls.__new__(cls)
        svc.graph = DynamicGraph.from_state(
            GraphSpec(n, d, e), state, support_method,
            tuple(int(k) for k in tree["tracked"]), mesh=mesh,
            partition=partition, device=device)
        svc.store = store
        svc.flush_every = int(flush_every)
        svc.strategy = strategy
        svc.indexed = indexed
        svc.support_method = support_method
        svc.partition = partition
        svc.gen = int(tree["gen"])
        svc._pending = []
        svc._applied_wal = int(tree["wal_len"])
        svc._view = set(svc.graph._present)
        svc.stream_state = tree.get("stream")
        svc.replayed_records = 0
        svc._init_faults(chaos, breaker, retry)
        svc._init_pipeline(pipeline, target_p99_ms, max_pending)
        return svc

    @classmethod
    def restore(cls, store: TrussStore, *, flush_every: int = 16,
                strategy: str = "auto", indexed: bool = True,
                support_method: str = "sorted", mesh=None,
                partition: str = "replicated",
                pipeline: bool = False, target_p99_ms=None,
                max_pending: int | None = None, chaos=None,
                breaker: CircuitBreaker | None = None,
                retry: RetryPolicy | None = None,
                device="cuda") -> "TrussService":
        """Last snapshot + WAL-tail replay => the exact pre-crash oracle.
        The replay applies *every* acked record, committed or not — an
        in-flight generation a pipelined primary lost in the crash is
        simply discarded on the device side and re-derived here from its
        WAL group (same guarantee as the serial path).  The store itself
        already repaired or quarantined any corrupt WAL tail when it was
        opened (see ``TrussStore``); a corrupt record *below* the committed
        frontier raised there and never reaches this constructor."""
        tree = store.load_snapshot()
        if tree is None:
            raise ValueError(f"no snapshot in {store.root}")
        svc = cls._from_snapshot_tree(tree, store=store,
                                      flush_every=flush_every,
                                      strategy=strategy, indexed=indexed,
                                      support_method=support_method,
                                      mesh=mesh, partition=partition,
                                      pipeline=pipeline,
                                      target_p99_ms=target_p99_ms,
                                      max_pending=max_pending, chaos=chaos,
                                      breaker=breaker, retry=retry,
                                      device=device)
        start = svc._applied_wal
        svc._replay(store.read_wal(start=start),
                    annotations=store.read_trace_annotations())
        # the next admitted write opens the generation after the replayed
        # tail (the reference leaves it after the snapshot's, so a
        # pipelined restore tagged new writes below the committed gen)
        svc._open_gen = svc.gen + 1
        # records past the snapshot's high-water mark that replay re-derived
        # (launchers use this to fast-forward deterministic input streams —
        # NOT wal_len - base, which under compact-to-prev retention counts
        # the previous snapshot's tail too)
        svc.replayed_records = svc._applied_wal - start
        store.publish_commit(svc.gen, svc._applied_wal)
        return svc

    def _replay(self, tail, max_groups: int | None = None,
                annotations: dict | None = None) -> int:
        """Apply WAL-tail records grouped by their generation tag — the same
        batch boundaries the live service flushed at, so the replayed path
        runs the identical netted ``apply_batch`` sequence.  Advances
        ``_applied_wal`` per group, so a capped replay (``max_groups``, the
        cluster replica's incremental poll) always stops at a group
        boundary and is resumable.  Returns the number of groups applied.

        ``annotations`` is the store's ``{gen: trace_id}`` map from WAL
        ``# trace`` records: a group whose generation was annotated replays
        under a child :class:`~repro_torch.obs.trace.TraceContext` of the
        originating write's trace, so ``gen.replay`` spans on a replica
        join the trace the router minted."""
        groups = 0
        group: list = []
        group_gen = None

        def commit_group():
            nonlocal groups, group, group_gen
            tid = annotations.get(group_gen) if annotations else None
            ctx = (obs_trace.TraceContext(tid, os.urandom(8).hex())
                   if tid is not None else None)
            t0 = time.perf_counter()
            with obs_trace.TRACER.bind(ctx), \
                    obs_trace.span("gen.replay", gen=group_gen, n=len(group)):
                # the guarded path gives replay the same delta->recompute
                # fallback the live flush has (a tail that poisoned the
                # primary engine still restores); GenerationPoisoned
                # propagates to the caller — loud on restore, caught and
                # reported by self-heal
                self._guarded_apply(group, group_gen)
                self._commit_generation(group_gen, len(group),
                                        dur_s=time.perf_counter() - t0)
            groups += 1
            group, group_gen = [], None

        for gen, op, a, b in tail:
            if group and gen != group_gen:
                commit_group()
                if max_groups is not None and groups >= max_groups:
                    break
            group_gen = gen
            group.append((op, a, b))
        else:
            if group:
                commit_group()
        self._view = set(self.graph._present)
        return groups

    # -- introspection --------------------------------------------------------
    def scrub(self, deep: bool = False) -> dict:
        """End-to-end integrity audit (no mutation, safe while degraded):
        the store's durability scrub (WAL record checksums, snapshot
        manifest digests, commit-frontier coverage, quarantine census)
        plus the in-memory phi-vs-bounds invariants on the current arrays —
        ``phi >= 2`` on every active edge, ``phi(u,v) <= min(deg u, deg v)
        + 1`` (an edge's truss number is bounded by its endpoints' degrees),
        and with ``deep=True`` the triangle bound ``phi(e) <= sup(e) + 2``
        (one full support recount).  Returns a report dict; ``ok`` is the
        conjunction of every check."""
        report: dict = {"ok": True, "violations": [], "store": None}
        if self.store is not None:
            s = self.store.scrub()
            report["store"] = s
            report["ok"] = bool(s["ok"])
            if not s["ok"]:  # store reports a count; name it here
                report["violations"].append(
                    f"store scrub: {s['violations']} violation(s)")
        act = _host(self.graph.state.active)
        phi = _host(self.graph.state.phi)
        edges = _host(self.graph.state.edges)
        viol = []
        if int(act.sum()) != len(self.graph._present):
            viol.append("active count != present-set size")
        if act.any():
            p = phi[act]
            if int(p.min()) < 2:
                viol.append("phi < 2 on an active edge")
            deg = np.bincount(edges[act].reshape(-1),
                              minlength=self.graph.spec.n_nodes)
            du, dv = deg[edges[act][:, 0]], deg[edges[act][:, 1]]
            if bool((p > np.minimum(du, dv) + 1).any()):
                viol.append("phi exceeds degree bound min(deg u, deg v)+1")
            if deep:
                from ..core.graph import support_all
                sup = _host(support_all(self.graph.spec,
                                        self.graph.state,
                                        self.graph.state.active))
                if bool((p > sup[act] + 2).any()):
                    viol.append("phi exceeds support bound sup+2")
        report["violations"].extend(viol)
        report["ok"] = report["ok"] and not viol
        report["degraded"] = self._degraded_reason
        report["quarantined"] = {int(g): m["status"]
                                 for g, m in self._quarantined.items()}
        if not report["ok"]:
            obs_flightrec.FLIGHT.trip(
                "scrub_violation", gen=self.gen,
                violations=list(report["violations"]))
        return report

    def stats(self) -> dict:
        """Operational counters: generations, WAL frontiers, peel + pipeline
        state.  Array-derived fields (``n_edges``, ``max_truss``, ``peel``,
        ``gen``) come from the snapshot captured at the last *committed*
        generation boundary — never from the live state, whose arrays may
        belong to a dispatched-but-unlanded generation (reading those would
        block the pipeline, and counting ``graph._present`` mid-flight
        reported effects of an uncommitted batch).  ``counters`` mirrors
        the process-wide registry (shared across services in one process);
        the full catalog is in docs/OBSERVABILITY.md."""
        c = self._committed
        out = {
            "gen": c["gen"],
            "n_edges": c["n_edges"],
            "pending": len(self._pending),
            "pending_queue_depth": len(self._pending),
            "last_shed_gen": self._last_shed_gen,
            "wal_len": self.store.wal_len if self.store else 0,
            "wal_applied": c["wal_applied"],
            "tracked_ks": tuple(self.graph.index.tracked),
            "max_truss": c["max_truss"],
            "peel": dict(c["peel"]),
            "degraded": self._degraded_reason,
            "breaker": {"state": self.breaker.state,
                        "trips": self.breaker.trips},
            "quarantined_gens": sorted(
                g for g, m in self._quarantined.items()
                if m["status"] == "quarantined"),
            # capacity-derived footprint model (what the current spec would
            # resident per device), not a live allocator reading — matches
            # the truss_bitmap_bytes / truss_state_bytes_per_device gauges
            "memory": {
                "bitmap_bytes_per_device":
                    self.graph.spec.bitmap_bytes_per_device,
                "state_bytes_per_device":
                    self.graph.spec.state_bytes_per_device,
                "partition": self.graph.spec.partition,
                "n_shards": self.graph.spec.n_shards,
            },
        }
        if self.slo is not None:
            self.slo.evaluate()
            out["slo"] = self.slo.state_dict()
        if self.store is not None:
            # replication lag per tailer, from the lease files the replicas
            # publish on every poll (generations + WAL records behind us)
            leases = self.store.read_replicas()
            if leases:
                out["replicas"] = {
                    rid: {"gen": int(m.get("gen", 0)),
                          "lag_gens": c["gen"] - int(m.get("gen", 0)),
                          "lag_records":
                              c["wal_applied"] - int(m.get("wal_applied", 0))}
                    for rid, m in leases.items()}
        reg = obs_metrics.REGISTRY
        out["counters"] = {
            "flushes": reg.value("truss_flush_total"),
            "fsyncs": reg.value("truss_wal_fsync_total"),
            "wal_records": reg.value("truss_wal_append_records_total"),
            "peel_waves": reg.value("truss_peel_waves_total"),
            "sheds": reg.value("truss_pipeline_shed_total"),
            "progressive_updates":
                reg.value("truss_progressive_updates_total"),
            "peel_faults": reg.value("truss_peel_fault_total"),
            "engine_fallbacks": reg.value("truss_engine_fallback_total"),
            "self_heals": reg.value("truss_self_heal_total"),
            "degraded_sheds": reg.value("truss_degraded_shed_total"),
        }
        if self.pipeline:
            out["pipeline"] = {
                "flush_target": self._flush_target,
                "inflight_gen": (self._inflight.gen
                                 if self._inflight is not None else None),
                "open_gen": self._open_gen,
                "ewma_gen_ms": (1e3 * self._ewma_gen_s
                                if self._ewma_gen_s is not None else None),
                "ewma_rate": self._ewma_rate,
                "overloaded": self.overloaded,
            }
        return out
