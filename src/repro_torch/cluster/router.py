"""Consistency-aware query router over a primary + N read replicas
(PyTorch port of ``repro.cluster.router``; the routing is host code).

Writes always go to the primary (single-writer discipline — the WAL has one
appender).  Reads fan out by the policy carried on each ``QueryRequest``:

* ``STRONG`` — primary only.  The primary flushes pending writes before
  answering, so the response is the freshest committed state.
* ``BOUNDED`` (``bound=g``) — any replica whose applied generation is
  within ``g`` generations of the primary's *committed* generation.
  Bounded reads never force a primary flush, so they are the policy that
  scales: they neither interfere with write batching nor queue behind it.
* ``READ_YOUR_WRITES`` — sessions carry a generation token: every
  ``WriteAck`` advances it (``ack.gen`` is the generation the write commits
  in), and reads only go to nodes whose applied gen has reached the token.
  The primary always qualifies (its flush-first query path commits the
  session's pending writes), so RYW can never serve a stale generation.

Replication here is pull-based: replicas advance when ``poll()`` runs.  The
router polls lazily — only when no replica satisfies a read's freshness
floor (``poll_on_miss``) — and callers drive steady-state catch-up with
``poll_replicas()`` at whatever heartbeat suits the deployment.

Failure handling (``repro_torch.faults``): a replica whose lease goes stale
(``lease_timeout_s`` without a poll) or whose read/poll raises is *evicted*
from the rotation — reads retry onto the next qualifying replica under a
``RetryPolicy`` and finally fall back to the primary, so one bad tailer
never fails a read that any healthy node could serve.  ``stats()`` reports
``evictions`` by replica id and cause.
"""
from __future__ import annotations

import dataclasses
import time

from ..faults.retry import RetryPolicy
from ..obs import metrics as obs_metrics, trace as obs_trace
from ..obs.state import STATE as _OBS_STATE
from ..service.api import (BOUNDED, COMMUNITY, MAX_K, MEMBERS,
                           READ_YOUR_WRITES, REPRESENTATIVES, STRONG,
                           Overloaded, QueryRequest, QueryResponse, WriteAck)
from ..service.engine import TrussService
from .replica import Replica

_ROUTED = obs_metrics.counter(
    "truss_router_reads_total",
    "reads routed, by consistency policy and serving node",
    labels=("consistency", "node"))
_EVICTED = obs_metrics.counter(
    "truss_router_evictions_total",
    "replicas removed from the read rotation, by cause",
    labels=("cause",))


def query_from_record(rec, consistency: str = STRONG,
                      bound: int = 0) -> QueryRequest:
    """Build a ``QueryRequest`` from a ``MixedWorkloadStream`` read record
    ``("r", kind, k, a, b)`` under the given routing policy."""
    _, kind, k, a, b = rec
    if kind == COMMUNITY:
        return QueryRequest(COMMUNITY, k=int(k), node=int(a),
                            consistency=consistency, bound=bound)
    if kind == MAX_K:
        return QueryRequest(MAX_K, edge=(int(a), int(b)),
                            consistency=consistency, bound=bound)
    if kind == MEMBERS:
        return QueryRequest(MEMBERS, k=int(k), consistency=consistency,
                            bound=bound)
    if kind == REPRESENTATIVES:
        return QueryRequest(REPRESENTATIVES, k=int(k),
                            consistency=consistency, bound=bound)
    raise ValueError(f"unknown read kind {kind!r}")


class Session:
    """Client handle carrying the read-your-writes generation token."""

    def __init__(self, router: "QueryRouter"):
        self.router = router
        self.token = 0  # highest generation any of this session's writes commits in

    def submit(self, op: int, a: int, b: int) -> WriteAck | Overloaded:
        """Write through the router; advances the RYW token only on a real ack."""
        ack = self.router.submit(op, a, b)
        if isinstance(ack, Overloaded):
            # shed by a pipelined primary's admission control: nothing was
            # acked, so the session's RYW token must not advance
            return ack
        self.token = max(self.token, ack.gen)
        return ack

    def submit_many(self, updates) -> list[WriteAck]:
        """Batch write; the token advances to the last ack's generation."""
        acks = self.router.submit_many(updates)
        if acks:
            self.token = max(self.token, acks[-1].gen)
        return acks

    def query(self, req: QueryRequest) -> QueryResponse:
        """Read at this session's read-your-writes token."""
        return self.router.route(req, token=self.token)


class QueryRouter:
    """Routes reads across the primary and its replicas by consistency policy;
    all writes go to the single primary."""

    def __init__(self, primary: TrussService, replicas=(), *,
                 poll_on_miss: bool = True,
                 lease_timeout_s: float | None = None,
                 retry: RetryPolicy | None = None, clock=time.monotonic):
        self.primary = primary
        self.replicas: list[Replica] = list(replicas)
        self.poll_on_miss = poll_on_miss
        # lease_timeout_s: a replica that has not polled within the window
        # is presumed wedged and evicted from the read rotation (its lease
        # is stale); None disables liveness checks.  ``retry`` drives the
        # replica-read retry ladder — each failed attempt evicts the failing
        # replica and the next attempt picks another; exhaustion (or an
        # empty rotation) falls back to the primary.
        self.lease_timeout_s = lease_timeout_s
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_ms=0.1, cap_ms=5.0, scope="router_read")
        self._clock = clock
        self._rr = 0           # round-robin cursor over qualifying replicas
        self.served: dict[str, int] = {}
        self.evictions: dict[str, str] = {}  # replica_id -> cause

    def _evict(self, replica: Replica, cause: str):
        """Remove one replica from the read rotation (stale lease or a
        failed read).  Eviction is routing-only — the replica object is not
        torn down, and a healthy one can be re-added by appending to
        ``self.replicas``."""
        if replica in self.replicas:
            self.replicas.remove(replica)
        self.evictions[replica.replica_id] = cause
        _EVICTED.labels(cause=cause).inc()
        obs_trace.instant("router.evict", replica=replica.replica_id,
                          cause=cause)

    def _alive(self) -> list[Replica]:
        """Replicas with a fresh lease; stale ones are evicted on sight."""
        if self.lease_timeout_s is None:
            return list(self.replicas)
        now = self._clock()
        for r in list(self.replicas):
            if now - r.last_poll_t > self.lease_timeout_s:
                self._evict(r, "stale_lease")
        return list(self.replicas)

    # -- trace propagation ----------------------------------------------------
    @staticmethod
    def _edge_ctx(header: str | None = None):
        """Trace context for one request at the router edge: adopt the
        caller's traceparent header (as a child hop) when one rode in on
        the request, mint a fresh context otherwise.  ``None`` while obs is
        disabled, so an untraced deployment pays nothing here."""
        if not _OBS_STATE.enabled:
            return None
        if header:
            ctx = obs_trace.TraceContext.from_header(header)
            if ctx is not None:
                return ctx.child()
        return obs_trace.TraceContext.mint()

    # -- writes (single-writer: always the primary) ---------------------------
    def submit(self, op: int, a: int, b: int) -> WriteAck | Overloaded:
        """May return ``Overloaded`` when the primary runs pipelined ingest
        and its bounded pending queue is full — the client retries.  Each
        write is admitted under a router-minted trace context: the primary
        stamps it into the WAL (``# trace`` annotation) so replica applies
        join the trace, and a real ack carries the traceparent header
        back to the client."""
        ctx = self._edge_ctx()
        with obs_trace.TRACER.bind(ctx):
            with obs_trace.span("router.write", op=op):
                ack = self.primary.submit(op, a, b)
        if ctx is not None and isinstance(ack, WriteAck):
            ack = dataclasses.replace(ack, trace=ctx.to_header())
        return ack

    def submit_many(self, updates) -> list[WriteAck]:
        """Batch write to the primary (drains cooperatively when pipelined);
        the whole batch shares one router-minted trace context."""
        ctx = self._edge_ctx()
        with obs_trace.TRACER.bind(ctx):
            with obs_trace.span("router.write_many", n=len(updates)):
                acks = self.primary.submit_many(updates)
        if ctx is not None:
            header = ctx.to_header()
            acks = [dataclasses.replace(a, trace=header) for a in acks]
        return acks

    def session(self) -> Session:
        """Open a read-your-writes session bound to this router."""
        return Session(self)

    # -- replication heartbeat ------------------------------------------------
    def poll_replicas(self):
        """Advance every replica to the primary's committed frontier.  A
        replica whose poll raises (an unreadable committed prefix, a lost
        store mount) is evicted from the rotation rather than failing the
        whole heartbeat — the survivors keep serving."""
        for r in list(self.replicas):
            try:
                r.poll()
            except Exception as exc:
                obs_trace.instant("router.poll_failed",
                                  replica=r.replica_id, err=repr(exc)[:120])
                self._evict(r, "poll_failed")

    # -- reads ----------------------------------------------------------------
    def _pick(self, min_gen: int) -> Replica | None:
        """Round-robin over live replicas at/past ``min_gen``; on a miss,
        poll once (the frontier may simply not have been pulled yet) and
        retry.  None means no replica qualifies — the caller falls back to
        the primary."""
        cand = [r for r in self._alive() if r.gen >= min_gen]
        if not cand and self.replicas and self.poll_on_miss:
            self.poll_replicas()
            cand = [r for r in self._alive() if r.gen >= min_gen]
        if not cand:
            return None
        self._rr += 1
        return cand[self._rr % len(cand)]

    def _serve_replica(self, replica: Replica, req: QueryRequest,
                       min_gen: int) -> QueryResponse | None:
        """Serve one read from the replica tier under the retry policy: a
        failed attempt evicts the failing replica and the next attempt
        round-robins onto another qualifying one.  None means the rotation
        exhausted (every candidate failed or none qualify) and the caller
        must fall back to the primary."""
        node: Replica | None = replica
        for _ in self.retry.attempts():
            if node is None:
                return None
            try:
                resp = node.handle(req)
            except Exception as exc:
                obs_trace.instant("router.read_failed",
                                  replica=node.replica_id,
                                  err=repr(exc)[:120])
                self._evict(node, "read_failed")
                node = self._pick(min_gen)
                continue
            resp.served_by = node.replica_id
            self.served[node.replica_id] = (
                self.served.get(node.replica_id, 0) + 1)
            _ROUTED.labels(consistency=req.consistency,
                           node=node.replica_id).inc()
            return resp
        return None

    def route(self, req: QueryRequest, token: int = 0) -> QueryResponse:
        """Dispatch one read under its consistency policy; the response is
        stamped with the node that served it.  The read runs under a trace
        context — adopted from ``req.trace`` when the client sent one,
        minted here otherwise — so the serving node's ``query`` span joins
        the same trace as the router hop."""
        ctx = self._edge_ctx(req.trace)
        if ctx is None:
            return self._route(req, token)
        if req.trace is None:
            req = dataclasses.replace(req, trace=ctx.to_header())
        with obs_trace.TRACER.bind(ctx):
            with obs_trace.span("router.route", kind=req.kind,
                                consistency=req.consistency):
                return self._route(req, token)

    def _route(self, req: QueryRequest, token: int = 0) -> QueryResponse:
        """Policy dispatch body (see ``route``)."""
        if req.consistency == STRONG:
            node, name = self.primary, "primary"
        else:
            if req.consistency == BOUNDED:
                min_gen = self.primary.gen - int(req.bound)
            elif req.consistency == READ_YOUR_WRITES:
                min_gen = int(token)
            else:
                raise ValueError(f"unknown consistency {req.consistency!r}")
            if min_gen > self.primary.gen:
                # the token is ahead of the committed frontier (the session
                # has acked-but-unflushed writes): no committed-WAL tailer
                # can qualify, so don't even poll — only the primary's
                # flush-first read path can satisfy this read
                picked = None
            else:
                picked = self._pick(min_gen)
            if picked is not None:
                resp = self._serve_replica(picked, req, min_gen)
                if resp is not None:
                    return resp
                # the whole replica rotation failed mid-read: fall back to
                # the primary exactly as if no replica had qualified
            if req.consistency == BOUNDED:
                # primary fallback at lag 0 from the committed generation —
                # bounded semantics never require (or pay for) a flush
                resp = self.primary.handle_committed(req)
                resp.served_by = "primary"
                self.served["primary"] = self.served.get("primary", 0) + 1
                _ROUTED.labels(consistency=req.consistency,
                               node="primary").inc()
                return resp
            node, name = self.primary, "primary"
        resp = node.handle(req)
        resp.served_by = name
        self.served[name] = self.served.get(name, 0) + 1
        _ROUTED.labels(consistency=req.consistency, node=name).inc()
        return resp

    # -- failover -------------------------------------------------------------
    def promote(self, replica: Replica | None = None) -> TrussService:
        """Fail over to a replica (default: the most caught-up one): it
        replays the WAL tail, reopens the store for writes, and becomes this
        router's primary."""
        if replica is None:
            if not self.replicas:
                raise ValueError("no replicas to promote")
            replica = max(self.replicas, key=lambda r: r.wal_applied)
        self.replicas.remove(replica)
        self.primary = replica.promote()
        return self.primary

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        """Primary/replica generations, per-replica lag, and routing
        counters.  ``served`` is this router's own tally; ``routed`` folds
        the process-wide ``truss_router_reads_total`` registry family down
        to per-consistency totals (see docs/OBSERVABILITY.md)."""
        by_policy: dict[str, int] = {}
        fam = obs_metrics.REGISTRY.families().get("truss_router_reads_total")
        if fam is not None:
            for key, child in fam.children().items():
                by_policy[key[0]] = by_policy.get(key[0], 0) + child.value
        return {
            "primary_gen": self.primary.gen,
            "replicas": {r.replica_id:
                         {"gen": r.gen,
                          "lag_gens": self.primary.gen - r.gen}
                         for r in self.replicas},
            "served": dict(self.served),
            "routed": by_policy,
            "evictions": dict(self.evictions),
        }
