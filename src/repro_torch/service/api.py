"""Request/response types for the truss query service.

The service multiplexes four query kinds (paper §5's index queries) against
one maintained ``TrussIndex``; every response carries the generation it was
answered at, making the consistency model explicit: reads happen at
generation boundaries, after the service's own pending writes flushed
(read-your-writes).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# query kinds
MEMBERS = "members"                  # all edges of the k-truss
COMMUNITY = "community"              # k-truss component of a node or edge
MAX_K = "max_k"                      # phi(e): largest k with e in a k-truss
REPRESENTATIVES = "representatives"  # one edge per k-truss component

QUERY_KINDS = (MEMBERS, COMMUNITY, MAX_K, REPRESENTATIVES)

# consistency policies (honored by the cluster QueryRouter; a single-node
# service always serves STRONG semantics — every query flushes first)
STRONG = "strong"                    # primary only: freshest committed state
BOUNDED = "bounded"                  # any node within `bound` generations
READ_YOUR_WRITES = "read_your_writes"  # nodes at/past the session's gen token

CONSISTENCY_LEVELS = (STRONG, BOUNDED, READ_YOUR_WRITES)


@dataclasses.dataclass(frozen=True)
class WriteRequest:
    """One edge update; ``op`` follows ``data.streams`` (1=insert, 0=delete)."""
    op: int
    a: int
    b: int


@dataclasses.dataclass(frozen=True)
class WriteAck:
    """Write is WAL-appended (durable against process crash; fsynced to
    disk at the next generation flush or snapshot) and will commit in
    generation ``gen``; ``wal_index`` is its position in the log.
    ``trace`` is the traceparent header (``00-<trace_id>-<span_id>-01``) of
    the distributed trace the write was admitted under, when one was bound
    at the serving edge — clients propagate it to correlate their retries
    and follow-up reads with the server-side spans."""
    gen: int
    wal_index: int
    trace: str | None = None


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Admission-control rejection: the write was **not** acked — nothing
    hit the WAL, the logical view is unchanged, and the client should
    retry after roughly ``retry_after_ms``.  ``gen`` is the committed
    generation at rejection time, so a retrying client can tell whether
    the service is making progress.  ``reason`` says why the write was
    shed:

    * ``"overload"`` — pipelined admission control: the bounded pending
      queue is full and the device is still busy (retry hint is the EWMA
      per-generation commit latency);
    * ``"degraded"`` — the service's circuit breaker is open after a peel
      failure or invariant violation: committed reads keep serving, writes
      shed until the half-open retry succeeds;
    * ``"io"`` — the durability path is failing (fsync/append errors
      exhausted the retry policy): nothing can be acked until the disk
      recovers."""
    retry_after_ms: float
    gen: int
    reason: str = "overload"


class Unavailable(RuntimeError):
    """Raised by bulk entry points (``submit_many``) when the service is in
    degraded mode — a batch cannot be partially acked, so it is refused as
    a unit (per-record ``submit`` returns ``Overloaded`` instead)."""


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """A read: kind + parameters + the consistency policy to route it under."""
    kind: str
    k: int = 3
    node: int | None = None                  # COMMUNITY seed (node form)
    edge: tuple[int, int] | None = None      # COMMUNITY seed / MAX_K target
    consistency: str = STRONG                # routing policy (cluster only)
    bound: int = 0                           # max staleness gens (BOUNDED)
    trace: str | None = None                 # traceparent header, if traced

    def __post_init__(self):
        if self.kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {self.kind!r}")
        if self.kind == COMMUNITY and self.node is None and self.edge is None:
            raise ValueError("community query needs a node or an edge")
        if self.kind == MAX_K and self.edge is None:
            raise ValueError("max_k query needs an edge")
        if self.consistency not in CONSISTENCY_LEVELS:
            raise ValueError(f"unknown consistency {self.consistency!r}")
        if self.bound < 0:
            raise ValueError("bound must be >= 0")


@dataclasses.dataclass
class QueryResponse:
    """Answer to a ``QueryRequest``, stamped with the generation it is consistent at."""
    request: QueryRequest
    gen: int                         # generation the answer is consistent at
    edges: np.ndarray | None = None  # [m, 2] for edge-set answers
    value: int | None = None         # MAX_K answer
    served_by: str | None = None     # stamped by the QueryRouter

    @property
    def n_edges(self) -> int:
        """Number of edges in an edge-set answer (0 for scalar answers)."""
        return 0 if self.edges is None else len(self.edges)
