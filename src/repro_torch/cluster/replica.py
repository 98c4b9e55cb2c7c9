"""Read replica: snapshot bootstrap + committed-WAL tailing (PyTorch port
of ``repro.cluster.replica``).

Physical replication over the ``TrussStore`` directory: a replica opens the
primary's store read-only, installs the latest snapshot (``load_snapshot``
+ ``DynamicGraph.from_state`` — phi is trusted as-is, no re-decomposition),
then tails the shared WAL and applies netted generations through the same
fused ``apply_batch`` / delta-peel path the primary runs.  Because

* the snapshot arrays are the primary's arrays bit for bit,
* ``commit.json`` guarantees the tail below the published frontier holds
  only *complete* generation groups, and
* ``apply_batch`` is a deterministic function of (state, netted batch),

the replica's ``GraphState`` — phi included — is **bitwise-equal** to the
primary's at every generation boundary it reaches (checked against both the
primary and the pure-Python oracle in ``tests/test_torch_cluster.py``).

Pipelined primaries (``pipeline=True``) make the WAL tail run *ahead* of
``commit.json`` by the in-flight + queued generations; replicas are immune
by construction — ``poll()`` never reads past the published frontier, so
the acked-but-uncommitted tail is invisible until the primary lands it
(and ``promote()`` deliberately replays it: acked writes survive failover).

A replica holds no durable state of its own (its lease file is advisory),
so crash recovery is simply: construct a fresh ``Replica`` and ``poll()``.
When the primary compacts the WAL past the replica's applied frontier, the
missing records are by construction covered by a newer snapshot — the
replica reinstalls it and resumes tailing (snapshot-install path).

``promote()`` is the failover path: reopen the store writable, replay the
acked-but-uncommitted WAL tail past the applied frontier (acked writes must
survive failover, exactly like ``TrussService.restore``), and hand back a
serving primary.

``device`` (default ``"cuda"``) is where the replica's state lives and
its tail applies run: the snapshot install, every reinstall after a
compaction and the promotion's rebuild all go there.  A replica on the
card runs the primary's kernels (``support_method="bitmap"``: K1 on every
fused apply); nothing here falls back to the CPU.
"""
from __future__ import annotations

import time

from ..obs import metrics as obs_metrics, trace as obs_trace
from ..service.api import QueryRequest, QueryResponse
from ..service.engine import TrussService
from ..service.store import TrussStore, WalCorruptionError

_LAG_GENS = obs_metrics.gauge(
    "truss_replica_lag_gens",
    "generations behind the primary's committed frontier, per tailer",
    labels=("replica",))
_LAG_RECS = obs_metrics.gauge(
    "truss_replica_lag_records",
    "WAL records behind the committed frontier, per tailer",
    labels=("replica",))
_POLL_GROUPS = obs_metrics.counter(
    "truss_replica_poll_groups_total",
    "generation groups applied by WAL tailing", labels=("replica",))
_SNAP_INSTALLS = obs_metrics.counter(
    "truss_replica_snapshot_installs_total",
    "snapshot (re)installs (bootstrap + compaction catch-up)",
    labels=("replica",))


class Replica:
    """One read-only serving node tailing a primary's store directory."""

    def __init__(self, root: str, replica_id: str = "replica-0", *,
                 flush_every: int = 16, strategy: str = "auto",
                 indexed: bool = True, support_method: str = "sorted",
                 mesh=None, partition: str = "replicated",
                 heartbeat_s: float | None = None,
                 clock=time.monotonic, device="cuda"):
        self.store = TrussStore(root, readonly=True)
        self.replica_id = replica_id
        # strategy/support_method must match the primary's for bitwise
        # equality (they select the maintenance path apply_batch runs);
        # mesh — and the bitmap partition over it — need NOT match: the
        # sharded peel is bitwise equal at any shard count and either
        # partition, so a replica may tail a node-partitioned sharded
        # primary from one replicated device and vice versa; nor need
        # device: the engine's arithmetic is integer, so its state is the
        # same on the CPU and on the card
        self._kw = dict(flush_every=flush_every, strategy=strategy,
                        indexed=indexed, support_method=support_method,
                        mesh=mesh, partition=partition, device=device)
        # heartbeat_s: refresh the lease file even on a quiet WAL so the
        # router's stale-lease eviction can tell "caught up and idle" from
        # "wedged"; None keeps the old frontier-change-only writes
        self.heartbeat_s = heartbeat_s
        self._clock = clock
        self.last_poll_t = clock()
        self.svc: TrussService | None = None
        self._install_snapshot()
        self._publish()

    # -- state ---------------------------------------------------------------
    @property
    def gen(self) -> int:
        """Last generation boundary this replica has applied."""
        return self.svc.gen

    @property
    def wal_applied(self) -> int:
        """Global WAL index of the replica's applied frontier."""
        return self.svc._applied_wal

    def _install_snapshot(self):
        tree = self.store.load_snapshot()
        if tree is None:
            raise ValueError(
                f"no snapshot in {self.store.root} — primary not initialized")
        with obs_trace.span("replica.install", replica=self.replica_id,
                            gen=int(tree["gen"])):
            # store=None: the inner service must never append/fsync/snapshot
            self.svc = TrussService._from_snapshot_tree(tree, store=None,
                                                        **self._kw)
        _SNAP_INSTALLS.labels(replica=self.replica_id).inc()

    def _publish(self):
        """Refresh the lease file, skipping the write when the applied
        frontier has not moved (polls on a quiet WAL stay read-only) —
        unless ``heartbeat_s`` has elapsed since the last write, in which
        case the lease is re-stamped anyway so liveness and staleness stay
        distinguishable."""
        frontier = (self.gen, self.wal_applied)
        now = self._clock()
        if (getattr(self, "_published", None) == frontier
                and (self.heartbeat_s is None
                     or now - self._published_t < self.heartbeat_s)):
            return
        self.store.publish_replica(self.replica_id, {
            "gen": self.gen, "wal_applied": self.wal_applied, "ts": now})
        self._published = frontier
        self._published_t = now

    # -- replication ---------------------------------------------------------
    def poll(self, max_gens: int | None = None) -> int:
        """Apply WAL records up to the primary's committed frontier, one
        ``apply_batch`` per generation group (the identical batch boundaries
        the primary flushed at).  O(new records) per call thanks to the
        store's tail cache.  ``max_gens`` caps how many generation groups
        are applied this call (used by the crash tests to park the replica
        mid-tail); the applied frontier only ever advances at group
        boundaries, so a partial poll is always resumable.  Returns the
        applied generation.

        A checksum failure in the committed prefix is **loud**: records the
        primary promised complete (below ``commit.json``'s frontier) that
        cannot be read back mean this replica can never reach the frontier
        honestly, so ``WalCorruptionError`` propagates instead of silently
        serving a diverged state.  Corruption *above* the frontier is
        invisible here by construction — ``poll`` never reads past it."""
        self.last_poll_t = self._clock()
        commit = self.store.read_commit()
        if commit is None or (max_gens is not None and max_gens <= 0):
            self._publish()          # primary has not committed anything yet
            return self.gen
        high = int(commit["wal_len"])
        if high > self.wal_applied:
            with obs_trace.span("replica.poll", replica=self.replica_id,
                                start=self.wal_applied, stop=high):
                # stop at the committed frontier: complete groups only, and
                # the store's tail cache parks there so the next poll is
                # O(new)
                tail = self.store.read_wal(start=self.wal_applied, stop=high)
                if self.store.base > self.wal_applied:
                    # the primary compacted past us: records [applied, base)
                    # are gone but covered by a newer snapshot — reinstall,
                    # re-tail
                    self._install_snapshot()
                    tail = self.store.read_wal(start=self.wal_applied,
                                               stop=high)
                if len(tail) < high - self.wal_applied:
                    raise WalCorruptionError(
                        f"replica {self.replica_id}: committed prefix "
                        f"unreadable — wanted records "
                        f"[{self.wal_applied}, {high}), got {len(tail)} "
                        f"(first bad record near index "
                        f"{self.wal_applied + len(tail)})")
                groups = self.svc._replay(
                    tail, max_groups=max_gens,
                    annotations=self.store.read_trace_annotations())
                _POLL_GROUPS.labels(replica=self.replica_id).inc(groups)
        _LAG_GENS.labels(replica=self.replica_id).set(
            int(commit["gen"]) - self.gen)
        _LAG_RECS.labels(replica=self.replica_id).set(
            int(commit["wal_len"]) - self.wal_applied)
        self._publish()
        return self.gen

    # -- serving -------------------------------------------------------------
    def handle(self, req: QueryRequest) -> QueryResponse:
        """Answer a query at this replica's applied generation.  The inner
        service has no pending writes, so its flush-first discipline
        no-ops and the response generation is the replica's applied gen."""
        return self.svc.handle(req)

    def stats(self) -> dict:
        """Service stats extended with replica id, applied frontier and lag."""
        out = self.svc.stats()
        out["replica_id"] = self.replica_id
        out["wal_applied"] = self.wal_applied
        commit = self.store.read_commit()
        if commit is not None:
            out["lag_gens"] = int(commit["gen"]) - self.gen
            out["lag_records"] = int(commit["wal_len"]) - self.wal_applied
        return out

    # -- failover ------------------------------------------------------------
    def promote(self) -> TrussService:
        """Turn this replica into the primary: reopen the store writable
        (torn-tail truncation + append handle), replay *everything* past the
        applied frontier — committed or not, acked writes survive failover —
        and publish the new committed frontier.  The replica object is
        decommissioned (``svc`` handed over); callers keep the returned
        ``TrussService``."""
        self.store.close()
        store = TrussStore(self.store.root)
        if store.base > self.wal_applied:
            # never polled past a compaction: bootstrap from the snapshot
            # that covers the compacted prefix before replaying the tail
            tree = store.load_snapshot()
            self.svc = TrussService._from_snapshot_tree(tree, store=None,
                                                        **self._kw)
        svc = self.svc
        svc._replay(store.read_wal(start=self.wal_applied),
                    annotations=store.read_trace_annotations())
        svc.store = store
        store.publish_commit(svc.gen, svc._applied_wal)
        store.remove_replica(self.replica_id)  # no longer a tailer
        self.svc = None
        return svc
