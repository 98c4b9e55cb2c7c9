"""Truss service launcher: ``python -m repro_torch.launch.serve_truss`` (port
of ``repro.launch.serve_truss``: the same modes, flags, output and exit
codes, plus ``--device``, default ``cuda``; ``--device cpu`` runs on the
CPU, nothing picks it on its own).

Stands up a ``TrussService`` over a synthetic evolving graph, drives it with
a resumable update stream, answers a query mix every tick, and snapshots the
store on exit.  ``--restore`` resumes service *and* input stream from the
store — the zero-recompute restart the WAL + snapshot design exists for.

    PYTHONPATH=src python -m repro_torch.launch.serve_truss --store STORE \
        --nodes 500 --ticks 8
    PYTHONPATH=src python -m repro_torch.launch.serve_truss --store STORE \
        --restore --ticks 4

``--restore`` recovers from both clean exits and uncommanded kills (it
replays the WAL tail, then fast-forwards the deterministic stream past
whatever the replay already applied, finishing a torn mid-tick batch from
its WAL offset).  The stream-generation flags (``--seed``, ``--degree``,
``--chunk``) must match the original run — they define the stream identity.

Cluster modes (``repro_torch.cluster``):

    # tail an existing store as a read replica (run the primary elsewhere)
    PYTHONPATH=src python -m repro_torch.launch.serve_truss \
        --replica-of STORE --ticks 8

    # primary + N in-process replicas behind the consistency-aware router,
    # driven by the mixed zipfian read/write workload
    PYTHONPATH=src python -m repro_torch.launch.serve_truss --store STORE \
        --router --replicas 2 --consistency bounded --bound 2

Pipelined ingest (``--pipeline``): the primary overlaps host WAL work with
the device re-peel and adapts its generation size toward ``--target-p99``
(milliseconds); ``--max-pending`` bounds the admission queue, and the drive
loop backs off and retries when the service sheds a write with
``Overloaded``:

    PYTHONPATH=src python -m repro_torch.launch.serve_truss --store STORE \
        --router --pipeline --target-p99 50 --max-pending 256

Telemetry (``docs/OBSERVABILITY.md``): ``--metrics-port`` serves the
process registry as a Prometheus text endpoint (``/metrics``; port 0 picks
a free port and prints it), ``--trace-out FILE`` writes the span ring as
Chrome ``trace_event`` JSON on exit (load in ``chrome://tracing``), and
``--profile-dir DIR`` arms ``torch.profiler`` captures around the flush and
decompose regions (one Chrome trace each, ``DIR/<region>-<n>.json``):

    PYTHONPATH=src python -m repro_torch.launch.serve_truss --store STORE \
        --pipeline --metrics-port 9100 --trace-out TRACE.json
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..cluster import QueryRouter, Replica, query_from_record
from ..core.peel import set_wave_profile as _set_wave_profile
from ..data.streams import READ, GraphUpdateStream, MixedWorkloadStream
from ..data.synthetic import powerlaw_graph
from ..faults import FaultyIO, RetryPolicy, seeded_schedule
from ..obs import expo, flightrec, is_enabled, profiling, slo, trace
from ..service import (COMMUNITY, CONSISTENCY_LEVELS, MAX_K, MEMBERS,
                       REPRESENTATIVES, Overloaded, QueryRequest,
                       TrussService, TrussStore)
from ..service.api import Unavailable


def _pipeline_kw(args) -> dict:
    """Pipeline flags and the device -> TrussService kwargs (primary
    constructors only — replicas always tail serially, they never dispatch
    ahead)."""
    return dict(pipeline=args.pipeline, target_p99_ms=args.target_p99,
                max_pending=args.max_pending, device=args.device)


def _make_store(path: str | None, args) -> TrussStore | None:
    """Open the primary's store, optionally under a deterministic chaos
    schedule (``--chaos-seed``): the whole run then exercises the recovery
    ladder — checksummed WAL repair, retries, degraded mode — against
    seeded injected disk faults."""
    if path is None:
        return None
    io = None
    if getattr(args, "chaos_seed", None) is not None:
        faults = seeded_schedule(args.chaos_seed, n_faults=args.chaos_faults,
                                 sticky=getattr(args, "chaos_sticky", False))
        io = FaultyIO(faults)
        print(f"chaos: seed {args.chaos_seed} -> "
              + ", ".join(f"{f.kind}@{f.op}[{f.at}]" for f in faults))
    return TrussStore(path, io=io)


def _submit_retry(sink, op: int, a: int, b: int,
                  policy: RetryPolicy | None = None):
    """Submit through a session/service, absorbing ``Overloaded``
    backpressure under the shared ``RetryPolicy`` (capped decorrelated
    jitter, bounded attempts, wall-clock deadline — no caller can spin
    forever against a degraded primary).  Returns the eventual ``WriteAck``
    (the stream is stateful, so a shed write must be retried, not
    dropped); raises ``RuntimeError`` when the policy exhausts."""
    if policy is None:
        policy = RetryPolicy(max_attempts=64, base_ms=1.0, cap_ms=100.0,
                             deadline_s=30.0, scope="submit")
    ack = None
    for _ in policy.attempts():
        ack = sink.submit(op, a, b)
        if not isinstance(ack, Overloaded):
            return ack
    raise RuntimeError(
        f"write ({op},{a},{b}) still shed after {policy.max_attempts} "
        f"attempts (last reason: {ack.reason})")


def _health_callback(slo_engine: slo.SLOEngine, cell: dict):
    """Build the ``/healthz`` callback: the SLO engine's verdict, overlaid
    with the primary's live degradation state — a breaker-open/quarantined
    service reports ``violated`` immediately instead of waiting for the
    burn-rate windows to catch up."""
    def _health():
        """One health probe (``MetricsServer`` calls this per request)."""
        h = slo_engine.health()
        svc = cell.get("svc")
        if svc is not None and svc._degraded_reason is not None:
            h = {**h, "status": "violated",
                 "degraded": svc._degraded_reason}
        return h
    return _health


def _wire_operability(svc: TrussService | None, slo_engine: slo.SLOEngine,
                      cell: dict):
    """Attach the SLO engine to the serving primary and register the
    flight recorder's postmortem bundle providers: commit frontier, engine
    config, store scrub report, SLO state, and the chaos schedule when a
    seeded ``FaultyIO`` is driving the store."""
    if svc is None:
        return
    cell["svc"] = svc
    svc.attach_slo(slo_engine)
    store = svc.store

    def _frontier():
        """Committed frontier at dump time."""
        return {"gen": svc.gen, "wal_applied": svc._applied_wal,
                "wal_len": store.wal_len if store is not None else 0}

    def _config():
        """Engine configuration at dump time."""
        return {"n_nodes": svc.graph.spec.n_nodes,
                "flush_every": svc.flush_every, "pipeline": svc.pipeline,
                "indexed": svc.indexed, "strategy": svc.strategy,
                "tracked_ks": [int(k) for k in svc.graph.index.tracked]}

    def _scrub():
        """Durability scrub (store-level only — the engine-level scrub
        would recursively trip the recorder on a violation)."""
        return store.scrub() if store is not None else None

    def _chaos():
        """Remaining + already-injected faults of a seeded ``FaultyIO``."""
        io = getattr(store, "_io", None) if store is not None else None
        if io is None or not isinstance(io, FaultyIO):
            return None
        return {"injected": dict(io.injected),
                "pending": [f"{f.kind}@{f.op}[{f.at}]" for f in io.faults]}

    flightrec.FLIGHT.configure(frontier=_frontier, config=_config,
                               scrub=_scrub, slo=slo_engine.state_dict,
                               chaos_schedule=_chaos)


def _primary_of(obj) -> TrussService | None:
    """The ``TrussService`` behind whatever ``main`` returned (router →
    its primary, replica → its inner service, single node → itself)."""
    if isinstance(obj, QueryRouter):
        return obj.primary
    if isinstance(obj, Replica):
        return obj.svc
    return obj


def _exit_code(obj, scrub: bool) -> int:
    """Map the end-of-run state to a process exit code so supervisors and
    CI can tell outcomes apart: 0 healthy, 3 the primary ended degraded
    (breaker open / writes shed), 4 the ``--scrub`` audit found integrity
    violations."""
    svc = _primary_of(obj)
    if svc is None:
        return 0
    if scrub:
        report = svc.scrub()
        print(f"scrub: ok={report['ok']} "
              f"violations={report['violations'] or 'none'}")
        if not report["ok"]:
            return 4
    s = svc.stats()
    if s["degraded"] is not None or s["breaker"]["state"] != "closed":
        print(f"exit: degraded ({s['degraded']}, "
              f"breaker {s['breaker']['state']})")
        return 3
    return 0


def _query_mix(svc: TrussService, ks, rng) -> list[QueryRequest]:
    """A realistic per-tick mix: hot membership reads plus point lookups."""
    reqs = [QueryRequest(MEMBERS, k=int(k)) for k in ks]
    reqs += [QueryRequest(REPRESENTATIVES, k=int(ks[0]))]
    el = svc.graph.edge_list()
    if len(el):
        e = el[rng.integers(len(el))]
        reqs += [QueryRequest(MAX_K, edge=(int(e[0]), int(e[1]))),
                 QueryRequest(COMMUNITY, k=int(ks[0]), node=int(e[0]))]
    return reqs


def _run_replica(args, ks, rng, slo_engine, cell):
    """Tail a store as a read replica: poll, answer the query mix, report
    lag; the primary (or a static store) lives elsewhere."""
    rep = Replica(args.replica_of, replica_id=f"replica-{os.getpid()}",
                  indexed=not args.no_index, device=args.device)
    _wire_operability(rep.svc, slo_engine, cell)
    for tick in range(args.ticks):
        gen = rep.poll()
        answered = []
        for req in _query_mix(rep.svc, ks, rng):
            resp = rep.handle(req)
            answered.append((req.kind, resp.value if resp.value is not None
                             else resp.n_edges))
        s = rep.stats()
        print(f"tick {tick}: applied gen {gen} "
              f"(lag {s.get('lag_gens', '?')} gens / "
              f"{s.get('lag_records', '?')} records); " +
              " ".join(f"{k}={v}" for k, v in answered))
        time.sleep(args.poll_interval)
    print(f"final: {rep.stats()}")
    return rep


def _run_router(args, ks, rng, slo_engine, cell):
    """Primary + N in-process replicas behind the consistency-aware router,
    driven by the mixed zipfian read/write workload."""
    if not args.store:
        raise SystemExit("--router requires --store")
    if args.restore:
        primary = TrussService.restore(_make_store(args.store, args),
                                       flush_every=args.flush_every,
                                       indexed=not args.no_index,
                                       **_pipeline_kw(args))
        # the node universe comes from the restored spec, not the CLI args
        # (same discipline as the single-node restore path)
        n_nodes = primary.graph.spec.n_nodes
        edges = powerlaw_graph(n_nodes, args.degree, seed=args.seed)
    else:
        n_nodes = args.nodes
        edges = powerlaw_graph(n_nodes, args.degree, seed=args.seed)
        primary = TrussService(n_nodes, edges, tracked_ks=ks,
                               flush_every=args.flush_every,
                               store=_make_store(args.store, args),
                               indexed=not args.no_index,
                               **_pipeline_kw(args))
    _wire_operability(primary, slo_engine, cell)
    replicas = [Replica(args.store, f"replica-{i}",
                        indexed=not args.no_index, device=args.device)
                for i in range(args.replicas)]
    router = QueryRouter(primary, replicas)
    wl = MixedWorkloadStream(edges, n_nodes, chunk=args.chunk,
                             read_frac=args.read_frac, ks=ks,
                             seed=args.seed + 1)
    # Resume the workload where the snapshot left it.  A crash may have
    # acked writes past the snapshot (the replayed WAL tail); restore
    # counts exactly the records replay re-derived past the snapshot's
    # high-water mark — the deterministic stream regenerates them, and we
    # skip them (their reads re-run harmlessly) instead of re-submitting
    # already-present edges.  (``wal_len - base`` is NOT that count:
    # compaction retains the previous snapshot's tail for replica
    # catch-up, so it over-skips after the second snapshot.)
    skip_writes = 0
    if args.restore:
        if primary.stream_state is not None:
            wl.load_state_dict(primary.stream_state)
        skip_writes = primary.replayed_records
        print(f"restored: {primary.stats()} "
              f"(skipping {skip_writes} replayed writes)")
    sess = router.session()
    lat: list[float] = []
    for tick in range(args.ticks):
        n_w = n_r = 0
        for rec in wl.next():
            if rec[0] != READ and skip_writes > 0:
                skip_writes -= 1
                continue
            if rec[0] == READ:
                req = query_from_record(rec, consistency=args.consistency,
                                        bound=args.bound)
                t0 = time.perf_counter()
                sess.query(req)
                lat.append(time.perf_counter() - t0)
                n_r += 1
            else:
                _submit_retry(sess, rec[1], rec[2], rec[3])
                n_w += 1
        router.poll_replicas()  # replication heartbeat, once per tick
        print(f"tick {tick}: +{n_w} writes, {n_r} reads -> {router.stats()}")
    if lat:
        ms = np.asarray(sorted(lat)) * 1e3
        print(f"\n{len(lat)} {args.consistency} reads: "
              f"p50={np.percentile(ms, 50):.2f}ms "
              f"p99={np.percentile(ms, 99):.2f}ms")
    primary.snapshot(stream_state=wl.state_dict())
    print(f"final: {primary.stats()}")
    return router


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=500)
    ap.add_argument("--degree", type=int, default=6)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=8,
                    help="updates ingested per tick")
    ap.add_argument("--flush-every", type=int, default=16,
                    help="write-batch size (generation boundary)")
    ap.add_argument("--ks", default="3,4", help="tracked k-truss levels")
    ap.add_argument("--store", default=None, help="WAL+snapshot directory")
    ap.add_argument("--restore", action="store_true",
                    help="resume service + stream from --store")
    ap.add_argument("--no-index", action="store_true",
                    help="recompute-per-query baseline mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replica-of", default=None, metavar="STORE",
                    help="tail STORE as a read replica instead of serving writes")
    ap.add_argument("--poll-interval", type=float, default=0.2,
                    help="replica mode: seconds between WAL polls")
    ap.add_argument("--router", action="store_true",
                    help="primary + --replicas read replicas behind the "
                         "consistency-aware query router")
    ap.add_argument("--replicas", type=int, default=2,
                    help="router mode: number of read replicas")
    ap.add_argument("--read-frac", type=float, default=0.9,
                    help="router mode: read fraction of the mixed workload")
    ap.add_argument("--consistency", default="bounded",
                    choices=CONSISTENCY_LEVELS,
                    help="router mode: read consistency policy")
    ap.add_argument("--bound", type=int, default=2,
                    help="router mode: staleness bound in generations")
    ap.add_argument("--pipeline", action="store_true",
                    help="overlap host WAL work with the device re-peel "
                         "(double-buffered generations)")
    ap.add_argument("--target-p99", type=float, default=None,
                    help="pipeline mode: adapt the generation size toward "
                         "this per-generation commit latency (ms)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="pipeline mode: bound on the acked-but-unapplied "
                         "queue before writes are shed with Overloaded")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the metrics registry as a Prometheus text "
                         "endpoint on this port (0 = pick a free port)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the span ring as Chrome trace_event JSON "
                         "on exit (chrome://tracing / Perfetto)")
    ap.add_argument("--trace-jsonl", default=None, metavar="FILE",
                    help="stream spans to FILE as JSONL with a clock-sync "
                         "header — merge per-process files with "
                         "python -m repro_torch.obs.merge")
    ap.add_argument("--postmortem-dir", default=None, metavar="DIR",
                    help="arm the flight recorder: dump a self-contained "
                         "postmortem bundle under DIR when the degradation "
                         "ladder fires (breaker open, quarantine, scrub or "
                         "SLO violation)")
    ap.add_argument("--wave-profile", action="store_true",
                    help="per-wave peel timing: host-stepped waves feed the "
                         "truss_peel_wave_seconds histogram (adds one "
                         "device sync per wave — measurement mode)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="arm torch.profiler captures around the flush and "
                         "decompose regions; traces land under DIR")
    ap.add_argument("--chaos-seed", type=int, default=None, metavar="SEED",
                    help="inject a deterministic fault schedule into the "
                         "primary's store I/O (repro_torch.faults) — the run "
                         "exercises the recovery ladder end to end")
    ap.add_argument("--chaos-faults", type=int, default=3,
                    help="number of faults in the --chaos-seed schedule")
    ap.add_argument("--chaos-sticky", action="store_true",
                    help="make the --chaos-seed faults persistent outages "
                         "(keep firing once reached) — drives the breaker "
                         "open and, with --postmortem-dir, dumps a bundle")
    ap.add_argument("--scrub", action="store_true",
                    help="run the end-to-end integrity scrub (WAL checksums, "
                         "snapshot digests, phi invariants) after the drive "
                         "loop; violations exit 4")
    ap.add_argument("--linger", type=float, default=0.0, metavar="SECONDS",
                    help="keep the process (and with --metrics-port the "
                         "/metrics + /healthz server) alive this long after "
                         "the drive loop — lets probes observe the final "
                         "serving state before exit")
    ap.add_argument("--device", default="cuda",
                    help="where the graph state and every peel live")
    args = ap.parse_args(argv)

    ks = tuple(int(k) for k in args.ks.split(","))
    rng = np.random.default_rng(args.seed)

    slo_engine = slo.SLOEngine()
    cell: dict = {"svc": None}  # _wire_operability fills in the primary
    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = expo.MetricsServer(
            port=args.metrics_port, health=_health_callback(slo_engine, cell))
        metrics_server.start()
        print(f"metrics: http://127.0.0.1:{metrics_server.port}/metrics")
    if args.profile_dir is not None:
        profiling.configure(args.profile_dir)
    if args.postmortem_dir is not None:
        flightrec.FLIGHT.configure(args.postmortem_dir)
    if args.wave_profile:
        _set_wave_profile(True)
    writer = None
    if args.trace_jsonl is not None:
        proc = ("replica" if args.replica_of else
                "router" if args.router else "primary")
        writer = trace.TraceWriter(args.trace_jsonl, proc=proc)
    try:
        obj = _dispatch(args, ks, rng, slo_engine, cell)
        # stashed for the __main__ wrapper; callers that import main() keep
        # getting the service/router/replica object back unchanged
        obj.exit_code = _exit_code(obj, scrub=args.scrub)
        if args.linger > 0:
            print(f"linger: holding final state for {args.linger}s")
            time.sleep(args.linger)
        return obj
    finally:
        if args.trace_out is not None:
            trace.write_chrome(args.trace_out)
            print(f"trace -> {args.trace_out} "
                  f"({len(trace.TRACER.events())} spans)")
        if writer is not None:
            writer.close()
            print(f"trace jsonl -> {args.trace_jsonl}")
        if flightrec.FLIGHT.dumps:
            print(f"postmortem: {len(flightrec.FLIGHT.dumps)} bundle(s) -> "
                  f"{args.postmortem_dir}")
        if metrics_server is not None:
            metrics_server.stop()
        profiling.configure(None)
        _set_wave_profile(False)


def _dispatch(args, ks, rng, slo_engine, cell):
    """Run the selected serving mode (split from ``main`` so the telemetry
    plumbing wraps every mode uniformly)."""
    if args.replica_of:
        return _run_replica(args, ks, rng, slo_engine, cell)
    if args.router:
        return _run_router(args, ks, rng, slo_engine, cell)

    if args.restore:
        if not args.store:
            raise SystemExit("--restore requires --store")
        svc = TrussService.restore(_make_store(args.store, args),
                                   flush_every=args.flush_every,
                                   indexed=not args.no_index,
                                   **_pipeline_kw(args))
        # the node universe comes from the restored spec, not the CLI args —
        # a mismatched --nodes must not generate out-of-range updates
        n_nodes = svc.graph.spec.n_nodes
        edges = powerlaw_graph(n_nodes, args.degree, seed=args.seed)
        stream = GraphUpdateStream(edges, n_nodes, chunk=args.chunk,
                                   seed=args.seed + 1)
        if svc.stream_state is not None:
            stream.load_state_dict(svc.stream_state)
        # After an uncommanded crash the WAL holds writes past the last
        # snapshot's stream state (possibly from a torn mid-tick batch).
        # Every WAL record came from this stream, one chunk per tick, so
        # fast-forward whole chunks the replay already applied, then finish
        # a partially-submitted tick from its WAL offset.
        done = svc.store.wal_len
        while (stream.step + 1) * stream.chunk <= done:
            stream.next()
        rem = done - stream.step * stream.chunk
        if rem > 0:
            partial = stream.next()
            svc.submit_many([tuple(map(int, r)) for r in partial[rem:]])
        print(f"restored: {svc.stats()}")
    else:
        edges = powerlaw_graph(args.nodes, args.degree, seed=args.seed)
        store = _make_store(args.store, args)
        svc = TrussService(args.nodes, edges, tracked_ks=ks,
                           flush_every=args.flush_every, store=store,
                           indexed=not args.no_index, **_pipeline_kw(args))
        stream = GraphUpdateStream(edges, args.nodes, chunk=args.chunk,
                                   seed=args.seed + 1)
    _wire_operability(svc, slo_engine, cell)

    lat: list[float] = []
    shed_ticks = 0
    for tick in range(args.ticks):
        # one trace context per tick at the CLI edge: the tick's writes
        # annotate their generations in the WAL and its spans share one
        # trace id (repro_torch.obs.merge joins replica applies on it)
        ctx = trace.TraceContext.mint() if is_enabled() else None
        with trace.TRACER.bind(ctx):
            ups = stream.next()
            try:
                svc.submit_many([tuple(map(int, r)) for r in ups])
            except (Unavailable, OSError) as exc:
                # degraded mode is a serving state, not a crash: the tick's
                # writes are shed (nothing acked), committed reads keep
                # serving, and a later tick may ride a half-open recovery
                shed_ticks += 1
                print(f"tick {tick}: writes shed ({exc!r})")
                continue
            answered = []
            for req in _query_mix(svc, ks, rng):
                t0 = time.perf_counter()
                resp = svc.handle(req)
                lat.append(time.perf_counter() - t0)
                answered.append((req.kind,
                                 resp.value if resp.value is not None
                                 else resp.n_edges))
        print(f"tick {tick}: +{len(ups)} writes -> gen {svc.gen}; " +
              " ".join(f"{k}={v}" for k, v in answered))
    if shed_ticks:
        print(f"degraded: {shed_ticks}/{args.ticks} ticks shed")

    if lat:
        ms = np.asarray(sorted(lat)) * 1e3
        print(f"\n{len(lat)} queries: p50={np.percentile(ms, 50):.2f}ms "
              f"p99={np.percentile(ms, 99):.2f}ms")
    if svc.store is not None:
        try:
            path = svc.snapshot(stream_state=stream.state_dict())
            print(f"snapshot -> {path} (wal_len={svc.store.wal_len})")
        except (Unavailable, OSError) as exc:
            # a chaos fault landing on the shutdown snapshot is survivable:
            # the WAL holds everything, the next restore replays it
            print(f"snapshot failed ({exc!r}) — WAL remains authoritative")
    print(f"final: {svc.stats()}")
    return svc


if __name__ == "__main__":
    raise SystemExit(getattr(main(), "exit_code", 0))
