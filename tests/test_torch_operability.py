"""The port's operability plane on the CPU: twins of
``tests/test_operability.py`` and of ``tests/test_obs.py``'s exposition
cases, plus the ``torch.profiler`` twin of ``obs.profiling``.

* **SLOs** (``obs/slo.py``): burn rates over registry snapshots under an
  injected clock walk ok -> burning -> violated, recovery is hysteretic;
  gauge and availability objectives; the rate limit and ``stats()["slo"]``.
* **Flight recorder**: a clean run dumps nothing; a sticky seeded fault
  schedule opens the breaker and dumps a bundle of recorded facts; the
  dump cap; a trip without a directory only counts.
* **Trace merge** (``obs/merge.py``): clocks rebased, pids separated; a
  router -> pipelined primary -> replica round trip across two processes
  merges into one trace id spanning both; WAL trace annotations.
* **Wave profiler** (``core/peel.py``): phi equal to the fused engines and
  to ``repro``'s profiled peel, one histogram observation a wave.
* **Exposition** (``obs/expo.py``): render/parse round trip, a live
  ``/metrics`` scrape and ``/healthz``.
* **Profiler twin** (``obs/profiling.py``): armed, one Chrome trace per
  region; reentrance and ``max_traces``; a profiler that fails to start
  raises (ROADMAP R5); the lost-record check on a hand-built trace.
"""
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.core import oracle
from repro.core.graph import (GraphSpec as JSpec,
                              from_edge_list as j_from_edge_list)
from repro.core.peel import (peel as j_peel,
                             set_wave_profile as j_set_wave_profile)
from repro_torch.cluster import QueryRouter
from repro_torch.core import OP_INSERT, DynamicGraph
from repro_torch.core.graph import GraphSpec, from_edge_list
from repro_torch.core.peel import (peel as run_peel, set_wave_profile,
                                   stats_dict, wave_profile_enabled)
from repro_torch.faults import FaultyIO, seeded_schedule
from repro_torch.obs import expo, flightrec, merge, metrics, profiling
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import Registry
from repro_torch.obs.slo import BURNING, OK, VIOLATED, Objective, SLOEngine
from repro_torch.service import MEMBERS, QueryRequest, TrussService, TrussStore
from repro_torch.service.api import Unavailable

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
N = 13
D_MAX = 16
E_CAP = 160


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _svc(edges, tmpdir=None, **kw):
    kw.setdefault("tracked_ks", (3, 4))
    kw.setdefault("flush_every", 5)
    store = TrussStore(str(tmpdir)) if tmpdir is not None else None
    return TrussService(N, edges, d_max=D_MAX, e_cap=E_CAP, store=store,
                        device="cpu", **kw)


def _random_graph(rng, p, n=N):
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


# -- SLO burn-rate state machine ---------------------------------------------

def _slo_fixture():
    """A private registry + latency objective + engine on a fake clock."""
    reg = metrics.Registry()
    hist = reg.histogram("truss_query_seconds", buckets=(0.01, 0.05, 0.1))
    obj = Objective("q-p99", "latency", "truss_query_seconds", target=0.99,
                    threshold=0.05, fast_s=10.0, slow_s=50.0,
                    burn_threshold=2.0, violate_after_s=30.0, clear_s=20.0)
    clock = {"t": 0.0}
    eng = SLOEngine([obj], registry=reg, clock=lambda: clock["t"],
                    min_interval_s=0.0)
    return reg, hist, obj, clock, eng


def test_slo_ok_under_budget():
    _, hist, _, clock, eng = _slo_fixture()
    for t in range(0, 60, 5):
        clock["t"] = float(t)
        for _ in range(100):
            hist.observe(0.001)          # all under the 50ms threshold
        state = eng.evaluate(force=True)
    assert state["overall"] == OK
    assert state["objectives"]["q-p99"]["burn_fast"] == 0.0


def test_slo_burning_violated_and_hysteretic_recovery():
    _, hist, _, clock, eng = _slo_fixture()
    # error storm: every observation blows the 50ms threshold -> burn
    # rate = (1.0 error rate)/(0.01 budget) = 100x in both windows
    for t in range(0, 30, 5):
        clock["t"] = float(t)
        hist.observe(1.0)
        eng.evaluate(force=True)
        assert eng._state["q-p99"] == BURNING, t
    # sustained past violate_after_s=30 -> violated
    clock["t"] = 31.0
    hist.observe(1.0)
    eng.evaluate(force=True)
    assert eng.overall() == VIOLATED
    assert eng.health()["status"] == VIOLATED
    # recovery: fast window (10s) goes clean but the slow window (50s)
    # still holds the storm -> not burning-now, hysteresis countdown starts
    for t in range(35, 52, 4):
        clock["t"] = float(t)
        for _ in range(500):
            hist.observe(0.001)
        eng.evaluate(force=True)
        assert eng.overall() == VIOLATED  # clear_s=20 not yet served
    clock["t"] = 56.0                     # clean since t=35 -> 21s >= 20s
    for _ in range(500):
        hist.observe(0.001)
    eng.evaluate(force=True)
    assert eng.overall() == OK
    # the transition counter saw the full walk
    snap = metrics.REGISTRY.snapshot()["truss_slo_transitions_total"]
    trans = {k: v for k, v in snap["values"].items() if k[0] == "q-p99"}
    assert trans[("q-p99", "burning")] >= 1
    assert trans[("q-p99", "violated")] >= 1
    assert trans[("q-p99", "ok")] >= 1


def test_slo_gauge_and_availability_objectives():
    reg = metrics.Registry()
    lag = reg.gauge("truss_replica_lag_gens", labels=("replica",))
    good = reg.counter("good_total")
    bad = reg.counter("bad_total")
    objs = [
        Objective("lag", "gauge", "truss_replica_lag_gens", target=0.9,
                  threshold=8.0, fast_s=10.0, slow_s=20.0),
        Objective("avail", "availability", "good_total", target=0.9,
                  bad_family="bad_total", fast_s=10.0, slow_s=20.0),
    ]
    clock = {"t": 0.0}
    eng = SLOEngine(objs, registry=reg, clock=lambda: clock["t"],
                    min_interval_s=0.0)
    lag.labels(replica="r0").set(2)
    good.inc(100)
    eng.evaluate(force=True)
    assert eng._state["lag"] == OK and eng._state["avail"] == OK
    # lag blows the threshold; every availability event is now bad
    lag.labels(replica="r0").set(50)
    bad.inc(100)
    clock["t"] = 5.0
    eng.evaluate(force=True)
    assert eng._state["lag"] == BURNING
    assert eng._state["avail"] == BURNING
    d = eng.state_dict()["objectives"]
    assert d["lag"]["burn_fast"] > 1.0 and d["avail"]["burn_fast"] > 1.0


def test_slo_rate_limit_and_stats_surface(tmp_path):
    """stats()["slo"] appears when an engine is attached, and evaluate()
    honors min_interval_s unless forced."""
    rng = np.random.default_rng(0)
    svc = _svc(_random_graph(rng, 0.3), tmp_path)
    clock = {"t": 0.0}
    # a private registry: the process-global one carries earlier tests'
    # latencies, which a fresh engine's first window would see as burn
    eng = SLOEngine(registry=metrics.Registry(),
                    clock=lambda: clock["t"], min_interval_s=10.0)
    svc.attach_slo(eng)
    out = svc.stats()
    assert out["slo"]["overall"] == OK
    assert set(out["slo"]["objectives"]) == {
        "query-p99", "write-ack-p99", "replica-lag",
        "committed-read-availability"}
    n0 = len(eng._samples)
    clock["t"] = 1.0
    eng.evaluate()               # rate-limited: no new sample
    assert len(eng._samples) == n0
    eng.evaluate(force=True)
    assert len(eng._samples) == n0 + 1


# -- flight recorder / postmortems -------------------------------------------

@pytest.fixture
def flight(tmp_path):
    """A freshly reset process-global recorder dumping into tmp_path."""
    flightrec.FLIGHT.reset()
    flightrec.FLIGHT.configure(str(tmp_path / "pm"))
    yield flightrec.FLIGHT
    flightrec.FLIGHT.reset()


def test_clean_run_dumps_nothing(flight, tmp_path):
    rng = np.random.default_rng(1)
    svc = _svc(_random_graph(rng, 0.3), tmp_path / "store")
    for i in range(5, 10):
        a, b = i % N, (i + 3) % N
        key = (min(a, b), max(a, b))
        svc.submit(OP_INSERT if key not in svc._view else 0, a, b)
    svc.handle(QueryRequest(kind=MEMBERS, k=3))
    svc.scrub()
    assert flight.dumps == []
    assert os.listdir(tmp_path / "pm") == []


def _drive_until_degraded(svc, rng, max_steps=200):
    """Submit random writes until the breaker opens (or give up)."""
    for _ in range(max_steps):
        a, b = int(rng.integers(0, N)), int(rng.integers(0, N))
        if a == b:
            continue
        key = (min(a, b), max(a, b))
        try:
            svc.submit(OP_INSERT if key not in svc._view else 0, a, b)
        except (Unavailable, OSError):
            pass
        if svc._degraded_reason is not None:
            return True
    return False


def test_seeded_chaos_dumps_validated_bundle(flight, tmp_path):
    """A sticky seeded fault schedule opens the breaker; the dumped bundle
    is valid JSON whose excerpt/metrics/frontier/SLO sections reference
    only facts the process actually recorded."""
    rng = np.random.default_rng(2)
    edges = _random_graph(rng, 0.3)
    faults = seeded_schedule(3, n_faults=4, sticky=True)
    store = TrussStore(str(tmp_path / "store"), io=FaultyIO(faults))
    svc = TrussService(N, edges, d_max=D_MAX, e_cap=E_CAP, store=store,
                       tracked_ks=(3,), flush_every=3, device="cpu")
    eng = SLOEngine()
    svc.attach_slo(eng)
    flight.configure(frontier=lambda: {"gen": svc.gen,
                                       "wal_applied": svc._applied_wal},
                     slo=eng.state_dict)
    assert _drive_until_degraded(svc, rng), "schedule never tripped"
    assert len(flight.dumps) >= 1
    bundle = json.load(open(flight.dumps[0]))
    assert bundle["format"] == "truss-postmortem-v1"
    assert bundle["trigger"] in ("breaker_open", "quarantine",
                                 "scrub_violation", "slo_violation")
    assert bundle["trace_excerpt"], "excerpt must not be empty"
    for ev in bundle["trace_excerpt"]:
        assert set(ev) >= {"seq", "name", "t0_ns", "dur_ns"}
    # every metric family in the snapshot exists in the live registry
    fams = metrics.REGISTRY.families()
    for name in bundle["metrics"]:
        assert name in fams, name
    assert bundle["metrics"]["truss_postmortem_trips_total"]["values"]
    # provider sections: frontier matches the engine, SLO state is shaped
    assert bundle["frontier"]["gen"] == svc.gen
    assert bundle["frontier"]["wal_applied"] == svc._applied_wal
    assert bundle["slo"]["overall"] in (OK, BURNING, VIOLATED)
    assert set(bundle["slo"]["objectives"]) == {
        o.name for o in eng.objectives}
    # the wal-op ring captured commits before the trip
    assert any(n["kind"] == "commit" for n in bundle["wal_ops"])


def test_trip_without_dir_only_counts():
    flightrec.FLIGHT.reset()
    try:
        before = metrics.REGISTRY.value("truss_postmortem_trips_total")
        assert flightrec.FLIGHT.trip("unit-test", detail=1) is None
        after = metrics.REGISTRY.value("truss_postmortem_trips_total")
        assert after == before + 1
    finally:
        flightrec.FLIGHT.reset()


def test_dump_cap(tmp_path):
    flightrec.FLIGHT.reset()
    try:
        flightrec.FLIGHT.configure(str(tmp_path), max_dumps=2)
        paths = [flightrec.FLIGHT.trip("t") for _ in range(5)]
        assert sum(p is not None for p in paths) == 2
        assert len(os.listdir(tmp_path)) == 2
    finally:
        flightrec.FLIGHT.reset()


# -- cross-process trace merge ------------------------------------------------

def _well_nested(events):
    """Spans on one track must nest: any two overlapping intervals are
    contained one in the other (zero-duration instants always nest)."""
    spans = sorted(((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X"), key=lambda s: (s[0], -s[1]))
    stack = []
    for s0, s1 in spans:
        while stack and stack[-1] <= s0:
            stack.pop()
        if stack and s1 > stack[-1] + 1e-9:
            return False  # overlaps the enclosing span's end: not nested
        stack.append(s1)
    return True


def test_merge_rebases_clocks_and_separates_pids(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text(json.dumps({"clock_sync": {"wall_ns": 1_000_000,
                                            "perf_ns": 0},
                             "pid": 7, "proc": "alpha"}) + "\n"
                 + json.dumps({"seq": 0, "parent": -1, "depth": 0,
                               "name": "x", "t0_ns": 5_000, "dur_ns": 2_000,
                               "attrs": {"trace_id": "t1"}}) + "\n")
    b.write_text(json.dumps({"clock_sync": {"wall_ns": 4_000_000,
                                            "perf_ns": 3_000_000},
                             "pid": 7, "proc": "beta"}) + "\n"
                 + json.dumps({"seq": 0, "parent": -1, "depth": 0,
                               "name": "y", "t0_ns": 5_000,
                               "dur_ns": 1_000,
                               "attrs": {"trace_id": "t1"}}) + "\n")
    doc = merge.merge_files([str(a), str(b)])
    xs = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    # both events rebase onto the same wall timeline
    assert xs["x"]["ts"] == pytest.approx(xs["y"]["ts"])
    assert xs["x"]["pid"] != xs["y"]["pid"]  # colliding pids separated
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M"}
    assert names == {"alpha", "beta"}
    ids = merge.trace_ids(doc)
    assert set(ids) == {"t1"}
    assert set(ids["t1"]) == {xs["x"]["pid"], xs["y"]["pid"]}
    # the CLI writes the same document
    out = tmp_path / "m.json"
    assert merge.main([str(out), str(a), str(b)]) == 0
    assert json.load(open(out)) == doc


_REPLICA_SCRIPT = """
import sys
from repro_torch.cluster import Replica
from repro_torch.obs import trace

writer = trace.TraceWriter(sys.argv[2], proc="replica")
rep = Replica(sys.argv[1], "r-sub", device="cpu")
rep.poll()
writer.close()
print(f"applied={rep.gen}")
"""


def test_e2e_router_primary_replica_single_trace(tmp_path):
    """Writes enter at the router edge of a pipelined primary, a *separate
    process* tails the WAL, and the merged Chrome trace shows one trace id
    spanning router, primary and replica spans, each track well-nested."""
    obs_trace.TRACER.clear()
    rng = np.random.default_rng(3)
    edges = _random_graph(rng, 0.35)
    svc = _svc(edges, tmp_path / "store", pipeline=True, flush_every=4)
    router = QueryRouter(svc, [], poll_on_miss=False)
    writer = obs_trace.TraceWriter(str(tmp_path / "edge.jsonl"),
                                   proc="router-primary")
    for _ in range(8):
        a, b = int(rng.integers(0, N)), int(rng.integers(0, N))
        if a == b:
            continue
        key = (min(a, b), max(a, b))
        router.submit(OP_INSERT if key not in svc._view else 0, a, b)
    router.route(QueryRequest(kind=MEMBERS, k=3))
    svc.flush()           # land the pipelined tail; commit.json published
    writer.close()        # no final snapshot: the replica must TAIL the WAL

    proc = subprocess.run(
        [sys.executable, "-c", _REPLICA_SCRIPT, str(tmp_path / "store"),
         str(tmp_path / "replica.jsonl")],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr
    assert f"applied={svc.gen}" in proc.stdout

    doc = merge.merge_files([str(tmp_path / "edge.jsonl"),
                             str(tmp_path / "replica.jsonl")])
    by_pid = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X":
            by_pid.setdefault(ev["pid"], []).append(ev)
    assert len(by_pid) == 2, "expected two process tracks"
    for pid, events in by_pid.items():
        assert _well_nested(events), f"track {pid} is not well-nested"
    spanning = {tid: pids for tid, pids in merge.trace_ids(doc).items()
                if len(pids) == 2}
    assert spanning, "no trace id spans both processes"
    names_by_tid = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        tid = (ev.get("args") or {}).get("trace_id")
        if tid in spanning:
            names_by_tid.setdefault(tid, set()).add(ev["name"])
    joined = set().union(*names_by_tid.values())
    assert any(n.startswith("router.") for n in joined)   # router edge
    assert "wal.append" in joined or "gen.commit" in joined  # primary
    assert "gen.replay" in joined                         # replica apply


def test_wal_trace_annotations_round_trip(tmp_path):
    """The # trace record: appended next to its generation, read back by
    scans and tails, checksummed, and invisible to record counting."""
    store = TrussStore(str(tmp_path))
    store.append_annotation(1, "ab" * 16)
    store.append(1, [(OP_INSERT, 0, 1), (OP_INSERT, 1, 2)])
    store.append_annotation(2, "cd" * 16)
    store.append(2, [(OP_INSERT, 2, 3)])
    assert store.wal_len == 3            # annotations are not records
    assert store.read_trace_annotations() == {1: "ab" * 16, 2: "cd" * 16}
    fresh = TrussStore(str(tmp_path), readonly=True)
    assert fresh.read_trace_annotations() == {1: "ab" * 16, 2: "cd" * 16}
    assert len(fresh.read_wal()) == 3
    # a corrupted annotation is skipped by the scan, not fatal
    raw = open(store.wal_path, "rb").read()
    bad = raw.replace(b"# trace 2", b"# trace x", 1)
    open(store.wal_path, "wb").write(bad)
    again = TrussStore(str(tmp_path), readonly=True)
    assert again.read_trace_annotations().get(1) == "ab" * 16


# -- wave-level profiling -----------------------------------------------------

def _wave_count():
    snap = metrics.REGISTRY.snapshot().get("truss_peel_wave_seconds")
    return sum(v["count"] for v in snap["values"].values()) if snap else 0


@pytest.mark.parametrize("method", ["sorted", "bitmap"])
def test_wave_profile_matches_fused_engines(method):
    """phi equal to the fused engines and to ``repro``'s profiled peel,
    ``PeelStats`` the recompute discipline's, one observation a wave."""
    rng = np.random.default_rng(4)
    n = 40
    edges = np.array(sorted({(min(u, v), max(u, v))
                             for u, v in rng.integers(0, n, (200, 2))
                             if u != v}), np.int32)
    spec = GraphSpec(n_nodes=n, e_cap=256, d_max=64)
    st = from_edge_list(spec, edges, device="cpu")
    phi0, s0 = run_peel(spec, st, st.active, method=method, device="cpu")
    r0, _ = run_peel(spec, st, st.active, method=method, engine="recompute",
                     device="cpu")
    n_before = _wave_count()
    set_wave_profile(True)
    try:
        assert wave_profile_enabled()
        phi1, s1 = run_peel(spec, st, st.active, method=method, device="cpu")
    finally:
        set_wave_profile(False)
    assert torch.equal(phi0, phi1) and torch.equal(r0, phi1)
    d0, d1 = stats_dict(s0), stats_dict(s1)
    assert d1["waves"] == d0["waves"] and d1["kills"] == d0["kills"]
    assert d1["deltas"] == 0 and d1["frontier"] == d0["frontier"]
    assert _wave_count() == n_before + d1["waves"]

    jspec = JSpec(n_nodes=n, e_cap=256, d_max=64)
    jst = j_from_edge_list(jspec, edges)
    j_set_wave_profile(True)
    try:
        jphi, js = j_peel(jspec, jst, jst.active, method=method)
    finally:
        j_set_wave_profile(False)
    assert np.array_equal(np.asarray(jphi), phi1.numpy())
    assert stats_dict(s1) == {k: int(v) for k, v in
                              zip(("waves", "kills", "deltas", "frontier"),
                                  js)}


def test_wave_profile_spares_the_batch_engine():
    """Under the wave profiler the fused batch engine's re-peel keeps its
    own engine (the reference's re-peel runs inside a jit trace), while a
    full decomposition is profiled."""
    g = DynamicGraph(N, [(0, 1), (1, 2), (0, 2), (2, 3), (1, 3)],
                     d_max=D_MAX, e_cap=E_CAP, support_method="bitmap",
                     device="cpu")
    n0 = _wave_count()
    set_wave_profile(True)
    try:
        g.apply_batch([(OP_INSERT, 0, 3), (OP_INSERT, 3, 4)],
                      strategy="fused")
        assert _wave_count() == n0
        assert stats_dict(g.last_peel_stats)["deltas"] > 0   # delta engine
        DynamicGraph(N, [(0, 1), (1, 2), (0, 2)], d_max=D_MAX, e_cap=E_CAP,
                     device="cpu")
        assert _wave_count() > n0
    finally:
        set_wave_profile(False)
    assert g.phi_dict() == oracle.scratch_phi(N, map(tuple, g.edge_list()
                                                     .tolist()))


# -- exposition ---------------------------------------------------------------

def _normalize(snap):
    """Label order differs between a declared schema and a parsed text page
    (sorted); compare label-set keyed values."""
    out = {}
    for name, fam in snap.items():
        vals = {}
        for key, v in fam["values"].items():
            vals[frozenset(zip(fam["labelnames"], key))] = v
        out[name] = {"type": fam["type"], "values": vals}
    return out


def test_render_parse_round_trip():
    reg = Registry()
    reg.counter("rt_total", "a counter").inc(5)
    reg.gauge("rt_depth", "a gauge").set(2.5)
    lab = reg.counter("rt_routed_total", labels=("policy", "node"))
    lab.labels(policy="strong", node="primary").inc(4)
    h = reg.histogram("rt_lat_seconds", buckets=(0.01, 0.1))
    h.observe(0.005)
    h.observe(0.05)
    h.observe(9.0)
    text = expo.render(reg)
    assert "# TYPE rt_lat_seconds histogram" in text
    assert 'rt_routed_total{policy="strong",node="primary"} 4' in text
    assert _normalize(expo.parse(text)) == _normalize(reg.snapshot())
    with pytest.raises(ValueError):
        expo.parse("rt_bad{unclosed 3\n")


def test_metrics_server_scrape(tmp_path):
    delta0 = metrics.REGISTRY.value("truss_flush_total")
    svc = TrussService(N, [(0, 1), (1, 2), (0, 2), (2, 3), (1, 3), (0, 3),
                           (3, 4), (4, 5)], d_max=D_MAX, e_cap=E_CAP,
                       store=TrussStore(str(tmp_path / "store")),
                       flush_every=2, device="cpu")
    for i in range(5, 9):
        svc.submit(OP_INSERT, i, i + 2)
    health = {"status": "ok"}
    srv = expo.MetricsServer(port=0, health=lambda: health)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics") as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == expo.CONTENT_TYPE
            page = r.read().decode()
        with urllib.request.urlopen(base + "/healthz") as r:
            assert r.status == 200 and json.load(r) == {"status": "ok"}
        health["status"] = "burning"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/healthz")
        assert err.value.code == 503
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope")
    finally:
        srv.stop()
    snap = expo.parse(page)
    for fam in ("truss_flush_total", "truss_wal_append_seconds",
                "truss_wal_fsync_total", "truss_peel_seconds",
                "truss_committed_gen", "truss_edges"):
        assert fam in snap, fam
    assert snap["truss_flush_total"]["values"][()] - delta0 >= 2


# -- the torch.profiler twin --------------------------------------------------

@pytest.fixture
def armed(tmp_path):
    """Profiling armed into tmp_path/prof; disarmed afterwards."""
    root = tmp_path / "prof"
    yield root
    profiling.configure(None)


def _work_spans(path):
    doc = json.load(open(path))
    return [e for e in doc["traceEvents"]
            if e.get("name") == profiling.WORK_SPAN]


def test_profiler_writes_one_trace_per_region(armed):
    profiling.configure(str(armed), max_traces=8)
    svc = _svc([(0, 1), (1, 2), (0, 2)], flush_every=100)
    svc.submit(OP_INSERT, 0, 3)
    assert svc.flush() == 1
    DynamicGraph(N, [(0, 1), (1, 2), (0, 2)], d_max=D_MAX, e_cap=E_CAP,
                 device="cpu")
    names = sorted(os.listdir(armed))
    assert names[0].startswith("decompose-") and "flush-1.json" in names
    for name in names:
        assert _work_spans(armed / name), name
        assert profiling.lost_records(str(armed / name)) == (0, [])


def test_profiler_reentrance_and_cap(armed):
    profiling.configure(str(armed), max_traces=2)
    with profiling.profile_region("outer"):
        with profiling.profile_region("inner"):   # nested: records once
            torch.ones(4).add_(1)
    assert os.listdir(armed) == ["outer-0.json"]
    assert profiling.is_configured()
    with profiling.profile_region("second"):
        pass
    assert not profiling.is_configured()           # the cap is reached
    with profiling.profile_region("third"):
        pass
    assert sorted(os.listdir(armed)) == ["outer-0.json", "second-1.json"]


def test_profiler_that_fails_to_start_raises(armed, monkeypatch):
    """Unlike the reference, which records nothing and carries on, an armed
    region whose profiler cannot start raises (ROADMAP R5)."""
    profiling.configure(str(armed))

    def refuse(self):
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    with pytest.raises(RuntimeError, match="failed to start"):
        with profiling.profile_region("flush"):
            pytest.fail("the region ran unprofiled")
    monkeypatch.undo()
    with profiling.profile_region("flush"):    # the guard was released
        pass
    assert os.listdir(armed) == ["flush-1.json"]


def test_lost_records_matches_calls_to_device_records(tmp_path):
    """The guard's check on a hand-built trace: a launch inside the work
    span without its device record is lost; one outside the span, or one
    with its record, is not."""
    span = {"name": profiling.WORK_SPAN, "cat": "user_annotation",
            "ph": "X", "ts": 100.0, "dur": 50.0}
    calls = [("cudaLaunchKernel", 110.0, 1), ("cudaMemcpyAsync", 120.0, 2),
             ("cudaLaunchKernel", 130.0, 3), ("cudaLaunchKernel", 10.0, 4),
             ("cudaStreamSynchronize", 140.0, 5)]
    events = [span] + [{"name": n, "cat": "cuda_runtime", "ph": "X",
                        "ts": ts, "dur": 1.0, "args": {"correlation": c}}
                       for n, ts, c in calls]
    events += [{"name": "k", "cat": "kernel", "ph": "X", "ts": 115.0,
                "dur": 1.0, "args": {"correlation": 1}},
               {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ph": "X",
                "ts": 125.0, "dur": 1.0, "args": {"correlation": 2}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling.lost_records(str(path)) == (3, [("cudaLaunchKernel", 3)])
