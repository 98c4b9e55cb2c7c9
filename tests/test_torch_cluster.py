"""The port's replica cluster (``repro_torch.cluster``) on the CPU: twins of
``tests/test_cluster.py`` and the cross-package cases.

* **Twins**: a replica bitwise equal to its primary (and both to the
  oracle) at every committed generation, across compaction and
  randomized kill points; promotion keeping every acked write; the
  router's consistency policies, poll on miss and eviction-free
  fallbacks; the WAL tail cache and the read-only store; batched WAL
  appends; the mixed workload; lease and lag stats.
* **Across packages**: a ``repro_torch`` replica tailing the store a
  ``repro`` primary writes is bitwise equal to it at every generation,
  and a ``repro`` replica tailing a ``repro_torch`` primary's store too.
  The streams of ``data/streams.py`` yield identical records in both
  packages at the same seed.

Every graph shares one pinned spec (``N``/``D_MAX``/``E_CAP``), as the
reference's cluster tests do.
"""
import numpy as np
import pytest
import torch

import repro.cluster as JC
import repro.data.streams as JD
import repro.service as JS
import repro_torch.data.streams as TD
from repro.core import oracle
from repro_torch.cluster import QueryRouter, Replica, query_from_record
from repro_torch.data.streams import (READ, WRITE, MixedWorkloadStream,
                                      make_update_stream)
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.service import (BOUNDED, MAX_K, MEMBERS, READ_YOUR_WRITES,
                                 STRONG, QueryRequest, TrussService,
                                 TrussStore)

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


def _svc(edges, tmpdir, **kw):
    kw.setdefault("tracked_ks", (3, 4))
    kw.setdefault("flush_every", 5)
    return TrussService(N, edges, d_max=D_MAX, e_cap=E_CAP,
                        store=TrussStore(str(tmpdir)), device="cpu", **kw)


def _replica(root, rid="r0", **kw):
    return Replica(str(root), rid, device="cpu", **kw)


def _random_graph(rng, p, n=N):
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state(node):
    """The GraphState behind a service or a replica of either package."""
    if isinstance(node, (Replica, JC.Replica)):
        return node.svc.graph.state
    return node.graph.state


def _assert_bitwise_equal(a, b):
    """Every GraphState array identical, dtype included — not just
    phi_dict equality."""
    st_a, st_b = _state(a), _state(b)
    assert st_a._fields == st_b._fields
    for name, x, y in zip(st_a._fields, st_a, st_b):
        x, y = _host(x), _host(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


# -- replica tailing ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_replica_bitwise_tracks_primary(seed, tmp_path):
    """At every committed generation boundary the polled replica's arrays
    equal the primary's bit for bit, and both equal the oracle."""
    rng = np.random.default_rng(seed)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 30, seed=seed + 20)
    svc = _svc(edges, tmp_path)
    rep = _replica(tmp_path)
    orc = oracle.Oracle(N, edges)
    for i, rec in enumerate(stream):
        svc.submit(*map(int, rec))
        if rec[0]:
            orc.insert(*rec[1:])
        else:
            orc.delete(*rec[1:])
        if i % 5 == 4:  # flush_every=5 -> a generation just committed
            assert rep.poll() == svc.gen
            _assert_bitwise_equal(svc, rep)
            assert rep.svc.graph.phi_dict() == orc.phi
    # mid-batch: replica sits at the last committed boundary, not ahead
    svc.submit(1, 0, 1) if (0, 1) not in svc._view else svc.submit(0, 0, 1)
    assert rep.poll() == svc.gen


def test_replica_across_compaction(tmp_path):
    """A snapshot compacts the WAL prefix; a replica that was parked before
    the compaction point reinstalls the newer snapshot and keeps tailing."""
    rng = np.random.default_rng(3)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 30, seed=23)
    svc = _svc(edges, tmp_path)
    rep = _replica(tmp_path)   # bootstrapped at gen 0
    for rec in stream[:10]:
        svc.submit(*map(int, rec))
    svc.snapshot()
    for rec in stream[10:20]:
        svc.submit(*map(int, rec))
    # the second snapshot compacts to the first's mark: base jumps past rep
    svc.snapshot()
    for rec in stream[20:]:
        svc.submit(*map(int, rec))
    svc.flush()
    assert svc.store.base > rep.wal_applied
    assert rep.poll() == svc.gen         # snapshot-install path
    _assert_bitwise_equal(svc, rep)
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    assert rep.svc.graph.phi_dict() == orc.phi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replica_crash_restart_randomized_kill_points(seed, tmp_path):
    """Kill the replica mid WAL-tail apply (a capped poll), with a primary
    snapshot at a random spot so the restart may cross a compaction; a
    fresh Replica over the same store converges to the primary's bitwise
    state and the oracle."""
    rng = np.random.default_rng(seed + 40)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 36, seed=seed + 50)
    snap_at = int(rng.integers(5, 30))
    park_gens = int(rng.integers(1, 4))
    svc = _svc(edges, tmp_path)
    rep = _replica(tmp_path)
    for i, rec in enumerate(stream):
        svc.submit(*map(int, rec))
        if i == snap_at:
            svc.snapshot()
    svc.flush()
    rep.poll(max_gens=park_gens)  # apply only a prefix of the tail...
    del rep                       # ...then crash mid-apply

    restarted = _replica(tmp_path)  # may land mid-history
    assert restarted.poll() == svc.gen
    _assert_bitwise_equal(svc, restarted)
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    assert restarted.svc.graph.phi_dict() == orc.phi


# -- promotion / failover -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_promotion_failover_randomized_kill_points(seed, tmp_path):
    """Kill the primary after a random number of acked writes; the promoted
    replica equals the oracle on the *full* acked prefix — acked but
    uncommitted WAL records included — and keeps serving writes."""
    rng = np.random.default_rng(seed + 60)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 40, seed=seed + 70)
    kill = int(rng.integers(8, len(stream)))
    snap_at = int(rng.integers(0, kill))
    park_gens = int(rng.integers(0, 4))

    svc = _svc(edges, tmp_path)
    rep = _replica(tmp_path)
    for i, rec in enumerate(stream[:kill]):
        svc.submit(*map(int, rec))
        if i == snap_at:
            svc.snapshot()
    if park_gens:
        rep.poll(max_gens=park_gens)
    del svc  # primary crash: pending writes acked in the WAL but unapplied

    promoted = rep.promote()
    assert promoted.graph.device.type == "cpu"
    orc = oracle.Oracle(N, edges)
    orc.apply(stream[:kill])
    assert promoted.graph.phi_dict() == orc.phi
    # the new primary keeps serving: writes, reads, snapshot/restore
    promoted.submit_many([tuple(map(int, r)) for r in stream[kill:]])
    promoted.flush()
    orc.apply(stream[kill:])
    assert promoted.graph.phi_dict() == orc.phi
    promoted.snapshot()
    del promoted
    again = TrussService.restore(TrussStore(str(tmp_path)), device="cpu")
    assert again.graph.phi_dict() == orc.phi


def test_router_promotes_most_caught_up_replica(tmp_path):
    edges = [(0, 1), (1, 2), (0, 2), (2, 3)]
    svc = _svc(edges, tmp_path, flush_every=2)
    fresh = _replica(tmp_path, "fresh")
    stale = _replica(tmp_path, "stale")
    svc.submit_many([(1, 0, 3), (1, 1, 3), (1, 0, 4), (1, 1, 4)])
    fresh.poll()
    router = QueryRouter(svc, [stale, fresh], poll_on_miss=False)
    del svc
    promoted = router.promote()
    assert router.primary is promoted
    assert [r.replica_id for r in router.replicas] == ["stale"]
    # the promoted store took over the lease directory
    assert "fresh" not in promoted.store.read_replicas()
    assert promoted.max_k(0, 3) >= 2


# -- consistency routing ------------------------------------------------------

def test_routing_policies(tmp_path):
    edges = [(0, 1), (1, 2), (0, 2)]
    svc = _svc(edges, tmp_path, flush_every=3)
    rep = _replica(tmp_path)
    router = QueryRouter(svc, [rep], poll_on_miss=False)
    sess = router.session()
    # advance the primary two generations; the replica stays parked at 0
    sess.submit_many([(1, 0, 3), (1, 1, 3), (1, 2, 3),
                      (1, 0, 4), (1, 1, 4), (1, 2, 4)])
    assert svc.gen == 2 and rep.gen == 0 and sess.token == 2

    # strong: always the primary
    r = sess.query(QueryRequest(MEMBERS, k=3, consistency=STRONG))
    assert r.served_by == "primary" and r.gen == svc.gen

    # bounded(g): the stale replica qualifies only when its lag <= g
    r = sess.query(QueryRequest(MEMBERS, k=3, consistency=BOUNDED, bound=5))
    assert r.served_by == "r0" and r.gen == 0 and svc.gen - r.gen <= 5
    r = sess.query(QueryRequest(MEMBERS, k=3, consistency=BOUNDED, bound=1))
    assert r.served_by == "primary"  # replica 2 gens behind > bound 1

    # read-your-writes: the parked replica is below the token -> primary
    r = sess.query(QueryRequest(MAX_K, edge=(2, 3),
                                consistency=READ_YOUR_WRITES))
    assert r.served_by == "primary" and r.gen >= sess.token and r.value == 4

    # once the replica catches up it takes RYW and bounded(0) reads
    rep.poll()
    for consistency, bound in ((READ_YOUR_WRITES, 0), (BOUNDED, 0)):
        r = sess.query(QueryRequest(MAX_K, edge=(2, 3),
                                    consistency=consistency, bound=bound))
        assert r.served_by == "r0" and r.gen >= sess.token and r.value == 4


def test_bounded_primary_fallback_serves_committed_without_flush(tmp_path):
    """A bounded read that falls back to the primary (no replica within
    bound) serves the committed generation WITHOUT flushing pending
    writes."""
    edges = [(0, 1), (1, 2), (0, 2)]
    svc = _svc(edges, tmp_path, flush_every=100)
    router = QueryRouter(svc, [], poll_on_miss=False)  # zero replicas
    sess = router.session()
    sess.submit(1, 0, 3)
    assert len(svc._pending) == 1 and svc.gen == 0
    r = sess.query(QueryRequest(MEMBERS, k=2, consistency=BOUNDED, bound=3))
    assert r.served_by == "primary" and r.gen == 0
    assert len(svc._pending) == 1          # still queued: no flush happened
    assert (0, 3) not in {tuple(e) for e in r.edges}  # committed view only
    # strong on the same router still flushes and sees the write
    r = sess.query(QueryRequest(MEMBERS, k=2, consistency=STRONG))
    assert r.gen == 1 and (0, 3) in {tuple(e) for e in r.edges}


def test_replica_poll_keeps_tail_cache_hot(tmp_path):
    """With an uncommitted WAL tail present, the store's tail cache parks
    at the committed frontier, so the next poll resumes there."""
    edges = [(0, 1), (1, 2), (0, 2)]
    svc = _svc(edges, tmp_path, flush_every=4)
    rep = _replica(tmp_path)
    # 4 committed + 2 acked-but-uncommitted records in the WAL
    svc.submit_many([(1, 0, 3), (1, 1, 3), (1, 2, 3), (1, 0, 4),
                     (1, 1, 4), (1, 2, 4)])
    assert rep.poll() == 1
    assert rep.store._tail_cache[1] == 4   # parked AT the frontier...
    svc.flush()
    assert rep.poll() == 2                 # ...so this resumes from it
    assert rep.store._tail_cache[1] == 6
    _assert_bitwise_equal(svc, rep)


def test_router_poll_on_miss_catches_replica_up(tmp_path):
    edges = [(0, 1), (1, 2), (0, 2)]
    svc = _svc(edges, tmp_path, flush_every=2)
    rep = _replica(tmp_path)
    router = QueryRouter(svc, [rep])  # poll_on_miss=True
    sess = router.session()
    sess.submit_many([(1, 0, 3), (1, 1, 3)])
    assert rep.gen == 0
    r = sess.query(QueryRequest(MEMBERS, k=2, consistency=READ_YOUR_WRITES))
    assert r.served_by == "r0" and r.gen >= sess.token  # polled, then served


def test_query_request_consistency_validation():
    with pytest.raises(ValueError):
        QueryRequest(MEMBERS, consistency="eventual")
    with pytest.raises(ValueError):
        QueryRequest(MEMBERS, consistency=BOUNDED, bound=-1)


# -- satellites ---------------------------------------------------------------

def test_wal_tail_cache(tmp_path):
    """Repeated tailing resumes from the cached offset (O(new records)),
    and the cache invalidates across compaction and external appends."""
    store = TrussStore(str(tmp_path))
    store.append(1, [(1, 0, 1), (1, 0, 2)])
    assert [r[3] for r in store.read_wal()] == [1, 2]
    pos0 = store._tail_cache
    assert pos0 is not None and pos0[1] == 2
    store.append(2, [(1, 0, 3)])
    assert store.read_wal(start=2) == [(2, 1, 0, 3)]  # tail-only read
    assert store._tail_cache[1] == 3
    # a lower start than the cache forces (and survives) a full rescan
    assert len(store.read_wal(0)) == 3

    # a readonly tailer keeps its own cache against the live writer
    ro = TrussStore(str(tmp_path), readonly=True)
    assert len(ro.read_wal(0)) == 3
    store.append(3, [(1, 0, 4), (1, 0, 5)])
    assert [r[3] for r in ro.read_wal(start=3)] == [4, 5]
    assert ro.wal_len == 5

    # compaction replaces the file: both caches must re-anchor on the base
    store._compact(5)
    assert store.read_wal(0) == [] and store.base == 5
    store.append(4, [(1, 0, 6)])
    assert ro.read_wal(start=5) == [(4, 1, 0, 6)]
    assert ro.base == 5
    store.close()


def test_readonly_store_never_mutates(tmp_path):
    store = TrussStore(str(tmp_path))
    store.append(1, [(1, 0, 1)])
    store.close()
    # leave a torn tail; a readonly open must not truncate it
    with open(tmp_path / "wal.log", "a") as f:
        f.write("2 1 0")
    size = (tmp_path / "wal.log").stat().st_size
    ro = TrussStore(str(tmp_path), readonly=True)
    assert ro.wal_len == 1  # torn record not counted...
    assert (tmp_path / "wal.log").stat().st_size == size  # ...nor truncated
    for call in (lambda: ro.append(1, [(1, 2, 3)]),
                 lambda: ro.fsync(),
                 lambda: ro.snapshot({}),
                 lambda: ro.publish_commit(1, 1)):
        with pytest.raises(ValueError, match="read-only"):
            call()
    # a torn tail parks the reader cache *before* the torn record; once the
    # writer completes the line, the tailer picks the whole record up
    assert ro.read_wal(start=1) == []
    rw = TrussStore(str(tmp_path))  # truncates the torn tail...
    rw.append(2, [(1, 0, 5)])      # ...and appends a complete record
    assert ro.read_wal(start=1) == [(2, 1, 0, 5)]
    rw.close()


def test_submit_many_batches_wal_appends(tmp_path):
    """submit_many = one append_tagged + at most one fsync per call, with
    gen tags identical to per-record submit across auto-flush boundaries."""
    rng = np.random.default_rng(9)
    edges = _random_graph(rng, 0.35)
    stream = make_update_stream(np.asarray(edges), N, 13, seed=31)
    ups = [tuple(map(int, r)) for r in stream]

    ref = _svc(edges, tmp_path / "ref", flush_every=5)
    ref_acks = [ref.submit(*u) for u in ups]

    bat = _svc(edges, tmp_path / "bat", flush_every=5)
    appends, fsyncs = [], []
    orig_append, orig_fsync = bat.store.append_tagged, bat.store.fsync
    bat.store.append_tagged = lambda recs: (appends.append(len(recs)),
                                            orig_append(recs))[1]

    def counting_fsync():
        if bat.store._synced_len != bat.store.wal_len:
            fsyncs.append(1)
        orig_fsync()
    bat.store.fsync = counting_fsync
    bat_acks = bat.submit_many(ups)

    assert appends == [len(ups)]          # ONE WAL append for the batch
    assert len(fsyncs) == 1               # ONE real fsync despite 2 flushes
    assert [a.gen for a in bat_acks] == [a.gen for a in ref_acks]
    assert [a.wal_index for a in bat_acks] == [a.wal_index for a in ref_acks]
    assert bat.store.read_wal() == ref.store.read_wal()  # byte-identical log
    assert bat.gen == ref.gen
    _assert_bitwise_equal(ref, bat)

    # replay across the batched log reconstructs the same generations
    bat.store.close()
    del bat
    restored = TrussService.restore(TrussStore(str(tmp_path / "bat")),
                                    flush_every=5, device="cpu")
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    assert restored.graph.phi_dict() == orc.phi


def test_submit_many_rejects_bad_batch_without_acks(tmp_path):
    svc = _svc([(0, 1)], tmp_path, flush_every=10)
    wal_before = svc.store.wal_len
    with pytest.raises(ValueError):
        svc.submit_many([(1, 0, 2), (1, 0, 2)])  # dup insert inside batch
    assert svc.store.wal_len == wal_before  # nothing acked, nothing logged
    assert svc._pending == [] and (0, 2) not in svc._view
    svc.submit_many([(1, 0, 2)])            # the store still works
    assert (0, 2) in svc._view


def test_mixed_workload_stream_deterministic_and_zipfian():
    edges = np.asarray([(0, 1), (1, 2), (2, 3)])
    a = MixedWorkloadStream(edges, 50, chunk=64, read_frac=0.8, seed=7)
    b = MixedWorkloadStream(edges, 50, chunk=64, read_frac=0.8, seed=7)
    recs = [r for _ in range(4) for r in a.next()]
    assert recs == [r for _ in range(4) for r in b.next()]
    reads = [r for r in recs if r[0] == READ]
    writes = [r for r in recs if r[0] == WRITE]
    assert len(reads) + len(writes) == len(recs)
    assert 0.6 < len(reads) / len(recs) < 0.95
    # zipf skew: the top node id dominates the community-seed keys
    seeds = [r[3] for r in reads if r[1] == "community"]
    assert seeds.count(0) > len(seeds) / 10
    # writes are valid when applied in order (insert absent / delete present)
    present = {tuple(map(int, e)) for e in edges}
    for _, op, u, v in writes:
        key = (min(u, v), max(u, v))
        assert (key not in present) if op else (key in present)
        present.add(key) if op else present.discard(key)
    # every read record converts to a well-formed QueryRequest
    for r in reads:
        query_from_record(r, consistency=BOUNDED, bound=1)
    # state_dict round-trip resumes the identical stream
    state = a.state_dict()
    c = MixedWorkloadStream(edges, 50, chunk=64, read_frac=0.8, seed=7)
    c.load_state_dict(state)
    assert a.next() == c.next()


def test_replica_lease_and_lag_stats(tmp_path):
    edges = [(0, 1), (1, 2), (0, 2)]
    svc = _svc(edges, tmp_path, flush_every=2)
    rep = _replica(tmp_path, "r7")
    svc.submit_many([(1, 0, 3), (1, 1, 3), (1, 2, 3), (1, 0, 4)])
    st = svc.stats()["replicas"]["r7"]
    assert st["lag_gens"] == svc.gen and st["lag_records"] > 0
    rep.poll()
    st = svc.stats()["replicas"]["r7"]
    assert st["lag_gens"] == 0 and st["lag_records"] == 0
    assert rep.stats()["lag_gens"] == 0


# -- across packages ----------------------------------------------------------

def _primary(pkg, edges, root, **kw):
    extra = {"device": "cpu"} if pkg is not JS else {}
    return pkg.TrussService(N, edges, d_max=D_MAX, e_cap=E_CAP,
                            store=pkg.TrussStore(str(root)),
                            tracked_ks=(3, 4), flush_every=4, **kw, **extra)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_replica_tails_other_package_bitwise(writer, tmp_path):
    """One package's primary writes the store, the other's replica tails
    it: bitwise equal at every generation boundary (a snapshot and its
    compaction included), and to the oracle."""
    import repro_torch.service as TS
    wpkg, rcls = (JS, Replica) if writer == "repro" else (TS, JC.Replica)
    rng = np.random.default_rng(11)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 32, seed=12)
    svc = _primary(wpkg, edges, tmp_path)
    kw = {"device": "cpu"} if rcls is Replica else {}
    rep = rcls(str(tmp_path), "x0", **kw)
    seen = []

    def check():
        assert rep.poll() == svc.gen
        _assert_bitwise_equal(svc, rep)
        # the WAL holds exactly the stream's records (the baseline lives in
        # the bootstrap snapshot): the applied frontier is a stream prefix
        orc = oracle.Oracle(N, edges)
        orc.apply(stream[:rep.wal_applied])
        assert rep.svc.graph.phi_dict() == orc.phi
        seen.append(rep.gen)

    for i, rec in enumerate(stream):
        svc.submit(*map(int, rec))
        if i == 17:
            svc.snapshot()   # flushes a short generation, then compacts
        if i % 4 == 3:
            check()
    svc.flush()
    check()
    assert seen == sorted(set(seen)) and seen[-1] == svc.gen
    assert rep.wal_applied == len(stream)


def test_streams_identical_across_packages():
    """Same seed, same records: the mixed workload (with its zipf keys) and
    the update streams, through a state_dict round trip."""
    edges = powerlaw_graph(300, 4, seed=0)
    kw = dict(chunk=64, read_frac=0.8, ks=(3, 5), seed=7)
    a = JD.MixedWorkloadStream(edges, 300, **kw)
    b = TD.MixedWorkloadStream(edges, 300, **kw)
    for _ in range(12):
        assert a.next() == b.next()
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    assert np.array_equal(sa["present"], sb["present"])
    c = TD.MixedWorkloadStream(edges, 300, **kw).load_state_dict(sa)
    assert a.next() == c.next()

    u = JD.GraphUpdateStream(edges, 300, chunk=16, seed=3)
    v = TD.GraphUpdateStream(edges, 300, chunk=16, seed=3)
    for _ in range(20):
        x, y = u.next(), v.next()
        assert x.dtype == y.dtype and np.array_equal(x, y)
    legacy = {"seed": 3, "step": 5}
    w = TD.GraphUpdateStream(edges, 300, chunk=16).load_state_dict(legacy)
    z = JD.GraphUpdateStream(edges, 300, chunk=16).load_state_dict(legacy)
    assert np.array_equal(w.next(), z.next())

    s1 = JD.make_update_stream(edges, 300, 200, seed=5)
    s2 = TD.make_update_stream(edges, 300, 200, seed=5)
    assert np.array_equal(s1, s2)
    assert [np.array_equal(p, q) for p, q in zip(
        JD.iter_batches(s1, 64), TD.iter_batches(s2, 64))] == [True] * 4
