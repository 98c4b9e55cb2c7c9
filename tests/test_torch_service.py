"""The port's WAL-backed ``TrussService`` against ``repro.service`` and the
pure-Python oracle, on the CPU.

* **Parity.**  The same seeded write sequence (serial, ``flush_every=4``,
  no trace bound in either package, so no ``# trace`` annotation enters
  either log) gives byte-identical ``wal.log`` and ``commit.json``; a store
  written by either package restores in the other to a bitwise-equal
  ``GraphState``, the same phi and the same k-truss components.
* **Twins of ``tests/test_service.py``**: kill points, restore without a
  snapshot, a torn WAL tail, compaction, partial-write rollback, a dirty
  store refused, read-your-writes, pending-view validation, the query
  API, ``handle`` dispatch, the stream state through a snapshot, the
  representatives cache and the crash-recovery property.  Components are
  compared as a *set* of frozensets (ROADMAP R1: the reference's sorted
  lists of frozensets order by subset, not by content).

Every graph shares one pinned spec (``N``/``D_MAX``/``E_CAP``), as the
reference's service tests do.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import repro.service as JS
import repro_torch.service as TS
from repro.core import oracle
from repro.data.streams import GraphUpdateStream, make_update_stream
from repro_torch.core import DynamicGraph, representatives
from repro_torch.obs import profiling
from repro_torch.service import (COMMUNITY, MAX_K, MEMBERS, REPRESENTATIVES,
                                 QueryRequest, TrussService, TrussStore,
                                 WriteRequest)

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
    store = TrussStore(str(tmpdir)) if tmpdir is not None else None
    kw.setdefault("tracked_ks", (3, 4))
    return TrussService(N, edges, d_max=D_MAX, e_cap=E_CAP, store=store,
                        device="cpu", **kw)


def _restore(root, **kw):
    return TrussService.restore(TrussStore(str(root)), device="cpu", **kw)


def _random_graph(rng, p, n=N):
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def _py_components(phi, k) -> set:
    """Components of the (phi >= k)-subgraph (node-sharing), as a set of
    frozensets of edges."""
    parent = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    members = [e for e, p in phi.items() if p >= k]
    for a, b in members:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    groups = {}
    for a, b in members:
        groups.setdefault(find(a), set()).add((a, b))
    return {frozenset(g) for g in groups.values()}


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _service_components(svc, k) -> set:
    """Components of either package's service, from its label query."""
    lab = _host(svc._labels(k))
    edges = _host(svc.graph.state.edges)
    act = _host(svc.graph.state.active)
    groups = {}
    for i in np.nonzero(act & (lab < 2 ** 30))[0]:
        groups.setdefault(int(lab[i]), set()).add(
            (int(edges[i, 0]), int(edges[i, 1])))
    return {frozenset(g) for g in groups.values()}


def _assert_matches_oracle(svc, orc):
    assert svc.graph.phi_dict() == orc.phi
    for k in (3, 4):
        assert _service_components(svc, k) == _py_components(orc.phi, k), k


def _assert_same_state(a, b):
    for name, x, y in zip(a.graph.state._fields, a.graph.state, b.graph.state):
        x, y = _host(x), _host(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _drive(pkg, root, edges, stream, snap_at=None, flush_every=4):
    """One package's service over ``stream``: submit each write, snapshot
    after record ``snap_at``, then drop the service without flushing."""
    store = pkg.TrussStore(str(root))
    kw = {"device": "cpu"} if pkg is TS else {}
    svc = pkg.TrussService(N, edges, d_max=D_MAX, e_cap=E_CAP, store=store,
                           tracked_ks=(3, 4), flush_every=flush_every, **kw)
    for i, rec in enumerate(stream):
        svc.submit(*map(int, rec))
        if i == snap_at:
            svc.snapshot()
    svc.store.close()


# -- parity with the reference ----------------------------------------------

@pytest.mark.slow
def test_wal_and_commit_bytes_match_reference(tmp_path):
    """Same seeded writes, serial, flush_every=4, no trace bound: the two
    logs and commit frontiers are byte-identical."""
    rng = np.random.default_rng(21)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 30, seed=22)
    _drive(JS, tmp_path / "j", edges, stream, snap_at=13)
    _drive(TS, tmp_path / "t", edges, stream, snap_at=13)
    for name in ("wal.log", "commit.json"):
        with open(tmp_path / "j" / name, "rb") as f:
            want = f.read()
        with open(tmp_path / "t" / name, "rb") as f:
            assert f.read() == want, name
    # the snapshot flushed the open generation after 14 writes, then four
    # full generations of 4 committed the rest
    assert json.loads(want) == {"gen": 8, "wal_len": 30}
    with open(tmp_path / "t" / "wal.log", "rb") as f:
        assert f.readline().startswith(b"# base 0 c")


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_store_restores_across_packages(writer, tmp_path):
    """A store written by either package (a snapshot mid-stream, acked
    writes pending at the crash) restores in both to a bitwise-equal
    GraphState, phi equal to the oracle and the same components."""
    rng = np.random.default_rng(31)
    edges = _random_graph(rng, 0.35)
    stream = make_update_stream(np.asarray(edges), N, 26, seed=32)
    _drive(JS if writer == "repro" else TS, tmp_path, edges, stream,
           snap_at=9, flush_every=5)
    ref = JS.TrussService.restore(JS.TrussStore(str(tmp_path)), flush_every=5)
    ref.store.close()
    port = _restore(tmp_path, flush_every=5)
    _assert_same_state(port, ref)
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    _assert_matches_oracle(port, orc)
    for k in (3, 4):
        assert _service_components(port, k) == _service_components(ref, k)
    assert port.gen == ref.gen and port._applied_wal == ref._applied_wal
    assert port.replayed_records == ref.replayed_records


# -- crash recovery ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crash_recovery_randomized_kill_points(seed, tmp_path):
    """Kill after a random number of acked updates (snapshot at another
    random point); restore + replay must equal the oracle on the acked
    prefix, then keep serving."""
    rng = np.random.default_rng(seed)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 40, seed=seed + 10)
    kill = int(rng.integers(1, len(stream)))
    snap_at = int(rng.integers(0, kill))

    svc = _svc(edges, tmp_path / f"s{seed}", flush_every=5)
    for i, rec in enumerate(stream[:kill]):
        svc.submit(*map(int, rec))
        if i == snap_at:
            svc.snapshot()
    del svc  # crash (pending writes may be acked but unapplied)

    restored = _restore(tmp_path / f"s{seed}", flush_every=5)
    orc = oracle.Oracle(N, edges)
    orc.apply(stream[:kill])
    _assert_matches_oracle(restored, orc)

    restored.submit_many([tuple(map(int, r)) for r in stream[kill:]])
    restored.flush()
    orc.apply(stream[kill:])
    _assert_matches_oracle(restored, orc)


def test_restore_without_snapshot_after_init(tmp_path):
    rng = np.random.default_rng(7)
    edges = _random_graph(rng, 0.35)
    stream = make_update_stream(np.asarray(edges), N, 17, seed=3)
    svc = _svc(edges, tmp_path, flush_every=4)
    svc.submit_many([tuple(map(int, r)) for r in stream])
    del svc
    restored = _restore(tmp_path)
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    _assert_matches_oracle(restored, orc)


def test_restore_truncates_torn_wal_tail(tmp_path):
    rng = np.random.default_rng(11)
    edges = _random_graph(rng, 0.35)
    stream = make_update_stream(np.asarray(edges), N, 12, seed=4)
    svc = _svc(edges, tmp_path, flush_every=4)
    svc.submit_many([tuple(map(int, r)) for r in stream])
    svc.store.close()
    del svc
    with open(tmp_path / "wal.log", "a") as f:
        f.write("1 1 5")  # torn record: no trailing newline
    restored = _restore(tmp_path, flush_every=4)
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    _assert_matches_oracle(restored, orc)
    assert restored.store.wal_len == len(stream)
    nxt = make_update_stream(restored.graph.edge_list(), N, 5, seed=5)
    restored.submit_many([tuple(map(int, r)) for r in nxt])
    restored.store.close()
    del restored
    again = _restore(tmp_path, flush_every=4)
    orc.apply(nxt)
    _assert_matches_oracle(again, orc)


def test_snapshot_compacts_wal(tmp_path):
    rng = np.random.default_rng(13)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 36, seed=6)
    svc = _svc(edges, tmp_path, flush_every=4)
    for i, rec in enumerate(stream[:30]):
        svc.submit(*map(int, rec))
        if i % 12 == 11:
            svc.snapshot()  # snapshots at wal_len 12 and 24
    with open(svc.store.wal_path) as f:
        lines = f.readlines()
    assert lines[0].startswith("# base 12")
    assert len(lines) == 1 + (30 - 12)
    assert os.path.exists(svc.store.snap_path + ".prev")
    svc.store.close()
    del svc
    restored = _restore(tmp_path, flush_every=4)
    assert restored.store.base == 12 and restored.store.wal_len == 30
    orc = oracle.Oracle(N, edges)
    orc.apply(stream[:30])
    _assert_matches_oracle(restored, orc)
    restored.submit_many([tuple(map(int, r)) for r in stream[30:]])
    restored.flush()
    assert restored.store.wal_len == 36
    orc.apply(stream[30:])
    _assert_matches_oracle(restored, orc)


def test_append_rolls_back_partial_write(tmp_path):
    store = TrussStore(str(tmp_path))
    store.append(1, [(1, 0, 1)])

    class _TornWriter:
        """Writes a truncated prefix, then fails — a torn append."""
        def __init__(self, f):
            self._f = f

        def tell(self):
            return self._f.tell()

        def write(self, data):
            self._f.write(data[:5])
            raise OSError("disk full")

        def close(self):
            self._f.close()

    store._wal_f = _TornWriter(store._wal_f)
    with pytest.raises(OSError, match="disk full"):
        store.append(2, [(1, 2, 3)])
    assert store.wal_len == 1
    assert store.read_wal() == [(1, 1, 0, 1)]
    store.append(2, [(1, 2, 3)])
    assert store.read_wal() == [(1, 1, 0, 1), (2, 1, 2, 3)]
    store.close()


def test_fresh_service_refuses_dirty_store(tmp_path):
    svc = _svc([(0, 1), (1, 2), (0, 2)], tmp_path)
    svc.store.close()
    with pytest.raises(ValueError, match="restore"):
        _svc([(0, 1)], tmp_path)


# -- consistency model -------------------------------------------------------

def test_read_your_writes():
    svc = _svc([(0, 1), (1, 2), (0, 2)], flush_every=100)
    for a, b in [(0, 3), (1, 3), (2, 3)]:
        svc.submit(1, a, b)
    assert svc.gen == 0 and len(svc._pending) == 3
    resp = svc.handle(QueryRequest(MEMBERS, k=3))
    assert resp.gen == 1
    got = {tuple(e) for e in resp.edges}
    assert got == {(0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3)}
    assert svc.handle(QueryRequest(MAX_K, edge=(2, 3))).value == 4


def test_submit_validates_against_pending_view():
    svc = _svc([(0, 1)], flush_every=100)
    svc.submit(1, 0, 2)
    with pytest.raises(ValueError):
        svc.submit(1, 0, 2)
    svc.submit(0, 0, 2)
    with pytest.raises(ValueError):
        svc.submit(0, 0, 2)
    with pytest.raises(ValueError):
        svc.submit(1, 5, 5)
    svc.flush()
    assert svc.graph.phi_dict() == {(0, 1): 2}


def test_query_api_shapes():
    rng = np.random.default_rng(4)
    edges = _random_graph(rng, 0.4)
    svc = _svc(edges)
    orc = oracle.Oracle(N, edges)
    members = {tuple(e) for e in svc.k_truss_members(3)}
    assert members == orc.k_truss_edges(3)
    for (a, b), p in orc.phi.items():
        assert svc.max_k(a, b) == p
    absent = next((i, j) for i in range(N) for j in range(i + 1, N)
                  if (i, j) not in orc.phi)
    assert svc.max_k(*absent) == 0
    comps = _py_components(orc.phi, 3)
    for comp in comps:
        a, b = next(iter(comp))
        assert {tuple(e) for e in svc.community_of(3, edge=(a, b))} == comp
        assert {tuple(e) for e in svc.community_of(3, node=a)} == comp
    reps = svc.representatives(3)
    assert len(reps) == len(comps)
    assert {frozenset(c) for c in comps} == {
        next(c for c in comps if tuple(r) in c) for r in reps}
    k_hi = svc.graph.max_truss() + 1
    assert len(svc.community_of(k_hi, node=0)) == 0
    assert len(svc.representatives(k_hi)) == 0
    assert len(svc.k_truss_members(k_hi)) == 0
    # the non-indexed (recompute-per-query) baseline answers the same
    base = _svc(edges, indexed=False)
    assert {tuple(e) for e in base.representatives(3)} == {
        tuple(e) for e in reps}
    assert _service_components(base, 4) == _py_components(orc.phi, 4)


def test_handle_dispatch_and_validation():
    svc = _svc([(0, 1), (1, 2), (0, 2)])
    with pytest.raises(ValueError):
        QueryRequest("nope")
    with pytest.raises(ValueError):
        QueryRequest(COMMUNITY, k=3)
    with pytest.raises(ValueError):
        QueryRequest(MAX_K)
    assert svc.handle(QueryRequest(MAX_K, edge=(0, 1))).value == 3
    assert svc.handle(QueryRequest(REPRESENTATIVES, k=3)).n_edges == 1
    assert svc.handle(QueryRequest(COMMUNITY, k=3, node=0)).n_edges == 3
    ack = svc.handle_write(WriteRequest(op=1, a=0, b=3))
    assert ack.gen == svc.gen + 1
    assert svc.handle(QueryRequest(MAX_K, edge=(0, 3))).value == 2
    s = svc.stats()
    assert s["gen"] == svc.gen and s["n_edges"] == 4 and s["max_truss"] == 3
    assert s["memory"]["partition"] == "replicated"


def test_mesh_and_profiling_not_ported_yet(tmp_path):
    with pytest.raises(NotImplementedError, match="item 13"):
        TrussService(N, [(0, 1)], d_max=D_MAX, e_cap=E_CAP, mesh=object(),
                     device="cpu")
    with profiling.profile_region("flush"):
        pass  # not armed: a no-op
    try:
        profiling.configure(str(tmp_path / "prof"), max_traces=1)
        assert profiling.is_configured()
        svc = _svc([(0, 1), (1, 2), (0, 2)], flush_every=100)
        svc.submit(1, 0, 3)
        with pytest.raises(NotImplementedError, match="item 12"):
            svc.flush()
    finally:
        profiling.configure(None)
    assert not profiling.is_configured()
    assert svc.flush() == 1  # disarmed: the pending write commits


# -- satellites --------------------------------------------------------------

def test_snapshot_restores_stream_state(tmp_path):
    """The input stream's state rides in the snapshot and comes back from
    the port's restore; the stream then continues where it stopped."""
    edges = [(0, 1), (1, 2), (0, 2), (2, 3)]
    svc = _svc(edges, tmp_path, flush_every=3)
    stream = GraphUpdateStream(np.asarray(edges), N, chunk=3, seed=11)
    for _ in range(2):
        svc.submit_many([tuple(map(int, r)) for r in stream.next()])
    svc.snapshot(stream_state=stream.state_dict())
    expected = stream.next()
    del svc
    restored = _restore(tmp_path)
    s2 = GraphUpdateStream(np.asarray(edges), N, chunk=3, seed=11)
    s2.load_state_dict(restored.stream_state)
    assert np.array_equal(s2.next(), expected)
    ref = JS.TrussService.restore(JS.TrussStore(str(tmp_path)))
    assert {k: np.asarray(v).tolist() for k, v in ref.stream_state.items()} \
        == {k: np.asarray(v).tolist() for k, v in restored.stream_state.items()}


def test_representatives_cached_and_invalidated():
    rng = np.random.default_rng(5)
    edges = _random_graph(rng, 0.4)
    g = DynamicGraph(N, edges, d_max=D_MAX, e_cap=E_CAP, tracked_ks=(3,),
                     device="cpu")
    r1, l1 = g.index.query_representatives(g.state, 3)
    r2, l2 = g.index.query_representatives(g.state, 3)
    assert r1 is r2 and l1 is l2
    assert g.index.query(g.state, 3) is l1
    assert g.index.query_representatives(g.state, 3)[0] is r1
    if (0, 12) in set(map(tuple, edges)):
        g.delete(0, 12)
    else:
        g.insert(0, 12)
    r3, _ = g.index.query_representatives(g.state, 3)
    assert r3 is not r1
    fresh_rep, fresh_lab = representatives(g.spec, g.state, 3)
    assert torch.equal(r3, fresh_rep)
    assert torch.equal(g.index.query(g.state, 3), fresh_lab)


def test_defer_sync_returns_the_bound_or_none():
    """``apply_batch(defer_sync=True)``: the fused path hands back ``hi``
    as a 0-d int32 tensor on the graph's device and leaves the index to
    the caller; progressive and netted no-op batches return None."""
    rng = np.random.default_rng(8)
    edges = _random_graph(rng, 0.35)
    g = DynamicGraph(N, edges, d_max=D_MAX, e_cap=E_CAP, tracked_ks=(3,),
                     device="cpu")
    g.index.query(g.state, 3)
    stream = make_update_stream(np.asarray(edges), N, 12, seed=9)
    hi = g.apply_batch(stream, strategy="fused", defer_sync=True)
    assert isinstance(hi, torch.Tensor) and hi.dim() == 0
    assert hi.dtype == torch.int32 and hi.device == g.device
    assert 3 not in g.index._dirty  # invalidation left to the caller
    g.index.invalidate(2, max(int(hi), 1))
    assert g.apply_batch([(1, 0, 12), (0, 0, 12)] if (0, 12) not in g._present
                         else [(0, 0, 12), (1, 0, 12)], defer_sync=True) is None
    a, b = next((i, j) for i in range(N) for j in range(i + 1, N)
                if (i, j) not in g._present)
    assert g.apply_batch([(1, a, b)], strategy="progressive",
                         defer_sync=True) is None
    orc = oracle.Oracle(N, edges)
    orc.apply(list(stream) + [(1, a, b)])
    assert g.phi_dict() == orc.phi


# -- hypothesis-backed kill-point sweep --------------------------------------

try:
    from hypothesis import HealthCheck, given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    @settings(max_examples=12, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow,
                                     HealthCheck.function_scoped_fixture])
    @given(seed=st.integers(0, 10 ** 6), kill=st.integers(1, 24),
           snap_at=st.integers(0, 23), flush_every=st.integers(1, 9))
    def test_crash_recovery_property(seed, kill, snap_at, flush_every,
                                     tmp_path):
        """For arbitrary (kill point, snapshot point, batch size): restored
        state == oracle on the acked prefix, components as sets."""
        rng = np.random.default_rng(seed)
        edges = _random_graph(rng, 0.3)
        stream = make_update_stream(np.asarray(edges), N, 24, seed=seed % 997)
        root = tmp_path / f"h{seed}_{kill}_{snap_at}_{flush_every}"
        shutil.rmtree(root, ignore_errors=True)
        svc = _svc(edges, root, flush_every=flush_every)
        for i, rec in enumerate(stream[:kill]):
            svc.submit(*map(int, rec))
            if i == min(snap_at, kill - 1):
                svc.snapshot()
        svc.store.close()
        del svc
        restored = _restore(root, flush_every=flush_every)
        orc = oracle.Oracle(N, edges)
        orc.apply(stream[:kill])
        _assert_matches_oracle(restored, orc)
