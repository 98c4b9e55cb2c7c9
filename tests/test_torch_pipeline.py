"""The port's pipelined ingest (``TrussService(pipeline=True)``) on the
CPU: twins of ``tests/test_pipeline.py``'s service cases.

The three invariants the pipeline must keep: **acked-before-applied**
(every acked record is WAL-durable before its batch runs; a shed write
leaves no trace), **commit-after-land** (``commit.json`` advances only
when a generation has landed) and **reads-at-boundaries** (a query drains
first; ``handle_committed`` waits only for the in-flight generation).
On the CPU a dispatched generation has landed when ``apply_batch``
returns, so the tests that need one in flight hold the opportunistic
landing back, as the reference's overload test does.

The router and replica cases wait for the cluster's port (ROADMAP item
11).
"""
import numpy as np
import pytest
import torch

from repro.core import oracle
from repro.data.streams import make_update_stream
from repro_torch.service import (MEMBERS, Overloaded, QueryRequest,
                                 TrussService, TrussStore, WriteAck)

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
    kw.setdefault("pipeline", True)
    return TrussService(N, edges, d_max=D_MAX, e_cap=E_CAP, store=store,
                        device="cpu", **kw)


def _random_graph(rng, p, n=N):
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def _submit_all(svc, stream):
    """Drive a stateful stream, retrying shed writes (a shed record cannot
    be skipped: later stream records assume it applied)."""
    for rec in stream:
        while True:
            ack = svc.submit(*map(int, rec))
            if isinstance(ack, WriteAck):
                break
            svc.flush()


def _hold_landings(svc):
    """Refuse opportunistic (non-blocking) landings, so a dispatched
    generation stays in flight until a blocking wait."""
    real = svc._complete
    svc._complete = lambda wait=True: real(wait) if wait else False
    return real


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipelined_matches_oracle(seed, tmp_path):
    rng = np.random.default_rng(seed)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 40, seed=seed + 30)
    svc = _svc(edges, tmp_path, flush_every=5)
    _submit_all(svc, stream)
    svc.flush()
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    assert svc.graph.phi_dict() == orc.phi
    assert svc._applied_wal == svc.store.wal_len


@pytest.mark.parametrize("seed", [0, 1])
def test_pipelined_submit_many_matches_oracle(seed, tmp_path):
    rng = np.random.default_rng(seed)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 40, seed=seed + 40)
    svc = _svc(edges, tmp_path, flush_every=5)
    acks = svc.submit_many([tuple(map(int, r)) for r in stream])
    assert len(acks) == len(stream)
    assert all(isinstance(a, WriteAck) for a in acks)
    svc.flush()
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    assert svc.graph.phi_dict() == orc.phi


def test_reads_wait_for_inflight_only(tmp_path):
    """``handle_committed`` lands the in-flight generation but leaves
    sealed and open generations queued."""
    rng = np.random.default_rng(3)
    edges = _random_graph(rng, 0.35)
    svc = _svc(edges, tmp_path, flush_every=4, strategy="fused",
               max_pending=64)
    real = _hold_landings(svc)
    stream = make_update_stream(np.asarray(edges), N, 10, seed=50)
    _submit_all(svc, stream)
    assert svc._inflight is not None and svc._pending
    queued = list(svc._pending)
    commit_before = svc.store.read_commit()["wal_len"]
    assert commit_before < svc.store.wal_len  # commit-after-land
    resp = svc.handle_committed(QueryRequest(MEMBERS, k=3))
    assert svc._inflight is None
    assert svc._pending == queued          # nothing new dispatched
    assert resp.gen == svc.gen
    assert svc.store.read_commit()["wal_len"] == svc._applied_wal
    svc._complete = real
    svc.flush()
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    assert svc.graph.phi_dict() == orc.phi


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pipelined_crash_recovery_randomized_kill_points(seed, tmp_path):
    rng = np.random.default_rng(seed)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 40, seed=seed + 60)
    kill = int(rng.integers(1, len(stream)))
    snap_at = int(rng.integers(0, kill))

    svc = _svc(edges, tmp_path / f"s{seed}", flush_every=5, max_pending=128)
    for i, rec in enumerate(stream[:kill]):
        _submit_all(svc, [rec])
        if i == snap_at:
            svc.snapshot()
    del svc

    restored = TrussService.restore(TrussStore(str(tmp_path / f"s{seed}")),
                                    flush_every=5, pipeline=True, device="cpu")
    orc = oracle.Oracle(N, edges)
    orc.apply(stream[:kill])
    assert restored.graph.phi_dict() == orc.phi
    _submit_all(restored, stream[kill:])
    restored.flush()
    orc.apply(stream[kill:])
    assert restored.graph.phi_dict() == orc.phi


def test_crash_mid_overlap_discards_inflight_replays_acked(tmp_path):
    """Crash with a fused generation dispatched and not landed (commit.json
    behind the WAL tail): restore replays every acked record."""
    rng = np.random.default_rng(5)
    edges = _random_graph(rng, 0.35)
    stream = make_update_stream(np.asarray(edges), N, 24, seed=70)
    svc = _svc(edges, tmp_path, flush_every=8, strategy="fused",
               max_pending=128)
    _hold_landings(svc)
    _submit_all(svc, stream)
    assert svc._inflight is not None, "kill point must be mid-overlap"
    committed_before = svc.gen
    wal_len = svc.store.wal_len
    assert svc._applied_wal < wal_len
    del svc

    restored = TrussService.restore(TrussStore(str(tmp_path)),
                                    flush_every=8, strategy="fused",
                                    pipeline=True, device="cpu")
    assert restored.gen >= committed_before
    assert restored._applied_wal == wal_len
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    assert restored.graph.phi_dict() == orc.phi


def test_overload_sheds_without_acking(tmp_path):
    rng = np.random.default_rng(9)
    edges = _random_graph(rng, 0.2)
    svc = _svc(edges, tmp_path, flush_every=8, strategy="fused",
               max_pending=8)
    present = set(svc._view)
    pool = [(a, b) for a in range(N) for b in range(a + 1, N)
            if (a, b) not in present]
    rng.shuffle(pool)
    real = _hold_landings(svc)
    shed = 0
    peak = 0
    for a, b in pool[:80]:
        wal_before = svc.store.wal_len
        view_before = set(svc._view)
        ack = svc.submit(1, a, b)
        peak = max(peak, len(svc._pending))
        if isinstance(ack, Overloaded):
            shed += 1
            assert ack.retry_after_ms > 0 and ack.reason == "overload"
            assert svc.store.wal_len == wal_before
            assert svc._view == view_before
        else:
            present.add((a, b))
    assert peak <= 8
    assert shed > 0 and svc.overloaded == shed
    assert svc.stats()["pipeline"]["overloaded"] == shed
    svc._complete = real
    svc.flush()
    assert set(svc.graph.phi_dict()) == present


def test_adaptive_target_grows_and_stays_bounded(tmp_path):
    rng = np.random.default_rng(11)
    edges = _random_graph(rng, 0.3)
    svc = _svc(edges, tmp_path, flush_every=4, strategy="fused",
               target_p99_ms=0.01, max_pending=64)
    stream = make_update_stream(np.asarray(edges), N, 120, seed=80)
    _submit_all(svc, stream)
    svc.flush()
    assert 1 <= svc._flush_target <= svc.max_pending
    assert svc._flush_target > 4, "target should grow past flush_every"
    assert svc.stats()["pipeline"]["ewma_gen_ms"] is not None


def test_restore_preserves_pipeline_config(tmp_path):
    rng = np.random.default_rng(17)
    edges = _random_graph(rng, 0.3)
    svc = _svc(edges, tmp_path, flush_every=4)
    svc.snapshot()
    del svc
    restored = TrussService.restore(TrussStore(str(tmp_path)),
                                    pipeline=True, target_p99_ms=25.0,
                                    max_pending=32, device="cpu")
    assert restored.pipeline and restored.max_pending == 32
    assert restored.target_p99_ms == 25.0
    assert restored.stats()["pipeline"]["flush_target"] <= 32
    serial = TrussService.restore(TrussStore(str(tmp_path)), device="cpu")
    assert serial.pipeline is False
    assert isinstance(serial.submit(1, 0, 12) if (0, 12) not in serial._view
                      else serial.submit(0, 0, 12), WriteAck)


def test_restore_opens_the_generation_after_the_replayed_tail(tmp_path):
    """A pipelined restore over a replayed WAL tail acks its next write in
    the generation after the committed one (``repro`` tags it after the
    snapshot's generation instead: ROADMAP R4)."""
    rng = np.random.default_rng(19)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 24, seed=90)
    svc = _svc(edges, tmp_path, flush_every=4, pipeline=False)
    svc.submit_many([tuple(map(int, r)) for r in stream[:12]])
    svc.flush()
    svc.store.close()
    restored = TrussService.restore(TrussStore(str(tmp_path)), flush_every=4,
                                    pipeline=True, device="cpu")
    assert restored.gen == 3 and restored.replayed_records == 12
    acks = [restored.submit(*map(int, r)) for r in stream[12:]]
    assert [a.gen for a in acks] == [4] * 4 + [5] * 4 + [6] * 4
    restored.flush()
    assert restored.gen == 6
    orc = oracle.Oracle(N, edges)
    orc.apply(stream)
    assert restored.graph.phi_dict() == orc.phi
