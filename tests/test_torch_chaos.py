"""The port's chaos plane on the CPU: a sampled twin of
``tests/test_chaos.py`` (that file alone takes about a minute).

Sampled: the seeded I/O fault schedules run for two of the reference's
five workload seeds (one serial, one pipelined), ten schedules each, and
the device-side peel schedules for six of its twelve.  Whole: the CRC32C
check value, every single-bit flip of a WAL record and of the compaction
header (each classified as the reference classifies it), the retry policy
and circuit breaker (the same jitter sequence as the reference's under
one seed), the dir-fsync journal, a missing or corrupt ``commit.json``,
and the degradation ladder: delta -> recompute fallback, quarantine ->
degrade -> recover, a lost landing -> self-heal, an I/O outage, and
snapshot rot -> ``.prev``.

The cluster and router cases wait for the cluster's port (ROADMAP item
11).
"""
import io as std_io
import os
import time

import numpy as np
import pytest
import torch

import repro.faults as JF
import repro_torch.faults as TF
from repro.core import oracle
from repro.data.streams import READ, MixedWorkloadStream, make_update_stream
from repro.service.store import TrussStore as JStore
from repro_torch.faults import (CircuitBreaker, Fault, FaultyIO, PeelChaos,
                                RetryExhausted, RetryPolicy, crc32c, flip_bit,
                                seeded_schedule)
from repro_torch.service import (MEMBERS, Overloaded, QueryRequest,
                                 TrussService, TrussStore)

N = 13
D_MAX = 16
E_CAP = 160
KS = (3, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _svc(edges, store=None, **kw):
    kw.setdefault("tracked_ks", KS)
    return TrussService(N, edges, d_max=D_MAX, e_cap=E_CAP, store=store,
                        device="cpu", **kw)


def _restore(store, **kw):
    return TrussService.restore(store, device="cpu", **kw)


def _random_graph(rng, p, n=N):
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def _oracle_phi(edges, recs):
    orc = oracle.Oracle(N, edges)
    orc.apply([tuple(int(x) for x in r) for r in recs])
    return orc.phi


def _workload(edges, seed, n_writes=14):
    wl = MixedWorkloadStream(edges, N, chunk=6, read_frac=0.25, ks=KS,
                             seed=seed)
    recs = []
    while sum(1 for r in recs if r[0] != READ) < n_writes:
        recs.extend(wl.next())
    return recs


# -- the seeded-schedule sweep (sampled) ---------------------------------------

def _drive_one_schedule(root, edges, workload, seed, pipeline=False):
    """One chaos run: drive the workload under an injected fault schedule,
    crash, recover, and check zero acked-write loss below the frontier,
    the oracle on the surviving log, and quarantine accounting."""
    fio = FaultyIO()
    store = TrussStore(str(root), io=fio)
    svc = _svc(edges, store, flush_every=4, pipeline=pipeline)
    fio.inject(*seeded_schedule(seed, n_faults=2, at_range=(0, 12)))

    acked = []
    for rec in workload:
        if rec[0] == READ:
            try:
                svc.handle_committed(QueryRequest(MEMBERS, k=3))
            except Exception:
                pass
            continue
        op, a, b = int(rec[1]), int(rec[2]), int(rec[3])
        try:
            ack = svc.submit(op, a, b)
        except (OSError, ValueError):
            continue
        if isinstance(ack, Overloaded):
            continue
        acked.append((store.wal_len - 1, op, a, b))
    try:
        svc.flush()
    except Exception:
        pass
    store.close()
    del svc

    rec_store = TrussStore(str(root))
    commit = rec_store.read_commit()
    frontier = 0 if commit is None else int(commit["wal_len"])
    survivors = rec_store.read_wal(0)
    restored = _restore(rec_store, flush_every=4)
    for idx, op, a, b in acked:
        if idx < frontier:
            assert idx < len(survivors), (seed, idx, frontier)
            assert survivors[idx][1:] == (op, a, b), (seed, idx)
    assert restored.graph.phi_dict() == _oracle_phi(
        edges, [r[1:] for r in survivors]), seed
    for q in rec_store.read_quarantine():
        if q["kind"] == "wal-bytes":
            assert q["start_index"] >= frontier, (seed, q)
    report = restored.scrub()
    assert report["ok"], (seed, report)
    return fio.injected


@pytest.mark.parametrize("wl_seed", [0, 3])
def test_seeded_fault_schedules_recover_exact(wl_seed, tmp_path):
    """Ten of the reference's forty schedules per workload seed: seed 0
    runs serial ingest, seed 3 pipelined (as in the reference)."""
    rng = np.random.default_rng(wl_seed)
    edges = _random_graph(rng, 0.3)
    workload = _workload(edges, wl_seed)
    fired = {}
    for s in range(0, 40, 4):
        for kind, n in _drive_one_schedule(
                tmp_path / f"c{s}", edges, workload, seed=wl_seed * 1000 + s,
                pipeline=wl_seed >= 3).items():
            fired[kind] = fired.get(kind, 0) + n
    assert sum(fired.values()) > 0, "no scheduled fault fired"


def test_seeded_schedules_equal_the_reference():
    for seed in (0, 7, 3001):
        assert [tuple(vars(f).values()) for f in seeded_schedule(seed, 3)] == [
            tuple(vars(f).values()) for f in JF.seeded_schedule(seed, 3)]


def test_peel_chaos_schedules_recover_exact(tmp_path):
    rng = np.random.default_rng(77)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 16, seed=78)
    for s in range(0, 12, 2):
        srng = np.random.default_rng(900 + s)
        gens = sorted(set(int(g) for g in srng.integers(1, 5, size=2)))
        chaos = (PeelChaos(dispatch_gens=gens) if s % 4 == 0
                 else PeelChaos(land_gens=gens[:1]))
        root = str(tmp_path / f"p{s}")
        svc = _svc(edges, TrussStore(root), flush_every=4,
                   pipeline=(s % 3 == 0), chaos=chaos)
        for rec in stream:
            svc.submit(*map(int, rec))
        svc.flush()
        svc.store.close()
        del svc
        restored = _restore(TrussStore(root), flush_every=4)
        survivors = [r[1:] for r in restored.store.read_wal(0)]
        assert restored.graph.phi_dict() == _oracle_phi(edges, survivors), s
        assert restored.scrub()["ok"], s


# -- checksums ----------------------------------------------------------------

def test_crc32c_check_value():
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
    assert crc32c(b"truss") != crc32c(b"trust")
    data = bytes(range(256)) * 3
    assert crc32c(data) == JF.crc32c(data)
    assert crc32c(data[100:], crc32c(data[:100])) == crc32c(data)


def _flips(line: bytes):
    for bit in range(len(line) * 8):
        corrupt = bytearray(line)
        corrupt[bit // 8] ^= 1 << (bit % 8)
        for ln in std_io.BytesIO(bytes(corrupt)).readlines():
            if ln.endswith(b"\n"):  # a torn tail is truncated, never parsed
                yield bit, ln


def test_wal_v2_detects_every_single_bit_flip(tmp_path):
    """Every bit of a v2 record: each complete corrupted line reads corrupt
    in the port, as in the reference — never as another valid record."""
    store = TrussStore(str(tmp_path / "s"))
    line = store._encode(3, 1, 7, 11)
    assert line == JStore(str(tmp_path / "j"))._encode(3, 1, 7, 11)
    n = 0
    for bit, ln in _flips(line):
        assert TrussStore._classify(ln) == ("corrupt", None), (bit, ln)
        assert JStore._classify(ln) == ("corrupt", None), (bit, ln)
        n += 1
    assert n >= len(line) * 8 - 8


def test_compaction_header_detects_single_bit_flips(tmp_path):
    store = TrussStore(str(tmp_path / "s"))
    hdr = store._encode_header(42)
    assert TrussStore._parse_header(hdr) == 42
    for bit, ln in _flips(hdr):
        parsed = TrussStore._parse_header(ln)
        assert parsed in ("corrupt", None), (bit, ln)
        assert parsed == JStore._parse_header(ln), (bit, ln)


# -- retry / breaker ----------------------------------------------------------

def test_retry_policy_deterministic_capped_and_equal_to_reference():
    def mk(pkg, log):
        return pkg.RetryPolicy(max_attempts=6, base_ms=1.0, cap_ms=8.0,
                               seed=42, sleep=log.append, clock=lambda: 0.0)
    s1, s2, ref = [], [], []
    assert list(mk(JF, ref).attempts()) == list(mk(TF, s1).attempts())
    list(mk(TF, s2).attempts())
    assert s1 == s2 == ref and len(s1) == 5
    assert all(0.001 <= d <= 0.008 for d in s1)


def test_retry_policy_deadline_and_last_error():
    t = [0.0]
    p = RetryPolicy(max_attempts=50, base_ms=10.0, cap_ms=10.0,
                    deadline_s=0.035, seed=0,
                    sleep=lambda s: t.__setitem__(0, t[0] + s),
                    clock=lambda: t[0])
    n = sum(1 for _ in p.attempts())
    assert 2 <= n < 50 and t[0] <= 0.035
    calls = []

    def boom():
        calls.append(1)
        raise OSError(5, "injected")

    p = RetryPolicy(max_attempts=3, base_ms=0.01, cap_ms=0.01,
                    sleep=lambda s: None)
    with pytest.raises(RetryExhausted) as ei:
        p.call(boom)
    assert len(calls) == 3 and isinstance(ei.value.__cause__, OSError)


def test_circuit_breaker_state_machine():
    t = [0.0]
    br = CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                        clock=lambda: t[0])
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed" and br.failures == 1
    br.record_failure()
    assert br.state == "open" and br.trips == 1 and br.state_code == 2
    assert not br.allow()
    t[0] = 1.5
    assert br.allow() and br.state == "half_open"
    br.record_failure()
    assert br.state == "open" and br.trips == 2
    t[0] = 3.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.failures == 0 and br.allow()


# -- dir-fsync ordering --------------------------------------------------------

def _fsynced_later(journal, i, *targets):
    return any(op == "fsync_path" and tgt in targets
               for op, tgt, _ in journal[i + 1:])


def test_dir_fsync_follows_truncation_and_rotation(tmp_path):
    rng = np.random.default_rng(5)
    edges = _random_graph(rng, 0.3)
    root = str(tmp_path / "s")
    fio = FaultyIO()
    svc = _svc(edges, TrussStore(root, io=fio), flush_every=3)
    stream = make_update_stream(np.asarray(edges), N, 9, seed=6)
    svc.submit_many([tuple(map(int, r)) for r in stream])
    svc.snapshot()
    svc.store.close()
    del svc
    with open(os.path.join(root, "wal.log"), "ab") as f:
        f.write(b"7 1 3")
    fio2 = FaultyIO()
    TrussStore(root, io=fio2).close()

    wal = os.path.join(root, "wal.log")
    snap = os.path.join(root, "snapshot.npz")
    for journal in (fio.journal, fio2.journal):
        for i, (op, target, _) in enumerate(journal):
            if op == "truncate" and target == wal:
                assert _fsynced_later(journal, i, wal), journal[i:]
                assert _fsynced_later(journal, i, root), journal[i:]
            if op == "replace" and target in (wal, snap):
                assert _fsynced_later(journal, i, root), journal[i:]
    assert any(op == "truncate" for op, _, _ in fio2.journal)
    assert any(op == "replace" and t in (wal, snap)
               for op, t, _ in fio.journal)


# -- recovery corner cases ----------------------------------------------------

def _run_and_close(root, edges, stream, flush_every=4):
    svc = _svc(edges, TrussStore(str(root)), flush_every=flush_every)
    svc.submit_many([tuple(map(int, r)) for r in stream])
    svc.flush()
    svc.store.close()
    del svc


@pytest.mark.parametrize("damage", ["missing", "torn"])
def test_restore_with_missing_or_corrupt_commit_sidecar(damage, tmp_path):
    rng = np.random.default_rng(21)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 12, seed=22)
    _run_and_close(tmp_path, edges, stream)
    if damage == "missing":
        os.remove(tmp_path / "commit.json")
    else:
        with open(tmp_path / "commit.json", "w") as f:
            f.write('{"gen": 3, "wal_')
    restored = _restore(TrussStore(str(tmp_path)))
    assert restored.graph.phi_dict() == _oracle_phi(edges, stream)


# -- graceful degradation -----------------------------------------------------

def _submit_all(svc, stream):
    acked = []
    for rec in stream:
        ack = svc.submit(*map(int, rec))
        if not isinstance(ack, Overloaded):
            acked.append(tuple(map(int, rec)))
    return acked


def test_peel_fault_falls_back_to_recompute(tmp_path):
    rng = np.random.default_rng(61)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 8, seed=62)
    chaos = PeelChaos(dispatch_gens=[1, 2])
    svc = _svc(edges, TrussStore(str(tmp_path / "s")), flush_every=4,
               chaos=chaos)
    fallbacks = svc.stats()["counters"]["engine_fallbacks"]
    _submit_all(svc, stream)
    svc.flush()
    s = svc.stats()
    assert s["degraded"] is None and s["breaker"]["state"] == "closed"
    assert s["counters"]["engine_fallbacks"] - fallbacks == 2
    assert s["quarantined_gens"] == [] and chaos.injected == 2
    assert svc.graph.phi_dict() == _oracle_phi(edges, stream)


def test_poisoned_generation_quarantines_degrades_then_recovers(tmp_path):
    rng = np.random.default_rng(63)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 10, seed=64)
    chaos = PeelChaos(fail_all=True, engines=("auto", "recompute", "fused"))
    br = CircuitBreaker(failure_threshold=3, cooldown_s=0.01)
    svc = _svc(edges, TrussStore(str(tmp_path / "s")), flush_every=4,
               chaos=chaos, breaker=br)
    baseline = svc.handle_committed(QueryRequest(MEMBERS, k=3)).n_edges
    acked = _submit_all(svc, stream)
    svc.flush()
    s = svc.stats()
    assert s["degraded"] == "poisoned"
    assert s["breaker"]["state"] == "open"
    assert s["quarantined_gens"], s
    assert any(q["kind"] == "generation" and q["status"] == "quarantined"
               for q in svc.store.read_quarantine())
    assert svc.handle_committed(
        QueryRequest(MEMBERS, k=3)).n_edges == baseline
    shed = svc.submit(1, 0, 5)
    assert isinstance(shed, Overloaded) and shed.reason == "poisoned"

    chaos.clear()
    time.sleep(0.02)
    svc.flush()
    s = svc.stats()
    assert s["degraded"] is None and s["breaker"]["state"] == "closed"
    assert s["quarantined_gens"] == []
    assert any(q["kind"] == "generation" and q["status"] == "recovered"
               for q in svc.store.read_quarantine())
    assert svc.graph.phi_dict() == _oracle_phi(edges, acked)


def test_lost_landing_self_heals_from_store(tmp_path):
    """A generation lost at its landing forces the reload-and-replay
    self-heal; the healed state is bitwise-equal to a fault-free twin."""
    rng = np.random.default_rng(65)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 12, seed=66)
    chaos = PeelChaos(land_gens=[2])
    svc = _svc(edges, TrussStore(str(tmp_path / "s")), flush_every=4,
               pipeline=True, chaos=chaos,
               breaker=CircuitBreaker(cooldown_s=0.01))
    heals = svc.stats()["counters"]["self_heals"]
    acked = _submit_all(svc, stream)
    time.sleep(0.02)
    svc.flush()
    time.sleep(0.02)
    svc.flush()
    s = svc.stats()
    assert s["counters"]["self_heals"] - heals >= 1
    assert svc.graph.phi_dict() == _oracle_phi(edges, acked)
    twin = _svc(edges, flush_every=4, pipeline=True)
    _submit_all(twin, acked)
    twin.flush()
    for name, x, y in zip(svc.graph.state._fields, svc.graph.state,
                          twin.graph.state):
        assert np.array_equal(x.numpy(), y.numpy()), name


def test_io_outage_sheds_writes_serves_reads_then_recovers(tmp_path):
    rng = np.random.default_rng(67)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 8, seed=68)
    fio = FaultyIO()
    store = TrussStore(str(tmp_path / "s"), io=fio)
    svc = _svc(edges, store, flush_every=4,
               breaker=CircuitBreaker(failure_threshold=2, cooldown_s=0.01),
               retry=RetryPolicy(max_attempts=2, base_ms=0.01, cap_ms=0.01,
                                 scope="fsync"))
    fio.inject(Fault("fsync_eio", at=0, sticky=True))
    acked = _submit_all(svc, stream)
    try:
        svc.flush()
    except OSError:
        pass
    s = svc.stats()
    assert s["degraded"] == "io" and s["breaker"]["state"] == "open"
    shed = svc.submit(1, 0, 5)
    assert isinstance(shed, Overloaded) and shed.reason == "io"
    svc.handle_committed(QueryRequest(MEMBERS, k=3))

    fio.clear()
    time.sleep(0.02)
    svc.flush()
    s = svc.stats()
    assert s["degraded"] is None and s["breaker"]["state"] == "closed"
    assert svc.graph.phi_dict() == _oracle_phi(edges, acked)


def test_scrub_detects_snapshot_rot_and_restore_falls_back(tmp_path):
    rng = np.random.default_rng(71)
    edges = _random_graph(rng, 0.3)
    stream = make_update_stream(np.asarray(edges), N, 12, seed=72)
    root = str(tmp_path / "s")
    svc = _svc(edges, TrussStore(root), flush_every=4)
    svc.submit_many([tuple(map(int, r)) for r in stream[:8]])
    svc.snapshot()
    svc.submit_many([tuple(map(int, r)) for r in stream[8:]])
    svc.flush()
    assert svc.scrub(deep=True)["ok"]
    svc.store.close()
    del svc

    flip_bit(os.path.join(root, "snapshot.npz"), 12345)
    audit = TrussStore(root, readonly=True)
    rep = audit.scrub()
    assert not rep["ok"] and rep["snapshot"]["verified"] is False
    assert JStore(root, readonly=True).scrub()["snapshot"]["verified"] is False

    restored = _restore(TrussStore(root))
    assert restored.graph.phi_dict() == _oracle_phi(edges, stream)
    assert any(n.startswith("snapshot.npz.corrupt")
               for n in os.listdir(os.path.join(root, "quarantine")))
