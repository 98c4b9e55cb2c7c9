"""The port's CUDA kernels on the card: each held against its plain PyTorch
version (K1/K2 bitwise, K3, K4 and K5 within stated tolerances), and the
truss engine, the LM prefill and the xDeepFM scores on the card equal to
the same on the CPU; the sharded truss engines (every shard on the
card) equal to mesh=None; the WAL-backed truss service on the card launching
K1 through a fused flush and K2 through its recompute fallback, and its
snapshots restoring bitwise; a replica on the card tailing such a
primary (K1 in its applies, bitwise equal at every generation), its
promotion, and a profiled flush with every device record; the GNN
family's differentiable segment sum (K4 forward, a plain gather backward)
and one training step of each GNN smoke config against the plain route;
the LM and recsys training entries (K3, K4's gathered entry and K5 as
autograd Functions with plain backwards) and one training step of the
qwen3 and xDeepFM smoke configs against the plain route; the MoE layer of
both MoE smoke configs on the card against the CPU at matched routing, and
the int8 KV cache's values and scales on the card equal to the CPU's; the
expert block's mesh branches and their gradients against mesh=None, and
one mixtral smoke training step on the card against the CPU at matched
routing, keyed by layer under the remat.

These tests need a CUDA device and ``nvcc`` and skip elsewhere; run them on
the machine with the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
They import neither JAX nor ``repro``.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.data.synthetic import ClickStream
from repro_torch.kernels import (bitmap_support, cin, flash_attention, ops,
                                 peel_wave, ref, segment_matmul)
from repro_torch.faults import PeelChaos
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.cluster import Replica
from repro_torch.data import sampler
from repro_torch.models import gnn, recsys, transformer
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            make_train_step, tree_leaves,
                                            value_and_grad)
from repro_torch.obs import profiling
from repro_torch.service import TrussService, TrussStore

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1), (7, 3), (64, 32), (130, 37), (513, 129)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, shape, device):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    w[rng.random(shape) < 0.25] |= np.uint32(1 << 31)
    return torch.from_numpy(w.view(np.int32)).to(device)


@pytest.mark.parametrize("e,w", SHAPES)
def test_kernels_equal_plain_versions(cuda, e, w):
    rng = np.random.default_rng(e * 1000 + w)
    a, b = _words(rng, (e, w), cuda), _words(rng, (e, w), cuda)
    alive = torch.from_numpy(rng.random(e) < 0.8).to(cuda)
    n1, n2 = peel_wave.LAUNCHES, bitmap_support.LAUNCHES
    assert torch.equal(ops.bitmap_support(a, b), ref.bitmap_support_ref(a, b))
    for k in (2, 3, 7):
        for g, x in zip(ops.peel_wave(a, b, alive, k),
                        ref.peel_wave_ref(a, b, alive, k)):
            assert torch.equal(g, x)
    wo, wc = w // 3, max(1, w // 2)
    assert torch.equal(
        ops.bitmap_support(a, b, word_offset=wo, word_count=wc),
        ref.bitmap_support_ref(a[:, wo:wo + wc], b[:, wo:wo + wc]))
    eu = torch.from_numpy(rng.integers(0, e, 3 * e).astype(np.int32)).to(cuda)
    ev = torch.from_numpy(rng.integers(0, e, 3 * e).astype(np.int32)).to(cuda)
    al = torch.from_numpy(rng.random(3 * e) < 0.7).to(cuda)
    for g, x in zip(ops.peel_wave_gathered(a, eu, ev, al, 4),
                    ref.peel_wave_gathered_ref(a, eu, ev, al, 4)):
        assert torch.equal(g, x)
    assert torch.equal(ops.bitmap_support_gathered(a, eu, ev),
                       ref.bitmap_support_gathered_ref(a, eu, ev))
    torch.cuda.synchronize()
    assert peel_wave.LAUNCHES - n1 == 4 and bitmap_support.LAUNCHES - n2 == 3


def test_kernel_rejects_out_of_range_rows(cuda):
    bm = torch.zeros((10, 4), dtype=torch.int32, device=cuda)
    eu = torch.tensor([0, 10], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.bitmap_support_gathered(bm, eu, eu)


# the digest body of K1/K2: bitwise against the plain version and the
# direct body, with the capacity forced small so that every branch runs

def _digest_cases(rng, device):
    """A bitmap whose rows are empty, at C and C + 1 nonzero words for the
    capacities below, dense and random (bit 31 set in a quarter of the
    words, odd width so rows alternate 8-byte alignment, the base 4 bytes
    past an 8-byte boundary), and slots with u == v and sentinel-like
    repeats of the last row."""
    n, w = 300, 37
    flat = _words(rng, (n * w + 1,), device)
    bm = flat[1:].view(n, w)                    # base 4 bytes off alignment
    bm[torch.from_numpy(rng.random((n, w)) < 0.6).to(device)] = 0
    bm[0] = 0
    for row, cnt in enumerate((1, 2, 2, 3, 8, 9, 36, 37), start=1):
        bm[row] = 0
        cols = torch.from_numpy(rng.choice(w, cnt, replace=False)).to(device)
        bm[row, cols] = _words(rng, (cnt,), device) | -(2**31)   # bit 31
    eu = rng.integers(0, n, 2000)
    ev = rng.integers(0, n, 2000)
    eu[:64], ev[:64] = np.arange(64) % 10, np.arange(64) % 9  # crafted rows
    eu[64:96] = ev[64:96] = np.arange(32) % 10                # u == v
    eu[96:200] = ev[96:200] = n - 1                           # sentinels
    ids = [torch.from_numpy(x.astype(np.int32)).to(device) for x in (eu, ev)]
    return bm, ids[0], ids[1]


def _powerlaw_bitmap(n, device):
    edges = powerlaw_graph(n, 5, seed=0)
    spec = core.GraphSpec(n, d_max=2 * int(np.bincount(edges.reshape(-1)).max()),
                          e_cap=len(edges) + 64)
    st = core.from_edge_list(spec, edges, device)
    bm = core.build_bitmap(spec, st, st.active)
    eu = torch.clamp(st.edges[:, 0], max=n - 1).contiguous()
    ev = torch.clamp(st.edges[:, 1], max=n - 1).contiguous()
    return bm, eu, ev


@pytest.mark.parametrize("graph", ["crafted", "powerlaw4000"])
@pytest.mark.parametrize("capacity", [1, 2, 8, None])
def test_digest_body_equals_plain_and_direct(cuda, graph, capacity):
    rng = np.random.default_rng(7)
    bm, eu, ev = (_digest_cases(rng, cuda) if graph == "crafted"
                  else _powerlaw_bitmap(4000, cuda))
    e = eu.shape[0]
    body = dict(capacity=capacity)
    n1, n2 = dict(peel_wave.LAUNCHES_BY_BODY), dict(bitmap_support.LAUNCHES_BY_BODY)
    got = bitmap_support.bitmap_support_cuda(bm, bm, eu, ev, **body)
    assert torch.equal(got, ref.bitmap_support_gathered_ref(bm, eu, ev))
    assert torch.equal(got, bitmap_support.bitmap_support_cuda(
        bm, bm, eu, ev, body="direct"))
    w = bm.shape[1]
    for wo, wc in ((5, 20), (w - 1, 1), (w // 3, w // 2), (0, 0)):
        got = bitmap_support.bitmap_support_cuda(bm, bm, eu, ev, wo, wc, **body)
        assert torch.equal(got, ref.bitmap_support_gathered_ref(
            bm[:, wo:wo + wc], eu, ev))
    masks = (torch.from_numpy(rng.random(e) < 0.5).to(cuda),
             torch.from_numpy(rng.random(e) < 0.01).to(cuda),
             torch.ones(e, dtype=torch.bool, device=cuda),
             torch.zeros(e, dtype=torch.bool, device=cuda))
    for alive in masks:
        for k in (2, 3, 7):
            got = peel_wave.peel_wave_cuda(bm, bm, alive, k, eu, ev, **body)
            for g, x, y in zip(got,
                               ref.peel_wave_gathered_ref(bm, eu, ev, alive, k),
                               peel_wave.peel_wave_cuda(bm, bm, alive, k, eu, ev,
                                                        body="direct")):
                assert torch.equal(g, x) and torch.equal(g, y)
    torch.cuda.synchronize()
    assert peel_wave.LAUNCHES_BY_BODY["digest"] - n1["digest"] == 12
    assert peel_wave.LAUNCHES_BY_BODY["direct"] - n1["direct"] == 12
    assert bitmap_support.LAUNCHES_BY_BODY["digest"] - n2["digest"] == 5
    assert bitmap_support.LAUNCHES_BY_BODY["direct"] - n2["direct"] == 1


def test_gathered_entries_run_the_digest_body(cuda):
    """The truss path's entries launch the digest body, the rows entries
    the direct body; ``LAUNCHES`` counts every wrapper call."""
    rng = np.random.default_rng(3)
    bm, eu, ev = _digest_cases(rng, cuda)
    alive = torch.from_numpy(rng.random(eu.shape[0]) < 0.7).to(cuda)
    counts = [(m.LAUNCHES, dict(m.LAUNCHES_BY_BODY))
              for m in (peel_wave, bitmap_support)]
    ops.peel_wave_gathered(bm, eu, ev, alive, 4)
    ops.bitmap_support_gathered(bm, eu, ev, word_offset=3, word_count=30)
    ra, rb = bm[eu.long()], bm[ev.long()]
    ops.peel_wave(ra, rb, alive, 4)
    ops.bitmap_support(ra, rb)
    torch.cuda.synchronize()
    for m, (n, by_body) in zip((peel_wave, bitmap_support), counts):
        assert m.LAUNCHES - n == 2
        assert m.LAUNCHES_BY_BODY["digest"] - by_body["digest"] == 1
        assert m.LAUNCHES_BY_BODY["direct"] - by_body["direct"] == 1


def test_digest_body_rejects_what_it_does_not_take(cuda):
    bm = torch.zeros((10, 4), dtype=torch.int32, device=cuda)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):          # two bitmaps
        bitmap_support.bitmap_support_cuda(bm, bm.clone(), ids, ids,
                                           body="digest")
    with pytest.raises(ValueError):          # row pairs, not gathered
        bitmap_support.bitmap_support_cuda(bm, bm, body="digest")
    with pytest.raises(ValueError):
        bitmap_support.bitmap_support_cuda(bm, bm, ids, ids, capacity=-1)
    with pytest.raises(ValueError):
        peel_wave.peel_wave_cuda(bm, bm, ids.bool(), 3, ids, ids, body="x")


def test_two_bitmaps_run_the_direct_body(cuda):
    """Gathered pairs from two bitmaps keep the direct body by default."""
    rng = np.random.default_rng(5)
    bm, eu, ev = _digest_cases(rng, cuda)
    other = torch.roll(bm, 1, dims=0).contiguous()
    alive = torch.from_numpy(rng.random(eu.shape[0]) < 0.7).to(cuda)
    n1, n2 = dict(peel_wave.LAUNCHES_BY_BODY), dict(bitmap_support.LAUNCHES_BY_BODY)
    got = bitmap_support.bitmap_support_cuda(bm, other, eu, ev)
    assert torch.equal(got, ref.bitmap_support_ref(bm[eu.long()],
                                                   other[ev.long()]))
    for g, x in zip(peel_wave.peel_wave_cuda(bm, other, alive, 3, eu, ev),
                    ref.peel_wave_ref(bm[eu.long()], other[ev.long()], alive,
                                      3)):
        assert torch.equal(g, x)
    torch.cuda.synchronize()
    assert peel_wave.LAUNCHES_BY_BODY["direct"] - n1["direct"] == 1
    assert bitmap_support.LAUNCHES_BY_BODY["direct"] - n2["direct"] == 1
    assert peel_wave.LAUNCHES_BY_BODY["digest"] == n1["digest"]
    assert bitmap_support.LAUNCHES_BY_BODY["digest"] == n2["digest"]


@pytest.mark.parametrize("method", ["bitmap", "sorted"])
def test_engine_on_card_equals_engine_on_cpu(cuda, method):
    n = 400
    edges = powerlaw_graph(n, 5, seed=4)
    g_gpu = core.DynamicGraph(n, edges, support_method=method, device=cuda)
    g_cpu = core.DynamicGraph(n, edges, support_method=method, device="cpu")
    rng = np.random.default_rng(0)
    present = {tuple(map(int, e)) for e in edges}
    for n_up, kw in ((4, {}), (40, {}), (40, {"engine": "recompute"})):
        pres = sorted(present)
        dels = [pres[i] for i in rng.choice(len(pres), n_up // 2, replace=False)]
        ins = set()
        while len(ins) < n_up // 2:
            a, b = sorted(int(x) for x in rng.integers(0, n, 2))
            if a != b and (a, b) not in present:
                ins.add((a, b))
        ups = [(0, a, b) for a, b in dels] + [(1, a, b) for a, b in sorted(ins)]
        for g in (g_gpu, g_cpu):
            g.apply_batch(ups, **kw)
        present = (present - set(dels)) | ins
        for x, y in zip(g_gpu.state, g_cpu.state):
            assert torch.equal(x.cpu(), y)
        assert (core.stats_dict(g_gpu.last_peel_stats)
                == core.stats_dict(g_cpu.last_peel_stats))
    assert g_gpu.phi_dict() == core.oracle.scratch_phi(n, present)


# ---------------------------------------------------------------------------
# the sharded substrate on the card: every shard on the one card
# ---------------------------------------------------------------------------

def _graph_record(g):
    return ([x.clone() for x in g.state], core.stats_dict(g.last_peel_stats))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("partition", ["replicated", "nodes"])
def test_sharded_engines_on_card_equal_mesh_none(cuda, shards, partition):
    """The edge-sharded delta engine (K1 on each shard's row block) and the
    node-partitioned one (K2 on each shard's word slab) on a 4,000-node
    bitmap: decompose, a fused batch and a recompute decompose bitwise
    equal to mesh=None, every K1/K2 launch of the sharded runs on the
    digest body."""
    n = 4000
    edges = powerlaw_graph(n, 5, seed=0)
    e_cap = 2 * len(edges) + (-2 * len(edges)) % 4
    ups = _service_updates(np.random.default_rng(3),
                           {tuple(map(int, e)) for e in edges}, n, 200)
    g0 = core.DynamicGraph(n, edges, support_method="bitmap", e_cap=e_cap,
                           device=cuda)
    want = [_graph_record(g0)]
    g0.apply_batch(ups, strategy="fused")
    want.append(_graph_record(g0))
    re0 = core.decompose_with_stats(g0.spec, g0.state, "bitmap",
                                    engine="recompute", device=cuda)

    mesh = make_shard_mesh(shards, device="cuda")
    counts = [dict(m.LAUNCHES_BY_BODY) for m in (peel_wave, bitmap_support)]
    g = core.DynamicGraph(n, edges, support_method="bitmap", e_cap=e_cap,
                          mesh=mesh, partition=partition, device=cuda)
    got = [_graph_record(g)]
    if partition == "nodes":
        assert [tuple(s.shape) for s in g._bitmap] == \
            [(n, g.spec.word_block)] * shards
    g.apply_batch(ups, strategy="fused")
    got.append(_graph_record(g))
    re = core.decompose_with_stats(g.spec, g.state, "bitmap",
                                   engine="recompute", mesh=mesh, device=cuda)
    now = [dict(m.LAUNCHES_BY_BODY) for m in (peel_wave, bitmap_support)]
    for (arrays, stats), (arrays0, stats0) in zip(got, want):
        assert stats == stats0
        assert all(torch.equal(x, y) for x, y in zip(arrays, arrays0))
    bm = core.join_slabs(g._bitmap) if partition == "nodes" else g._bitmap
    w = g0._bitmap.shape[1]   # the slabs pad the word axis to S slabs
    assert torch.equal(bm[:, :w], g0._bitmap) and not bm[:, w:].any()
    assert torch.equal(re[0], re0[0])
    assert core.stats_dict(re[1]) == core.stats_dict(re0[1])
    k1, k2 = ({b: now[i][b] - counts[i][b] for b in now[i]} for i in (0, 1))
    assert k1["direct"] == 0 and k2["direct"] == 0 and k2["digest"] > 0
    if partition == "replicated":   # K1 once a shard a wave
        assert k1["digest"] > 0 and k1["digest"] % shards == 0
    else:                           # K2 once a slab a wave, never K1
        assert k1["digest"] == 0 and k2["digest"] % shards == 0


# ---------------------------------------------------------------------------
# the WAL-backed TrussService on the card: K1 through its fused flushes, K2
# through the recompute fallback, snapshots round-tripping bitwise
# ---------------------------------------------------------------------------

def _service_updates(rng, present, n, n_up):
    """(op, a, b) writes: n_up // 2 deletes of present edges, as many
    inserts of absent pairs."""
    pres = sorted(present)
    dels = [pres[i] for i in rng.choice(len(pres), n_up // 2, replace=False)]
    ins = set()
    while len(ins) < n_up // 2:
        a, b = sorted(int(x) for x in rng.integers(0, n, 2))
        if a != b and (a, b) not in present:
            ins.add((a, b))
    return [(0, a, b) for a, b in dels] + [(1, a, b) for a, b in sorted(ins)]


def _apply(present, ups):
    for op, a, b in ups:
        (present.add if op == 1 else present.discard)((a, b))


def _service(cuda, root, edges, n, **kw):
    return TrussService(n, edges, support_method="bitmap", device=cuda,
                        tracked_ks=(3, 4), store=TrussStore(str(root)), **kw)


def test_service_fused_flush_launches_k1(cuda, tmp_path):
    n = 400
    edges = powerlaw_graph(n, 5, seed=4)
    svc = _service(cuda, tmp_path, edges, n, flush_every=40)
    present = {tuple(map(int, e)) for e in edges}
    rng = np.random.default_rng(1)
    k1 = peel_wave.LAUNCHES_BY_BODY["digest"]
    ups = _service_updates(rng, present, n, 40)
    for op, a, b in ups:
        svc.submit(op, a, b)        # the 40th write flushes one fused batch
    _apply(present, ups)
    assert svc.gen == 1 and svc.stats()["peel"]["waves"] > 0
    assert peel_wave.LAUNCHES_BY_BODY["digest"] > k1
    assert svc.graph.phi_dict() == core.oracle.scratch_phi(n, present)


def test_service_recompute_fallback_launches_k2(cuda, tmp_path):
    n = 400
    edges = powerlaw_graph(n, 5, seed=5)
    svc = _service(cuda, tmp_path, edges, n, flush_every=40,
                   chaos=PeelChaos(dispatch_gens={1}))
    present = {tuple(map(int, e)) for e in edges}
    k2 = bitmap_support.LAUNCHES_BY_BODY["digest"]
    fallbacks = svc.stats()["counters"]["engine_fallbacks"]
    ups = _service_updates(np.random.default_rng(2), present, n, 40)
    svc.submit_many(ups)
    _apply(present, ups)
    assert svc.stats()["counters"]["engine_fallbacks"] == fallbacks + 1
    assert svc.stats()["degraded"] is None
    assert bitmap_support.LAUNCHES_BY_BODY["digest"] > k2
    assert svc.graph.phi_dict() == core.oracle.scratch_phi(n, present)


def test_service_snapshot_restore_on_card_is_bitwise(cuda, tmp_path):
    n = 400
    edges = powerlaw_graph(n, 5, seed=6)
    svc = _service(cuda, tmp_path, edges, n, flush_every=40)
    present = {tuple(map(int, e)) for e in edges}
    rng = np.random.default_rng(3)
    for _ in range(2):
        ups = _service_updates(rng, present, n, 40)
        svc.submit_many(ups)
        _apply(present, ups)
    svc.snapshot()
    ups = _service_updates(rng, present, n, 30)   # pending at the restore
    svc.submit_many(ups)
    _apply(present, ups)
    svc.flush()
    back = TrussService.restore(TrussStore(str(tmp_path)), flush_every=40,
                                support_method="bitmap", device=cuda)
    assert back.graph.device.type == "cuda" and back.gen == svc.gen
    for x, y in zip(svc.graph.state, back.graph.state):
        assert x.is_cuda and y.is_cuda and torch.equal(x, y)
    assert back.graph.phi_dict() == core.oracle.scratch_phi(n, present)
    assert [r[1:] for r in back.store.read_wal()][-len(ups):] == ups


def test_replica_tails_bitmap_primary_on_card_bitwise(cuda, tmp_path):
    """A replica on the card tailing a ``bitmap`` primary on the card: K1's
    digest body launches in the replica's applies, and the replica is
    bitwise equal to the primary at every generation it reaches."""
    n = 400
    edges = powerlaw_graph(n, 5, seed=7)
    svc = _service(cuda, tmp_path, edges, n, flush_every=40)
    rep = Replica(str(tmp_path), "r0", support_method="bitmap", device=cuda)
    present = {tuple(map(int, e)) for e in edges}
    rng = np.random.default_rng(4)
    for _ in range(3):
        ups = _service_updates(rng, present, n, 40)
        svc.submit_many(ups)
        _apply(present, ups)
        k1 = peel_wave.LAUNCHES_BY_BODY["digest"]
        assert rep.poll() == svc.gen
        assert peel_wave.LAUNCHES_BY_BODY["digest"] > k1
        for x, y in zip(svc.graph.state, rep.svc.graph.state):
            assert x.is_cuda and y.is_cuda and torch.equal(x, y)
    assert rep.svc.graph.phi_dict() == core.oracle.scratch_phi(n, present)


def test_promotion_on_card_replays_acked_tail(cuda, tmp_path):
    """The primary drops with writes acked but unflushed; the promoted
    replica replays them on the card and equals the oracle."""
    n = 400
    edges = powerlaw_graph(n, 5, seed=8)
    svc = _service(cuda, tmp_path, edges, n, flush_every=40)
    rep = Replica(str(tmp_path), "r0", support_method="bitmap", device=cuda)
    present = {tuple(map(int, e)) for e in edges}
    rng = np.random.default_rng(5)
    ups = _service_updates(rng, present, n, 40)
    svc.submit_many(ups)
    _apply(present, ups)
    rep.poll()
    ups = _service_updates(rng, present, n, 30)   # acked, never flushed
    svc.submit_many(ups)
    _apply(present, ups)
    svc.store.close()
    del svc
    k1 = peel_wave.LAUNCHES_BY_BODY["digest"]
    promoted = rep.promote()
    assert peel_wave.LAUNCHES_BY_BODY["digest"] > k1
    assert promoted.graph.device.type == "cuda" and promoted.gen == 2
    assert promoted.graph.phi_dict() == core.oracle.scratch_phi(n, present)
    assert [r[1:] for r in promoted.store.read_wal()][-len(ups):] == ups


def test_profiled_region_on_card_records_every_launch(cuda, tmp_path):
    """An armed flush on the card writes one Chrome trace in which every
    launch, copy and fill of the flush has its device record."""
    n = 400
    edges = powerlaw_graph(n, 5, seed=9)
    svc = _service(cuda, tmp_path / "store", edges, n, flush_every=400)
    present = {tuple(map(int, e)) for e in edges}
    svc.submit_many(_service_updates(np.random.default_rng(6), present, n,
                                     40))
    profiling.configure(str(tmp_path / "prof"), max_traces=1)
    try:
        svc.flush()
    finally:
        profiling.configure(None)
    path = tmp_path / "prof" / "flush-0.json"
    issued, lost = profiling.lost_records(str(path))
    assert issued > 0 and lost == []
    names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]
             if e.get("cat") == "kernel"}
    assert any("digest_rows" in name for name in names), sorted(names)[:20]


# ---------------------------------------------------------------------------
# K3 flash_attention: 2e-5 in fp32, 3e-2 in bf16 (one bf16 rounding of the
# output apart), as the reference's kernel sweep
# ---------------------------------------------------------------------------

def _heads(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("bh,sq,dh", [(1, 64, 16), (2, 300, 32), (4, 128, 64)])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_equals_plain_version(cuda, bh, sq, dh, window, dtype):
    rng = np.random.default_rng(bh * sq)
    q, k, v = (_heads(rng, (bh, sq, dh), dtype, cuda) for _ in range(3))
    n = flash_attention.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    exp = ref.attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == n + 1 and got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), exp.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window", [(False, None), (False, 40),
                                           (True, 100)])
def test_flash_attention_masks_keys_past_the_end(cuda, causal, window):
    """S = 100 is no multiple of the kernel's 64-key tile: keys past the
    end never reach the normaliser, causal or not (R3)."""
    rng = np.random.default_rng(9)
    q, k, v = (_heads(rng, (3, 100, 64), torch.float32, cuda) for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    exp = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_flash_attention_heads_entry_reads_kv_heads_in_place(cuda, hq, hkv):
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, dh = 2, 200, 128
    q = _heads(rng, (b, s, hq, dh), torch.bfloat16, cuda)
    k, v = (_heads(rng, (b, s, hkv, dh), torch.bfloat16, cuda) for _ in range(2))
    got = ops.flash_attention_heads(q, k, v, window=70)
    exp = ref.chunked_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
        window=70).transpose(1, 2)
    # about one bf16 step of each value: |o| here is far below the sweep's 3e-2
    torch.testing.assert_close(got.float(), exp.float(), rtol=1.6e-2, atol=1e-3)


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 64, 2, 48), device=cuda)
    with pytest.raises(ValueError):          # head_dim 48
        ops.flash_attention_heads(q, q, q)
    q = torch.zeros((1, 64, 2, 32), device=cuda)
    with pytest.raises(ValueError):          # Sq != Skv
        ops.flash_attention_heads(q, q[:, :32].contiguous(), q[:, :32].contiguous())
    with pytest.raises(ValueError):          # not contiguous
        ops.flash_attention_heads(q.transpose(1, 2), q.transpose(1, 2),
                                  q.transpose(1, 2))


# The bf16 tensor-core body at head dims 64, 128 and 256: held to the path's
# rtol 1.6e-2 + atol 1e-3 (about one bf16 step of each value), with a V
# whose columns differ (a transposed or swapped V operand would show).

def _asym_v(rng, shape, device):
    v = _heads(rng, shape, torch.float32, device)
    return (v + torch.linspace(-2.0, 3.0, shape[-1], device=device)).to(
        torch.bfloat16)


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("s", [128, 300, 4096])
@pytest.mark.parametrize("window", [None, 40])
def test_wgmma_body_equals_plain_version(cuda, dh, s, window):
    rng = np.random.default_rng(dh * s + (window or 0))
    q, k = (_heads(rng, (2, s, dh), torch.bfloat16, cuda) for _ in range(2))
    v = _asym_v(rng, (2, s, dh), cuda)
    n = dict(flash_attention.LAUNCHES_BY_BODY)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    exp = ref.attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES_BY_BODY == {
        "wgmma": n["wgmma"] + 1, "simt": n["simt"]}
    torch.testing.assert_close(got.float(), exp.float(), rtol=1.6e-2,
                               atol=1e-3)


@pytest.mark.parametrize("hq,hkv,dh", [
    pytest.param(16, 8, 128, id="16-8"), pytest.param(4, 1, 128, id="4-1"),
    pytest.param(8, 1, 256, id="8-1-256")])      # gemma-2b's MQA heads
def test_wgmma_body_reads_kv_heads_in_place(cuda, hq, hkv, dh):
    rng = np.random.default_rng(hq + hkv)
    b, s = 2, 700
    q = _heads(rng, (b, s, hq, dh), torch.bfloat16, cuda)
    k = _heads(rng, (b, s, hkv, dh), torch.bfloat16, cuda)
    v = _asym_v(rng, (b, s, hkv, dh), cuda)
    n = flash_attention.LAUNCHES_BY_BODY["wgmma"]
    got = ops.flash_attention_heads(q, k, v)
    exp = ref.chunked_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
        window=None).transpose(1, 2)
    assert flash_attention.LAUNCHES_BY_BODY["wgmma"] == n + 1
    torch.testing.assert_close(got.float(), exp.float(), rtol=1.6e-2,
                               atol=1e-3)


@pytest.mark.parametrize("dh,window", [(64, None), (128, 100), (256, None)])
def test_the_two_bodies_agree_on_bf16(cuda, dh, window):
    """The same bf16 input through the wgmma body and, asked for by name,
    the SIMT body: each output within one bf16 step of the other."""
    rng = np.random.default_rng(dh)
    q, k = (_heads(rng, (2, 1000, 4, dh), torch.bfloat16, cuda)
            for _ in range(2))
    v = _asym_v(rng, (2, 1000, 4, dh), cuda)
    n = dict(flash_attention.LAUNCHES_BY_BODY)
    fast = flash_attention.flash_attention_cuda(q, k, v, window=window)
    simt = flash_attention.flash_attention_cuda(q, k, v, window=window,
                                                body="simt")
    assert flash_attention.LAUNCHES_BY_BODY == {
        "wgmma": n["wgmma"] + 1, "simt": n["simt"] + 1}
    torch.testing.assert_close(fast.float(), simt.float(), rtol=1.6e-2,
                               atol=1e-3)


@pytest.mark.parametrize("dtype,dh,body", [(torch.bfloat16, 128, "wgmma"),
                                           (torch.bfloat16, 64, "wgmma"),
                                           (torch.bfloat16, 256, "wgmma"),
                                           (torch.bfloat16, 32, "simt"),
                                           (torch.float32, 128, "simt")])
def test_launches_by_body_show_which_body_ran(cuda, dtype, dh, body):
    q = _heads(np.random.default_rng(0), (1, 200, 2, dh), dtype, cuda)
    n = dict(flash_attention.LAUNCHES_BY_BODY)
    total = flash_attention.LAUNCHES
    ops.flash_attention_heads(q, q, q)
    assert flash_attention.LAUNCHES == total + 1
    n[body] += 1
    assert flash_attention.LAUNCHES_BY_BODY == n


def test_a_body_is_never_switched(cuda):
    """The wgmma body refuses fp32 (at head dims 128 and 256) and other head
    dims by name; it is not swapped for the SIMT body."""
    for dh in (128, 256):
        q = torch.zeros((1, 64, 2, dh), device=cuda)
        n = dict(flash_attention.LAUNCHES_BY_BODY)
        with pytest.raises(ValueError):
            flash_attention.flash_attention_cuda(q, q, q, body="wgmma")
        assert flash_attention.LAUNCHES_BY_BODY == n
    q = torch.zeros((1, 64, 2, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_cuda(q, q, q, body="wgmma")
    with pytest.raises(ValueError):
        flash_attention.flash_attention_cuda(q, q, q, body="tensor")


def test_prefill_on_card_equals_prefill_on_cpu(cuda):
    """qwen3 smoke at s = 512: the card's prefill launches K3 once per
    layer; its logits agree with the CPU's (chunked attention) within 3% of
    the largest |logit| (bf16 matmuls sum in another order)."""
    cfg = get_config("qwen3-0.6b").smoke
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    card_params = transformer.params_from_numpy(
        cfg, transformer.params_to_numpy(params), device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 512)))
    n = flash_attention.LAUNCHES
    got = transformer.prefill(cfg, card_params, toks.to(cuda)).cpu()
    assert flash_attention.LAUNCHES == n + cfg.n_layers
    exp = transformer.prefill(cfg, params, toks)
    assert (got - exp).abs().max() <= 3e-2 * exp.abs().max()


# ---------------------------------------------------------------------------
# K4 segment sum: 1e-5 in fp32, 2e-2 in fp16 (the reference's sweep);
# K5 CIN layer: 2e-5 in fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,d,n", [(10, 4, 3), (100, 16, 17), (1000, 64, 77),
                                   (513, 32, 128), (257, 8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_segment_matmul_equals_plain_version(cuda, e, d, n, dtype):
    rng = np.random.default_rng(e + d + n)
    m = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(
        cuda, dtype)
    seg = torch.from_numpy(rng.integers(-2, n + 2, e).astype(np.int32)).to(cuda)
    launches = segment_matmul.LAUNCHES
    got = ops.segment_matmul(m, seg, n)
    exp = ref.segment_matmul_ref(m, seg, n)
    table = m[: max(e // 2, 1)].contiguous()
    idx = torch.from_numpy(rng.integers(0, table.shape[0], e).astype(
        np.int32)).to(cuda)
    gathered = ops.segment_matmul_gathered(table, idx, seg, n)
    torch.cuda.synchronize()
    assert segment_matmul.LAUNCHES == launches + 2 and got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), exp.float(), rtol=tol, atol=tol)
    # the gathered entry sums the same rows in the same order as the rows
    # entry on the gathered copy: bitwise equal, and so is a second run
    assert torch.equal(gathered, ops.segment_matmul(table[idx.long()], seg, n))
    assert torch.equal(got, ops.segment_matmul(m, seg, n))


def test_segment_matmul_gathered_takes_rows_as_jnp_take(cuda):
    table = torch.arange(18, dtype=torch.float32, device=cuda).reshape(6, 3)
    idx = torch.tensor([0, -1, 5, 6, -7, 2], dtype=torch.int32, device=cuda)
    seg = torch.tensor([0, 0, 1, 2, 3, 4], dtype=torch.int32, device=cuda)
    got = ops.segment_matmul_gathered(table, idx, seg, 5)
    exp = ref.segment_matmul_gathered_ref(table, idx, seg, 5)
    torch.testing.assert_close(got, exp, equal_nan=True)
    assert bool(got[2:4].isnan().all()) and not bool(got[[0, 1, 4]].isnan().any())


def test_segment_matmul_at_the_p99_shape(cuda):
    """xDeepFM serve_p99's bag sum: 16,384 rows of 10 gathered from a
    4M-row table into 2,048 sorted bags of 8."""
    rng = np.random.default_rng(0)
    table = torch.randn((4_000_000, 10), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0)) * 0.01
    idx = torch.from_numpy(rng.integers(0, 4_000_000, 16_384).astype(
        np.int32)).to(cuda)
    seg = torch.arange(2048, dtype=torch.int32, device=cuda).repeat_interleave(8)
    got = ops.segment_matmul_gathered(table, idx, seg, 2048)
    exp = ref.segment_matmul_gathered_ref(table, idx, seg, 2048)
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


def _same(got, exp):
    """Bitwise equal where numbers, NaN at the same places."""
    return (torch.equal(got.isnan(), exp.isnan())
            and torch.equal(got.nan_to_num(0.0), exp.nan_to_num(0.0)))


def _sorted_inputs(rng, e, d, n, dtype, device, rows=300):
    table = torch.from_numpy(rng.normal(size=(rows, d)).astype(
        np.float32)).to(device, dtype)
    idx = torch.from_numpy(rng.integers(-rows - 2, rows + 2, e).astype(
        np.int32)).to(device)                     # a few NaN bags
    seg = torch.from_numpy(np.sort(rng.integers(-2, n + 2, e)).astype(
        np.int32)).to(device)
    return table, idx, seg


@pytest.mark.parametrize("e,d,n", [(10, 4, 3), (100, 16, 17), (1000, 64, 77),
                                   (513, 32, 128), (257, 8, 1), (3000, 300, 50),
                                   (64, 5, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_sorted_entry_equals_sorting_entry(cuda, e, d, n, dtype):
    """Declared-sorted ids (no sort, no order array) give the sorting
    entry's bits, NaN bags included, in one launch."""
    rng = np.random.default_rng(e * d + n)
    table, idx, seg = _sorted_inputs(rng, e, d, n, dtype, cuda)
    launches = segment_matmul.LAUNCHES
    got = ops.segment_matmul_gathered(table, idx, seg, n, ids_sorted=True)
    torch.cuda.synchronize()
    assert segment_matmul.LAUNCHES == launches + 1 and got.dtype == dtype
    assert _same(got, ops.segment_matmul_gathered(table, idx, seg, n))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.segment_matmul_gathered_ref(
        table, idx, seg, n).float(), rtol=tol, atol=tol, equal_nan=True)


def _p99_bags(cuda):
    rng = np.random.default_rng(0)
    table = torch.randn((4_000_000, 10), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0)) * 0.01
    idx = torch.from_numpy(rng.integers(0, 4_000_000, 16_384).astype(
        np.int32)).to(cuda)
    seg = torch.arange(2048, dtype=torch.int32, device=cuda).repeat_interleave(8)
    return table, idx, seg


def test_sorted_entry_equals_sorting_entry_at_the_p99_shape(cuda):
    table, idx, seg = _p99_bags(cuda)
    got = ops.segment_matmul_gathered(table, idx, seg, 2048, ids_sorted=True)
    assert torch.equal(got, ops.segment_matmul_gathered(table, idx, seg, 2048))


@pytest.mark.parametrize("e,d,n", [(100, 16, 17), (1000, 64, 77), (257, 8, 1),
                                   (3000, 10, 40), (16_384, 10, 2048)])
def test_mean_entry_equals_the_two_call_mean(cuda, e, d, n):
    """The fused mean is the sum over clamp(count, 1), one IEEE divide of
    the same fp32 sum: bitwise equal to the sum entry, then the rows entry
    on ones, then clamp and divide (the route it replaces)."""
    rng = np.random.default_rng(e + n)
    if e == 16_384:
        table, idx, seg = _p99_bags(cuda)
    else:
        table, idx, seg = _sorted_inputs(rng, e, d, n, torch.float32, cuda)
    got = ops.segment_matmul_gathered(table, idx, seg, n, ids_sorted=True,
                                      mean=True)
    count = ops.segment_matmul(torch.ones((e, 1), device=cuda), seg, n)
    exp = ops.segment_matmul_gathered(table, idx, seg, n) / torch.clamp(
        count, min=1.0)
    assert _same(got, exp)
    torch.testing.assert_close(got, ref.segment_mean_gathered_ref(
        table, idx, seg, n), rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("mean", [False, True])
def test_false_declaration_gives_all_nan(cuda, mean):
    """Unsorted ids declared sorted: every output is NaN, with no host
    sync; the sorting entry on the same ids is finite."""
    table = torch.randn((50, 10), device=cuda)
    idx = torch.arange(40, dtype=torch.int32, device=cuda)
    seg = torch.arange(40, dtype=torch.int32, device=cuda) // 4
    seg[17], seg[18] = 6, 2                       # one descending pair
    got = ops.segment_matmul_gathered(table, idx, seg, 12, ids_sorted=True,
                                      mean=mean)
    assert bool(got.isnan().all())
    assert bool(ops.segment_matmul_gathered(table, idx, seg, 12,
                                            mean=mean).isfinite().all())
    seg[17], seg[18] = 4, 4                       # sorted again: finite
    assert bool(ops.segment_matmul_gathered(table, idx, seg, 12,
                                            ids_sorted=True).isfinite().all())


@pytest.mark.parametrize("run", [9, 4096, 30_000])
def test_long_runs_are_summed_right(cuda, run):
    """A segment whose run is many times the kernel's chunk of 8 positions
    (the sum carried in registers across chunks), declared sorted and
    sorted by the wrapper, on the gathered and the rows entry: the same
    bits, and within 1e-2 of a float64 sum (fp32 drift over 30,000 rows)."""
    rng = np.random.default_rng(run)
    seg = np.sort(np.concatenate([np.full(run, 2), rng.integers(0, 5, 1000)]))
    seg = torch.from_numpy(seg.astype(np.int32)).to(cuda)
    table = torch.from_numpy(rng.normal(size=(50_000, 10)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 50_000, seg.shape[0]).astype(
        np.int32)).to(cuda)
    got = ops.segment_matmul_gathered(table, idx, seg, 5, ids_sorted=True)
    assert torch.equal(got, ops.segment_matmul_gathered(table, idx, seg, 5))
    rows = table[idx.long()].contiguous()
    assert torch.equal(got, ops.segment_matmul(rows, seg, 5))
    exp = torch.zeros((5, 10), dtype=torch.float64, device=cuda).index_add_(
        0, seg.long(), rows.double())
    assert float((got.double() - exp).abs().max()) <= 1e-2


@pytest.mark.parametrize("b,h,m,o,d", [(8, 5, 7, 11, 6), (64, 40, 40, 200, 10),
                                       (130, 8, 8, 16, 16), (3, 2, 1, 70, 5),
                                       (512, 40, 40, 200, 10),
                                       (512, 200, 40, 200, 10),
                                       (4096, 200, 40, 200, 10),
                                       (300, 13, 7, 250, 9),
                                       (2000, 5, 7, 11, 9)])
def test_cin_layer_equals_plain_version(cuda, b, h, m, o, d):
    """The reference's sweep, ragged tiles, xDeepFM's p99 layers (split
    over k) and a bulk-plan layer 2 (one slice); last, W rows that are not
    16-byte aligned (H M odd), two output tiles and an epilogue whose runs
    are no multiple of 4 floats, split over k and in one slice."""
    rng = np.random.default_rng(b + h)
    xk = _heads(rng, (b, h, d), torch.float32, cuda)
    x0 = _heads(rng, (b, m, d), torch.float32, cuda)
    w = _heads(rng, (o, h, m), torch.float32, cuda) * 0.1
    if h == 200:       # a layer's scale: w ~ 1 / sqrt(H M), as init_params
        w = w * (10.0 / np.sqrt(h * m))
    n = cin.LAUNCHES
    got = ops.cin_layer(xk, x0, w)
    exp = ref.cin_layer_ref(xk, x0, w)
    torch.cuda.synchronize()
    assert cin.LAUNCHES == n + 1 and got.shape == (b, o, d)
    torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,slices", [(512, 3), (4096, 1)])
def test_cin_layer_is_deterministic(cuda, b, slices):
    """Two calls on the same inputs give the same bits, split over k or
    not (the partials are added in slice order, with no atomics)."""
    assert cin.plan(b, 200, 40, 10, 200)[2] == slices
    rng = np.random.default_rng(b)
    xk = _heads(rng, (b, 200, 10), torch.float32, cuda)
    x0 = _heads(rng, (b, 40, 10), torch.float32, cuda)
    w = _heads(rng, (200, 200, 40), torch.float32, cuda) / np.sqrt(8000)
    first = ops.cin_layer(xk, x0, w)
    second = ops.cin_layer(xk, x0, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_cin_layer_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 3, 4), device=cuda)
    with pytest.raises(ValueError):            # bf16
        ops.cin_layer(x.bfloat16(), x.bfloat16(), torch.zeros(
            (5, 3, 3), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):            # w does not contract
        ops.cin_layer(x, x, torch.zeros((5, 3, 2), device=cuda))
    with pytest.raises(ValueError):            # not contiguous
        ops.cin_layer(x.transpose(1, 2).contiguous().transpose(1, 2), x,
                      torch.zeros((5, 3, 3), device=cuda))
    with pytest.raises(ValueError):            # w on the CPU
        cin.cin_layer_cuda(x, x, torch.zeros((5, 3, 3)))


def test_recsys_serve_on_card_equals_serve_on_cpu(cuda):
    """xDeepFM smoke: the card's scores (K4 and K5 on the path) against the
    CPU's plain versions, 1e-5 (fp32 sums in another order); K4 once a
    call (the mean fused, the bag ids declared sorted)."""
    cfg = get_config("xdeepfm").smoke
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0))
    card_params = recsys.params_from_numpy(recsys.params_to_numpy(params),
                                           device=cuda)
    nb = ClickStream(cfg, 64, seed=1).next()
    n4, n5 = segment_matmul.LAUNCHES, cin.LAUNCHES
    got = recsys.serve(cfg, card_params, recsys.batch_to_torch(nb, cuda)).cpu()
    assert segment_matmul.LAUNCHES == n4 + 1
    assert cin.LAUNCHES == n5 + len(cfg.cin_layers)
    exp = recsys.serve(cfg, params, recsys.batch_to_torch(nb, "cpu"))
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the GNN family's differentiable segment sum (K4's rows entry forward, a
# plain row gather backward) and training steps on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,d,n", [(100, 16, 17), (5000, 7, 300), (4097, 1, 64)])
def test_segment_sum_function_on_card_equals_plain_version(cuda, e, d, n):
    """Forward within 1e-5 of the plain version (fp32 sums in another
    order), one K4 launch; backward bitwise equal to the plain gather, no
    launch, zero for ids outside ``[0, n)``."""
    rng = np.random.default_rng(e + d)
    data = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(cuda)
    seg = torch.from_numpy(rng.integers(-2, n + 2, e).astype(np.int32)).to(cuda)
    cot = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    x = data.clone().requires_grad_(True)
    launches = segment_matmul.LAUNCHES
    out = ops.segment_sum(x, seg, n)
    assert segment_matmul.LAUNCHES == launches + 1 and out.dtype == torch.float32
    torch.testing.assert_close(out, ref.segment_matmul_ref(data, seg, n),
                               rtol=1e-5, atol=1e-5)
    (grad,) = torch.autograd.grad(out, x, cot)
    assert segment_matmul.LAUNCHES == launches + 1
    assert torch.equal(grad, ref.segment_sum_vjp_ref(cot, seg))
    outside = (seg < 0) | (seg >= n)
    assert not bool(grad[outside].any())
    assert torch.equal(grad.cpu(), ref.segment_sum_vjp_ref(cot.cpu(), seg.cpu()))


@pytest.mark.parametrize("arch_id", ["gcn-cora", "gin-tu", "meshgraphnet",
                                     "dimenet"])
def test_gnn_train_step_on_card_equals_plain_route(cuda, arch_id):
    """One AdamW step of each GNN smoke config on the card through K4 against
    the same step under ``use_kernels(False)`` and on the CPU: loss and
    every gradient leaf within rtol 1e-5 plus 1e-5 of the leaf's largest
    magnitude (fp32 sums in another order); the step's parameters finite
    and moved."""
    cfg = get_config(arch_id).smoke
    nb = sampler.make_gnn_batch(powerlaw_graph(48, 3, seed=2), 48, d_feat=8,
                                n_classes=cfg.n_classes, with_pos=True,
                                with_triplets=cfg.model == "dimenet",
                                pad_nodes=64, pad_edges=400, seed=3)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), 8)
    card = gnn.params_from_numpy(gnn.params_to_numpy(params), device=cuda)
    loss_fn = lambda p, b: gnn.loss_fn(cfg, p, b)
    batch = gnn.batch_to_torch(nb, cuda)
    launches = segment_matmul.LAUNCHES
    loss, grads = value_and_grad(loss_fn, card, batch)
    per_step = segment_matmul.LAUNCHES - launches
    expected = {"gcn": cfg.n_layers + 1, "gin": cfg.n_layers,
                "meshgraphnet": cfg.n_layers, "dimenet": cfg.n_layers}
    assert per_step == expected[cfg.model], per_step
    ops.use_kernels(False)
    try:
        p_loss, p_grads = value_and_grad(loss_fn, card, batch)
    finally:
        ops.use_kernels(True)
    assert segment_matmul.LAUNCHES == launches + per_step
    c_loss, c_grads = value_and_grad(loss_fn, params, gnn.batch_to_torch(nb, "cpu"))

    def close(got, exp):
        tol = 1e-5 * max(1.0, float(exp.abs().max()))
        torch.testing.assert_close(got.cpu(), exp.cpu(), rtol=1e-5, atol=tol)

    for other_loss, other in ((p_loss, p_grads), (c_loss, c_grads)):
        close(loss, other_loss)
        for g, h in zip(tree_leaves(grads), tree_leaves(other)):
            close(g, h)
    step = make_train_step(loss_fn, AdamWConfig(total_steps=10, warmup_steps=1))
    new, state, stats = step(card, adamw_init(card), batch)
    assert int(state["step"]) == 1 and bool(torch.isfinite(stats["loss"]))
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(new))
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(new), tree_leaves(card)))


# ---------------------------------------------------------------------------
# the LM and recsys training paths: K3, K4's gathered entry and K5 as
# autograd Functions (the kernel forward, a plain backward) and one training
# step of each smoke config on the card against the plain route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,hq,hkv,dh,dtype,body", [
    (2, 1024, 16, 8, 128, torch.bfloat16, "wgmma"),
    (1, 512, 4, 2, 32, torch.float32, "simt")])
def test_flash_attention_function_on_card(cuda, b, s, hq, hkv, dh, dtype, body):
    """Forward: one launch of the body ``body_for`` picks, within the
    path's tolerance of ``use_kernels(False)`` (one bf16 step; 2e-5 in
    fp32).  Backward: no launch, and bitwise equal to the plain route's,
    since both run ``ref.attention_vjp_ref`` on the same saved inputs."""
    rng = np.random.default_rng(s + dh)
    leaves = [_heads(rng, (b, s, h, dh), dtype, cuda).requires_grad_(True)
              for h in (hq, hkv, hkv)]
    do = _heads(rng, (b, s, hq, dh), dtype, cuda)
    n = dict(flash_attention.LAUNCHES_BY_BODY)
    out = ops.flash_attention_heads(*leaves, window=300)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES_BY_BODY[body] == n[body] + 1
    assert sum(flash_attention.LAUNCHES_BY_BODY.values()) == sum(n.values()) + 1
    ops.use_kernels(False)
    try:
        p_out = ops.flash_attention_heads(*leaves, window=300)
        p_grads = torch.autograd.grad(p_out, leaves, do)
    finally:
        ops.use_kernels(True)
    if dtype == torch.float32:
        torch.testing.assert_close(out, p_out, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(out.float(), p_out.float(), rtol=1.6e-2,
                                   atol=1e-3)
    for g, p in zip(grads, p_grads):
        assert g.dtype == dtype and torch.equal(g, p)


def test_cin_function_on_card(cuda):
    """K5 at a training layer 2 ``[4,096, 200/40, 10]``: one launch
    forward, none backward; the forward within 2e-5 of the plain route's,
    the three gradients bitwise equal to the plain backward on the
    kernel's output, and the two routes' relu decisions (which the
    backward's mask follows) differing only where both outputs lie within
    2e-5 of 0."""
    rng = np.random.default_rng(7)
    b, h, m, o, d = 4096, 200, 40, 200, 10
    xk = _heads(rng, (b, h, d), torch.float32, cuda).requires_grad_(True)
    x0 = _heads(rng, (b, m, d), torch.float32, cuda).requires_grad_(True)
    w = (_heads(rng, (o, h, m), torch.float32, cuda) / np.sqrt(h * m)
         ).requires_grad_(True)
    g = _heads(rng, (b, o, d), torch.float32, cuda)
    n = cin.LAUNCHES
    out = ops.cin_layer(xk, x0, w)
    grads = torch.autograd.grad(out, (xk, x0, w), g)
    torch.cuda.synchronize()
    assert cin.LAUNCHES == n + 1
    ops.use_kernels(False)
    try:
        p_out = ops.cin_layer(xk, x0, w)
    finally:
        ops.use_kernels(True)
    torch.testing.assert_close(out, p_out, rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        exp = ref.cin_layer_vjp_ref(xk, x0, w, out, g)
    for a, e in zip(grads, exp):
        assert torch.equal(a, e)
    out, p_out = out.detach(), p_out.detach()
    differ = (out > 0) != (p_out > 0)
    assert float(torch.where(differ, torch.maximum(out, p_out), 0.0).max()) <= 2e-5


def test_embedding_bag_function_on_card(cuda):
    """K4's gathered mean entry on an xDeepFM batch's multi-hot bags
    (declared sorted): one launch forward within 1e-5 of the plain route,
    none backward; the dense table gradient bitwise equal to the plain
    route's (the scatter sorts its indices on the card) and within 1e-5 of
    the CPU's."""
    cfg = get_config("xdeepfm").smoke
    nb = ClickStream(cfg, 4096, seed=5).next()
    mh = torch.from_numpy(nb["multihot_ids"]).to(cuda)
    rows, bags = recsys.multihot_bags(cfg, mh)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(
        cfg.n_sparse * cfg.vocab_per_field, cfg.embed_dim)).astype(np.float32))
    t = table.to(cuda).requires_grad_(True)
    nbags = 4096 * cfg.n_multihot
    g = _heads(rng, (nbags, cfg.embed_dim), torch.float32, cuda)
    n = segment_matmul.LAUNCHES
    out = ops.segment_matmul_gathered(t, rows, bags, nbags, ids_sorted=True,
                                      mean=True)
    (grad,) = torch.autograd.grad(out, t, g)
    torch.cuda.synchronize()
    assert segment_matmul.LAUNCHES == n + 1
    ops.use_kernels(False)
    try:
        p_out = ops.segment_matmul_gathered(t, rows, bags, nbags,
                                            ids_sorted=True, mean=True)
        (p_grad,) = torch.autograd.grad(p_out, t, g)
    finally:
        ops.use_kernels(True)
    torch.testing.assert_close(out, p_out, rtol=1e-5, atol=1e-5)
    assert torch.equal(grad, p_grad)
    torch.testing.assert_close(grad.cpu(), ref.segment_gathered_vjp_ref(
        g.cpu(), table.shape, rows.cpu(), bags.cpu(), mean=True),
        rtol=1e-5, atol=1e-6)


def _step_vs_plain(loss_fn, params, batch):
    loss, grads = value_and_grad(loss_fn, params, batch)
    ops.use_kernels(False)
    try:
        p_loss, p_grads = value_and_grad(loss_fn, params, batch)
    finally:
        ops.use_kernels(True)
    return loss, grads, p_loss, p_grads


def test_lm_train_step_on_card_equals_plain_route(cuda):
    """qwen3's smoke config at ``[2, 512]``: K3 (the SIMT body at head dim
    16) launched once a layer forward and once more a layer in the remat;
    the loss within 5e-3 relative and each gradient leaf within 5e-2
    relative Frobenius error of ``use_kernels(False)`` (the bf16 forward
    differs by K3's roundings)."""
    cfg = get_config("qwen3-0.6b").smoke
    params = transformer.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 513)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss_fn = lambda p, b: transformer.loss_fn(cfg, p, b)
    n = flash_attention.LAUNCHES
    loss, grads, p_loss, p_grads = _step_vs_plain(loss_fn, params, batch)
    assert flash_attention.LAUNCHES == n + 2 * cfg.n_layers
    assert abs(float(loss) - float(p_loss)) <= 5e-3 * abs(float(p_loss))
    for g, p in zip(tree_leaves(grads), tree_leaves(p_grads)):
        assert float(torch.linalg.vector_norm(g - p)) <= \
            5e-2 * float(torch.linalg.vector_norm(p))


def test_recsys_train_step_on_card_equals_plain_route(cuda):
    """xDeepFM's smoke config: K4 once and K5 once a CIN layer a step; the
    loss and every leaf within rtol 1e-5 plus 1e-5 of the leaf's largest
    magnitude of ``use_kernels(False)`` and of the CPU."""
    cfg = get_config("xdeepfm").smoke
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0))
    card = recsys.params_from_numpy(recsys.params_to_numpy(params), device=cuda)
    nb = ClickStream(cfg, 512, seed=2).next()
    loss_fn = lambda p, b: recsys.loss_fn(cfg, p, b)
    n4, n5 = segment_matmul.LAUNCHES, cin.LAUNCHES
    loss, grads, p_loss, p_grads = _step_vs_plain(
        loss_fn, card, recsys.batch_to_torch(nb, cuda))
    assert segment_matmul.LAUNCHES == n4 + 1
    assert cin.LAUNCHES == n5 + len(cfg.cin_layers)
    c_loss, c_grads = value_and_grad(loss_fn, params,
                                     recsys.batch_to_torch(nb, "cpu"))

    def close(got, exp):
        tol = 1e-5 * max(1e-30, float(exp.abs().max()))
        torch.testing.assert_close(got.cpu(), exp.cpu(), rtol=1e-5, atol=tol)

    for other_loss, other in ((p_loss, p_grads), (c_loss, c_grads)):
        close(loss, other_loss)
        for g, h in zip(tree_leaves(grads), tree_leaves(other)):
            close(g, h)


@pytest.mark.parametrize("arch_id", ["mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_moe_apply_on_card_equals_cpu_at_matched_routing(cuda, arch_id):
    """The MoE layer of each MoE smoke config on the card against the CPU,
    bf16, with the card replaying the CPU's expert choices: the dispatch
    slots equal, the output within 2**-7 relative plus 2e-2 and the aux
    within 2**-7 relative (bf16 matmuls summed in another order)."""
    from repro_torch.models import layers

    cfg = get_config(arch_id).smoke
    p = layers.moe_init(torch.Generator().manual_seed(0), cfg.d_model,
                        cfg.d_ff, cfg.moe_experts, cfg.mlp)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 40, cfg.d_model)).astype(np.float32)).bfloat16()
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, kind=cfg.mlp)
    r = layers.moe_route(p["router"], x, n_experts=cfg.moe_experts,
                         top_k=cfg.moe_top_k)
    exp, exp_aux = layers.moe_apply(p, x, **kw)
    pc = {k: v.to(cuda) for k, v in p.items()}
    rc = layers.moe_route(pc["router"], x.to(cuda), n_experts=cfg.moe_experts,
                          top_k=cfg.moe_top_k, gate_idx=r.gate_idx.to(cuda))
    assert torch.equal(rc.dest.cpu(), r.dest) and torch.equal(rc.keep.cpu(), r.keep)
    got, aux = layers.moe_apply(pc, x.to(cuda), gate_idx=r.gate_idx.to(cuda), **kw)
    torch.testing.assert_close(got.cpu().float(), exp.float(), rtol=2 ** -7,
                               atol=2e-2)
    assert abs(float(aux) - float(exp_aux)) <= 2 ** -7 * abs(float(exp_aux))


def test_kv_quant_on_card_equals_cpu_bitwise(cuda):
    """int8 values and scales of a bf16 and an fp32 cache on the card equal
    the CPU's bitwise; ``attend_quant`` on the card within 1e-5."""
    from repro_torch.serving import kv_quant

    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.normal(size=(2, 4, 64, 8, 128)).astype(
            np.float32)).to(dtype)
        v, s = kv_quant.quantize_kv(x)
        vc, sc = kv_quant.quantize_kv(x.to(cuda))
        assert torch.equal(vc.cpu(), v) and torch.equal(sc.cpu(), s)
    layer = {"kq": v[0], "ks": s[0], "vq": v[1], "vs": s[1]}
    q = torch.from_numpy(rng.normal(size=(4, 32, 128)).astype(np.float32))
    valid = torch.arange(64) < 50
    exp = kv_quant.attend_quant(q, layer, valid, 8, 128)
    got = kv_quant.attend_quant(q.to(cuda), {k: t.to(cuda) for k, t in layer.items()},
                                valid.to(cuda), 8, 128)
    torch.testing.assert_close(got.cpu(), exp, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the cell plans: the expert block's mesh branches on the card, the meta
# route beside the kernels
# ---------------------------------------------------------------------------

BRANCH_FRO = 2e-2     # tests/test_torch_specs.py's bound


@pytest.mark.parametrize("arch_id,shape", [("mixtral-8x7b", (1, 8)),
                                           ("mixtral-8x7b", (2, 16)),
                                           ("llama4-scout-17b-a16e", (2, 8))])
def test_moe_mesh_branches_on_card(cuda, arch_id, shape):
    """mixtral-smoke's 4 experts take the model-sharded branch (within
    ``BRANCH_FRO`` of mesh=None), llama4-smoke's 8 on a model axis of 8
    expert parallelism (bitwise)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers

    cfg = get_config(arch_id).smoke
    gen = torch.Generator(cuda).manual_seed(0)
    p = layers.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.mlp)
    x = torch.randn((4, 64, cfg.d_model), generator=gen, device=cuda)
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, kind=cfg.mlp)
    y0, aux0 = layers.moe_apply(p, x, **kw)
    y, aux = layers.moe_apply(p, x, mesh=make_test_mesh(shape, device="cuda"), **kw)
    assert y.device.type == "cuda" and torch.equal(aux, aux0)
    if cfg.moe_experts % shape[1] == 0:
        assert torch.equal(y, y0)
    else:
        err = float((y.float() - y0.float()).norm() / y0.float().norm())
        assert 0 < err <= BRANCH_FRO, err


@pytest.mark.parametrize("arch_id,shape", [("mixtral-8x7b", (1, 8)),
                                           ("mixtral-8x7b", (2, 16)),
                                           ("llama4-scout-17b-a16e", (2, 8))])
def test_moe_mesh_branch_backward_on_card(cuda, arch_id, shape):
    """The gradients of ``sum(y · ct) + aux`` with respect to ``x``, the
    router and each expert stack through the mesh branches on the card:
    the model-sharded branch's within ``BRANCH_FRO`` relative Frobenius
    error of mesh=None's, leaf by leaf; expert parallelism's bitwise."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers

    cfg = get_config(arch_id).smoke
    gen = torch.Generator(cuda).manual_seed(1)
    p = layers.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.mlp)
    x = torch.randn((4, 64, cfg.d_model), generator=gen, device=cuda)
    ct = torch.randn((4, 64, cfg.d_model), generator=gen, device=cuda)
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, kind=cfg.mlp)
    names = sorted(p)
    leaves = [x.requires_grad_(True)] + [p[k].requires_grad_(True) for k in names]

    def grads(mesh):
        y, aux = layers.moe_apply(dict(zip(names, leaves[1:])), leaves[0],
                                  mesh=mesh, **kw)
        return torch.autograd.grad((y.float() * ct).sum() + aux, leaves)

    g0 = grads(None)
    g1 = grads(make_test_mesh(shape, device="cuda"))
    for name, a, b in zip(["x", *names], g1, g0):
        assert a.device.type == cuda.type and bool(torch.isfinite(a).all()), name
        if cfg.moe_experts % shape[1] == 0:
            assert torch.equal(a, b), name
        else:
            err = float((a - b).float().norm() / b.float().norm())
            assert err <= BRANCH_FRO, (name, err)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its ``main`` is not run)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_moe_train_step_on_card_equals_cpu_at_matched_routing(cuda):
    """mixtral's smoke config at ``[2, 512]`` (its 64-position window
    masks): the loss and every gradient on the card (K3's SIMT body at
    head dim 32, twice a layer: the forward, then the recompute) against
    the CPU's plain route, the card replaying the CPU's expert choices in
    its forward and its recompute (``chip_smoke.layer_routes``, keyed by
    layer): the loss within 5e-3 relative, each leaf within 5e-2 relative
    Frobenius error; each layer's recompute on the CPU routes as its
    forward did, and the card's own choices differ from the CPU's only at
    near-ties (``ROUTE_TIE_GAP``)."""
    from repro_torch.models import layers

    smoke = _chip_smoke()
    cfg = get_config("mixtral-8x7b").smoke
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    card = transformer.params_from_numpy(
        cfg, transformer.params_to_numpy(params), device=cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 513)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss_fn = lambda p, b: transformer.loss_fn(cfg, p, b)
    with smoke.layer_routes(layers, params) as cpu:
        c_loss, c_grads = value_and_grad(loss_fn, params, batch)
    assert cpu.calls == [2] * cfg.n_layers
    assert [int(d) for d in cpu.recompute_differ] == [0] * cfg.n_layers
    n = flash_attention.LAUNCHES
    with smoke.layer_routes(layers, card, replay=lambda i, j: cpu.forward[
            i].gate_idx.to(cuda)) as got:
        loss, grads = value_and_grad(
            loss_fn, card, {k: v.to(cuda) for k, v in batch.items()})
    assert flash_attention.LAUNCHES == n + 2 * cfg.n_layers
    assert got.calls == [2] * cfg.n_layers
    diffs = smoke.route_differences(
        cpu.forward, [layers.Routing(None, r.gate_idx.cpu(), None, None, None,
                                     r.cap) for r in got.forward])
    assert diffs["max_gap"] <= smoke.ROUTE_TIE_GAP, diffs
    assert abs(float(loss) - float(c_loss)) <= 5e-3 * abs(float(c_loss))
    for g, c in zip(tree_leaves(grads), tree_leaves(c_grads)):
        assert float(torch.linalg.vector_norm((g.cpu() - c).float())) <= \
            5e-2 * float(torch.linalg.vector_norm(c.float()))


def test_meta_route_matches_the_kernels_shapes(cuda):
    """Each kernel entry's meta route returns what the kernel returns on
    the card, and the card's call still launches the kernel."""
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((1, 600, 4, 64), generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn((1, 600, 2, 64), generator=g, device=cuda).to(torch.bfloat16)
    table = torch.randn((50, 8), generator=g, device=cuda)
    idx = torch.randint(0, 50, (40,), generator=g, device=cuda, dtype=torch.int32)
    ids = torch.sort(torch.randint(0, 9, (40,), generator=g, device=cuda,
                                   dtype=torch.int32)).values
    xk = torch.randn((5, 4, 6), generator=g, device=cuda)
    w = torch.randn((3, 4, 4), generator=g, device=cuda)
    bm = torch.randint(0, 2**31 - 1, (9, 4), generator=g, device=cuda,
                       dtype=torch.int32)
    eu = torch.randint(0, 9, (13,), generator=g, device=cuda, dtype=torch.int32)
    alive = torch.ones((13,), dtype=torch.bool, device=cuda)
    calls = [
        (flash_attention, lambda t: ops.flash_attention_heads(
            t[0], t[1], t[1], causal=True, window=None), (q, kv)),
        (segment_matmul, lambda t: ops.segment_matmul_gathered(
            t[0], t[1], t[2], 9, ids_sorted=True, mean=True), (table, idx, ids)),
        (cin, lambda t: ops.cin_layer(t[0], t[0], t[1]), (xk, w)),
        (peel_wave, lambda t: ops.peel_wave_gathered(t[0], t[1], t[1], t[2], 3),
         (bm, eu, alive)),
        (bitmap_support, lambda t: ops.bitmap_support_gathered(t[0], t[1], t[1]),
         (bm, eu)),
    ]
    for mod, fn, inputs in calls:
        before = mod.LAUNCHES
        on_card = fn(inputs)
        torch.cuda.synchronize()
        assert mod.LAUNCHES == before + 1, mod.__name__
        meta = fn(tuple(t.to("meta") for t in inputs))
        assert mod.LAUNCHES == before + 1, mod.__name__   # meta launches nothing
        outs = on_card if isinstance(on_card, tuple) else (on_card,)
        metas = meta if isinstance(meta, tuple) else (meta,)
        assert [(o.shape, o.dtype) for o in outs] == \
            [(m.shape, m.dtype) for m in metas], mod.__name__
