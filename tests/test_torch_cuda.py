"""The port's CUDA kernels on the card: each held against its plain PyTorch
version (K1/K2 bitwise, K3, K4 and K5 within stated tolerances), and the
truss engine, the LM prefill and the xDeepFM scores on the card equal to
the same on the CPU; the WAL-backed truss service on the card launching
K1 through a fused flush and K2 through its recompute fallback, and its
snapshots restoring bitwise.

These tests need a CUDA device and ``nvcc`` and skip elsewhere; run them on
the machine with the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
They import neither JAX nor ``repro``.
"""
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
from repro_torch.models import recsys, transformer
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
