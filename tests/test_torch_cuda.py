"""The port's CUDA kernels on the card: each held bitwise against its plain
PyTorch version, and the engine on the card equal to the engine on the CPU.

These tests need a CUDA device and ``nvcc`` and skip elsewhere; run them on
the machine with the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
They import neither JAX nor ``repro``.
"""
import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.kernels import bitmap_support, ops, peel_wave, ref

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
