"""The port's int8 KV cache (``repro_torch.serving.kv_quant``) against
``repro.serving.kv_quant`` on the same numpy inputs, mirroring the
reference's own checks (``tests/test_extras.py``: the attention error and
the footprint, the ring-buffer update).

Tolerances: the int8 values and the fp32 scales equal the reference's
bitwise (``torch.round`` and ``jnp.round`` both round half to even, and
the scale is one fp32 max and one division); the dequantized values and
``attend_quant`` equal the reference's within 1e-6 (fp32 sums in another
order); ``attend_quant`` within the reference's 1e-2 of fp32 attention
over the unquantized cache.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.serving import kv_quant as jq
from repro_torch.serving import kv_quant as tq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(seed, shape=(2, 32, 2, 16), scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "wide", "zero_rows", "bf16", "halves"])
def test_quantize_kv_equals_reference_bitwise(case):
    x = _kv(0, (3, 17, 4, 32), scale=1e3 if case == "wide" else 1.0)
    if case == "zero_rows":
        x[:, ::3] = 0.0                       # scale clamps to 1e-8
    if case == "halves":
        # entries at exact halves of the scale: round half to even
        x[..., 0] = 127.0
        x[..., 1:] = np.random.default_rng(1).integers(
            -254, 255, x[..., 1:].shape) / 2.0
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if case == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    jv, js = jq.quantize_kv(jx)
    tv, ts = tq.quantize_kv(tx)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            tq.dequantize_kv(tv, ts, dtype).float().numpy(),
            np.asarray(jq.dequantize_kv(jv, js, jdtype), np.float32))


@pytest.mark.parametrize("valid_rows", [False, True])
def test_int8_kv_cache_accuracy(valid_rows):
    """The reference's ``test_int8_kv_cache_accuracy`` on the port, and
    ``attend_quant`` against the reference's; with ``valid_rows`` a
    per-row ``[B, C]`` mask hides each row's last slots."""
    b, c, n_kv, dh, hq = 2, 32, 2, 16, 4
    k, v = _kv(0, (b, c, n_kv, dh)), _kv(1, (b, c, n_kv, dh))
    q = _kv(2, (b, hq, dh))
    valid = np.ones((b, c), bool) if valid_rows else np.ones((c,), bool)
    if valid_rows:
        valid[0, 20:] = False
        valid[1, 9:] = False
    kq, ks = tq.quantize_kv(torch.from_numpy(k))
    vq, vs = tq.quantize_kv(torch.from_numpy(v))
    layer = {"kq": kq, "ks": ks, "vq": vq, "vs": vs}
    got = tq.attend_quant(torch.from_numpy(q), layer, torch.from_numpy(valid),
                          n_kv, dh)
    jl = {n: jnp.asarray(t.numpy()) for n, t in layer.items()}
    exp = jq.attend_quant(jnp.asarray(q), jl, jnp.asarray(valid), n_kv, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)
    # fp32 attention over the unquantized cache
    qg = q.reshape(b, n_kv, hq // n_kv, dh)
    s = np.einsum("bkgd,bckd->bkgc", qg, k) * dh ** -0.5
    mask = valid[:, None, None, :] if valid_rows else valid
    s = np.where(mask, s, -1e30)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    ref = np.einsum("bkgc,bckd->bkgd", w, v).reshape(b, hq, dh)
    assert np.abs(got.numpy() - ref).max() < 1e-2
    # footprint: int8 + a per-row fp32 scale is under a third of fp32
    raw = k.size * 4
    quant = kq.numel() * kq.element_size() + ks.numel() * ks.element_size()
    assert quant < raw / 3


def test_init_quant_cache_matches_reference():
    jc = jq.init_quant_cache(n_layers=2, batch=3, cache_len=4, n_kv=2, head_dim=8)
    tc = tq.init_quant_cache(n_layers=2, batch=3, cache_len=4, n_kv=2,
                             head_dim=8, device="cpu")
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
        assert not tc[name].any()


@pytest.mark.parametrize("layer", [None, 1])
def test_kv_quant_ring_buffer_update(layer):
    """The reference's ``test_kv_quant_ring_buffer_update`` on the port:
    one token written at ring slot ``5 % 4`` (all layers, or one), in
    place; equal to the reference's cache bitwise; other slots and layers
    untouched."""
    rng = np.random.default_rng(1)
    shape = (3, 2, 8) if layer is not None else (2, 3, 2, 8)
    k_new = rng.normal(size=shape).astype(np.float32)
    v_new = rng.normal(size=shape).astype(np.float32)
    jc = jq.init_quant_cache(n_layers=2, batch=3, cache_len=4, n_kv=2, head_dim=8)
    tc = tq.init_quant_cache(n_layers=2, batch=3, cache_len=4, n_kv=2,
                             head_dim=8, device="cpu")
    before = {n: t for n, t in tc.items()}
    jc = jq.update_quant_cache(jc, layer, jnp.asarray(k_new), jnp.asarray(v_new),
                               jnp.int32(5 % 4))
    out = tq.update_quant_cache(tc, layer, torch.from_numpy(k_new),
                                torch.from_numpy(v_new), 5 % 4)
    assert out is tc and all(out[n] is before[n] for n in tc)
    for name in jc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    sl = (slice(None), slice(None), 1) if layer is None else (layer, slice(None), 1)
    back = tq.dequantize_kv(tc["kq"][sl], tc["ks"][sl], torch.float32)
    np.testing.assert_allclose(back.numpy(), k_new, rtol=2e-2, atol=2e-2)
    assert not tc["kq"][:, :, 0].any() and not tc["vq"][:, :, 2:].any()
    if layer is not None:
        assert not tc["kq"][0].any()
