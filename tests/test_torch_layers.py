"""The port's layers against ``repro.models.layers`` on the same numpy
inputs and parameters: norms, RoPE, the three MLP kinds, both branches of
``attention_apply`` (prefill; decode with a ring-buffer wrap) and the MoE
layer (``tests/test_torch_moe.py`` holds its routing and the MoE archs).

Tolerances: fp32 paths 1e-5 (the same math, sums in another order).  Paths
that compute in bf16 (matmuls, activations) may round one bf16 step apart
where the two frameworks' fp32 sums differ in the last bit: 2**-7 relative
(one bf16 unit in the last place is 2**-8 of the value) plus an absolute
2e-2 for values near zero, after a matmul of these widths.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.models import layers as tl

BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2e-2
LM_ARCHS = ["qwen3-0.6b", "gemma-2b", "starcoder2-7b", "mixtral-8x7b",
            "llama4-scout-17b-a16e"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.array(a, np.float32)).astype(dtype)


def _bf16(a):
    """numpy values rounded to bf16 once, so both sides start equal."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply_matches_reference(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=48).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    exp = jl.norm_apply({k: _j(v) for k, v in p.items()}, _j(x), kind)
    got = tl.norm_apply({k: _t(v) for k, v in p.items()}, _t(x), kind)
    np.testing.assert_allclose(_np(got), _np(exp), rtol=1e-5, atol=1e-5)
    # bf16 in, bf16 out: the fp32 math rounds once at the end
    xb = _bf16(x)
    exp = jl.norm_apply({k: _j(v) for k, v in p.items()}, _j(xb, jnp.bfloat16), kind)
    got = tl.norm_apply({k: _t(v) for k, v in p.items()}, _t(xb, torch.bfloat16), kind)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(exp), rtol=BF16_RTOL, atol=1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 30, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(30), np.arange(100, 130)]).astype(np.int32)
    exp = jl.rope(_j(x), jnp.asarray(pos), theta)
    got = tl.rope(_t(x), torch.from_numpy(pos), theta)
    # sin/cos of angles up to 130 rad: the libraries' range reductions
    # differ in the last bits
    np.testing.assert_allclose(_np(got), _np(exp), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("end", [4096, 32767, 524287])
@pytest.mark.parametrize("head_dim,theta", [(128, 1e6), (256, 1e4),
                                            (128, 1e5), (128, 5e5)])
def test_rope_at_long_positions_matches_reference(head_dim, theta, end):
    """RoPE at the LM configs' (head dim, theta) on 64 positions ending at
    ``end`` (``decode_32k``'s last position, ``long_500k``'s), unit-normal
    fp32 input: within 2e-6 of the reference.  The angle is the position
    times the frequency, so a frequency one ulp off moves the output by up
    to ~1e-2 at 524,287; the two libraries' cos/sin of one fp32 angle agree
    within ~6e-8."""
    rng = np.random.default_rng(head_dim + end)
    x = rng.normal(size=(64, 2, head_dim)).astype(np.float32)
    pos = np.arange(end - 63, end + 1, dtype=np.int32)
    exp = jl.rope(_j(x), jnp.asarray(pos), theta)
    got = tl.rope(_t(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), _np(exp), rtol=0, atol=2e-6)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_rope_frequency_table_equals_reference_bitwise(arch, smoke):
    """``rope_freqs`` at each LM config's head dim and theta, full and smoke,
    equals the reference's fp32 table ``theta ** (-arange(half) / half)``
    bit for bit, and is cached: a second call returns the same tensor."""
    cfg = get_config(arch).smoke if smoke else get_config(arch).model
    jcfg = jget(arch).smoke if smoke else jget(arch).model
    assert (cfg.head_dim, cfg.rope_theta) == (jcfg.head_dim, jcfg.rope_theta)
    half = cfg.head_dim // 2
    exp = np.asarray(jcfg.rope_theta ** (
        -jnp.arange(0, half, dtype=jnp.float32) / half))
    got = tl.rope_freqs(half, cfg.rope_theta, "cpu")
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), exp)
    assert tl.rope_freqs(half, cfg.rope_theta, torch.device("cpu")) is got


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches_reference(kind):
    rng = np.random.default_rng(2)
    d, f = 64, 128
    jp = jl.mlp_init(jax.random.PRNGKey(0), d, f, kind)
    p = {k: np.asarray(v) for k, v in jp.items()}
    x = _bf16(rng.normal(size=(2, 7, d)))
    exp = jl.mlp_apply(jp, _j(x, jnp.bfloat16), kind)
    got = tl.mlp_apply({k: _t(v) for k, v in p.items()},
                       _t(x, torch.bfloat16), kind)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(exp), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def _attn_case(qk_norm: bool, seed: int = 3):
    d, hq, hkv, dh = 64, 4, 2, 16
    jp = jl.attention_init(jax.random.PRNGKey(seed), d, hq, hkv, dh, qk_norm)
    p = jax.tree.map(np.asarray, jp)
    tp = jax.tree.map(_t, p)
    kw = dict(n_heads=hq, n_kv=hkv, head_dim=dh, qk_norm=qk_norm,
              rope_theta=1e4)
    return jp, tp, kw, d


@pytest.mark.parametrize("qk_norm,window", [(True, None), (False, 24)])
def test_attention_prefill_matches_reference(qk_norm, window):
    jp, tp, kw, d = _attn_case(qk_norm)
    rng = np.random.default_rng(4)
    x = _bf16(rng.normal(size=(2, 70, d)))
    pos = np.broadcast_to(np.arange(70, dtype=np.int32), (2, 70))
    exp, _ = jl.attention_apply(jp, _j(x, jnp.bfloat16), jnp.asarray(pos),
                                window=window, **kw)
    got, cache = tl.attention_apply(tp, _t(x, torch.bfloat16),
                                    torch.from_numpy(pos.copy()),
                                    window=window, **kw)
    assert cache is None and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(exp), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("qk_norm,window,c", [(True, None, 32), (False, 8, 8)])
def test_attention_decode_matches_reference(qk_norm, window, c):
    """Twenty decode steps; with ``window=8`` over an 8-slot cache the ring
    buffer wraps twice.  Each step's output and the final cache agree."""
    jp, tp, kw, d = _attn_case(qk_norm, seed=5)
    rng = np.random.default_rng(6)
    b = 2
    jk = jnp.zeros((b, c, 2, 16), jnp.bfloat16)
    jv = jnp.zeros((b, c, 2, 16), jnp.bfloat16)
    tk = torch.zeros((b, c, 2, 16), dtype=torch.bfloat16)
    tv = torch.zeros((b, c, 2, 16), dtype=torch.bfloat16)
    for pos in range(20):
        x = _bf16(rng.normal(size=(b, 1, d)))
        positions = np.full((b, 1), pos, np.int32)
        exp, (jk, jv) = jl.attention_apply(
            jp, _j(x, jnp.bfloat16), jnp.asarray(positions), window=window,
            cache=(jk, jv), cache_pos=jnp.int32(pos), **kw)
        got, (tk2, tv2) = tl.attention_apply(
            tp, _t(x, torch.bfloat16), torch.from_numpy(positions),
            window=window, cache=(tk, tv), cache_pos=pos, **kw)
        assert tk2 is tk and tv2 is tv            # written in place
        np.testing.assert_allclose(_np(got), _np(exp), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
    np.testing.assert_allclose(_np(tk), _np(jk), rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_moe_apply_matches_reference(kind):
    """The MoE layer in bf16 at widths of its own (4 experts, top-2, an odd
    sequence length, so the per-row capacity is ``ceil(1.25 · 33 · 2 /
    4) = 21``): output and aux loss against the reference's."""
    d, ff, e, k = 48, 64, 4, 2
    jp = jl.moe_init(jax.random.PRNGKey(3), d, ff, e, kind)
    tp = {n: _t(v) for n, v in jp.items()}
    x = _bf16(np.random.default_rng(9).normal(size=(3, 33, d)))
    exp, jaux = jl.moe_apply(jp, _j(x, jnp.bfloat16), n_experts=e, top_k=k,
                             kind=kind)
    got, aux = tl.moe_apply(tp, _t(x, torch.bfloat16), n_experts=e, top_k=k,
                            kind=kind)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 33, d)
    np.testing.assert_allclose(_np(got), _np(exp), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    assert abs(float(aux) - float(jaux)) <= BF16_RTOL * abs(float(jaux))
