"""K3's plain version and the port's chunked attention against ``repro``:
the Pallas kernel body in interpret mode, ``repro``'s ``attention_ref`` and
its ``_chunked_attention``, on the same numpy inputs.

Tolerances: 2e-5 in fp32 (the same math with sums taken in another order;
the reference's own kernel sweep uses it) and 3e-2 in bf16 (outputs are
rounded to bf16, whose unit in the last place at |x| ~ 2 is 1.6e-2, so one
rounding apart is within it).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_kernel
from repro.models.layers import _chunked_attention as j_chunked
from repro_torch.kernels import flash_attention, ops, ref
from repro_torch.models.layers import _chunked_attention

TOL = {np.float32: 2e-5, jnp.bfloat16: 3e-2}
TORCH_DTYPE = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _qkv(rng, shape, dtype):
    """Inputs rounded to ``dtype`` once, handed to both frameworks."""
    arrs = [np.array(jnp.asarray(rng.normal(size=shape)).astype(dtype)
                     .astype(np.float32)) for _ in range(3)]
    jax_in = [jnp.asarray(a).astype(dtype) for a in arrs]
    torch_in = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrs]
    return jax_in, torch_in


def _close(got, exp, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("bh,sq,dh", [(1, 64, 16), (2, 300, 32), (4, 128, 64)])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_flash_attention_matches_pallas_kernel(bh, sq, dh, window, dtype):
    """The reference's own kernel sweep (tests/test_kernels.py): the port's
    ``ops.flash_attention`` on the CPU against the Pallas body."""
    rng = np.random.default_rng(bh * sq)
    (jq, jk, jv), (q, k, v) = _qkv(rng, (bh, sq, dh), dtype)
    exp = flash_attention_kernel(jq, jk, jv, causal=True, window=window,
                                 interpret=True, q_block=64, kv_block=64)
    n = flash_attention.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert flash_attention.LAUNCHES == n      # a CPU tensor launches nothing
    _close(got, exp, TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None), (False, 20)])
@pytest.mark.parametrize("sq,skv", [(100, 100), (37, 53)])
def test_attention_ref_matches_reference(causal, window, sq, skv):
    """Plain version against ``repro``'s, fp32, including Sq != Skv."""
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(2, sq, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, 16)).astype(np.float32)
    exp = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, window=window)
    _close(got, exp, 2e-5)


def test_padding_keys_stay_masked_without_causal():
    """R3: with ``causal=False`` and S not a multiple of the kv block, the
    Pallas kernel lets its zero-padded keys into the normaliser; the port
    follows ``attention_ref``, which has no padding."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 100, 16)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    exp = jref.attention_ref(jq, jk, jv, causal=False)
    pallas = flash_attention_kernel(jq, jk, jv, causal=False, interpret=True,
                                    q_block=64, kv_block=64)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    _close(got, exp, 2e-5)
    assert np.abs(np.asarray(pallas) - np.asarray(exp)).max() > 1e-2


def _attention_f64(q, k, v, window):
    """Causal GQA attention in float64 numpy: the truth both sides are held
    to, so that a failure names the side that moved."""
    group = q.shape[1] // k.shape[1]
    k, v = (np.repeat(x.astype(np.float64), group, axis=1) for x in (k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * q.shape[-1] ** -0.5
    pos = np.arange(q.shape[2])
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("window", [None, 48])
def test_chunked_attention_matches_reference(window):
    """``_chunked_attention`` with GQA (4 query heads over 2 KV heads),
    chunks that do not divide S, against ``repro``'s, fp32.  The reference
    is evaluated to completion before the port runs (JAX dispatches
    asynchronously and reads the numpy inputs in place), and each side is
    first held to a float64 truth, so a failure says which side moved."""
    rng = np.random.default_rng(0)
    b, hq, hkv, s, dh = 2, 4, 2, 200, 16
    q = rng.normal(size=(b, hq, s, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    exp = np.array(j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, q_chunk=64,
                             kv_chunk=64))
    got = _chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, window=window,
                             q_chunk=64, kv_chunk=64)
    truth = _attention_f64(q, k, v, window)
    np.testing.assert_allclose(exp, truth, rtol=2e-5, atol=2e-5,
                               err_msg="the reference moved")
    np.testing.assert_allclose(got.numpy(), truth, rtol=2e-5, atol=2e-5,
                               err_msg="the port moved")
    _close(got, exp, 2e-5)


def test_heads_entry_matches_flat_entry():
    """The model-layout entry (GQA read in place; on the CPU the chunked
    online softmax) equals the ``[BH, S, Dh]`` entry on repeated KV heads,
    in fp32 to 2e-5: the two differ only in summation order."""
    rng = np.random.default_rng(5)
    b, s, hq, hkv, dh = 2, 70, 4, 2, 32
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, dh))
                                .astype(np.float32))
               for h in (hq, hkv, hkv))
    got = ops.flash_attention_heads(q, k, v, window=16)

    def flat(x):
        x = x.repeat_interleave(hq // x.shape[2], dim=2)
        return x.transpose(1, 2).reshape(b * hq, s, dh)

    exp = ops.flash_attention(flat(q), flat(k), flat(v), window=16)
    torch.testing.assert_close(got.transpose(1, 2).reshape(b * hq, s, dh),
                               exp, rtol=2e-5, atol=2e-5)
