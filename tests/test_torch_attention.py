"""K3's plain version and the port's chunked attention against ``repro``:
the Pallas kernel body in interpret mode, ``repro``'s ``attention_ref`` and
its ``_chunked_attention``, on the same numpy inputs.

Tolerances: 2e-5 in fp32 (the same math with sums taken in another order;
the reference's own kernel sweep uses it) and 3e-2 in bf16 (outputs are
rounded to bf16, whose unit in the last place at |x| ~ 2 is 1.6e-2, so one
rounding apart is within it).  The card's bf16 tensor-core body (``wgmma``)
cannot run here; a plain emulation of its roundings is held to the Pallas
body instead, at the sweep's 3e-2 and at the path's ``rtol=1.6e-2,
atol=1e-3``.
"""
import functools

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("dtype,dh,body", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 16, "simt"),
    (torch.float32, 32, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt")])
def test_body_for_picks_the_body(dtype, dh, body):
    """bf16 at head dims 64, 128 and 256 runs on the tensor cores; fp32
    (held to 2e-5) and the other bf16 head dims run the SIMT body."""
    assert flash_attention.body_for(dtype, dh) == body


def test_tma_refusal_names_what_a_tensor_map_cannot_describe():
    """The wgmma body's layout check, pure Python: a contiguous bf16
    ``[B, S, H, 128]`` maps; a base off the 16-byte grid does not."""
    x = torch.zeros(2 * 300 * 4 * 128 + 8, dtype=torch.bfloat16)
    assert flash_attention._tma_refusal("q", x[:-8].view(2, 300, 4, 128)) is None
    why = flash_attention._tma_refusal("q", x[1:-7].view(2, 300, 4, 128))
    assert why is not None and "16-byte" in why


def test_tma_refusal_at_head_dim_256():
    """At head dim 256 (gemma-2b's MQA layout, one KV head) a contiguous
    bf16 ``[B, S, H, 256]`` maps, whatever S; a base off the 16-byte grid
    does not, and the refusal names the tensor."""
    x = torch.zeros(2 * 301 * 256 + 8, dtype=torch.bfloat16)
    for s in (300, 301):
        assert flash_attention._tma_refusal(
            "k", x[:2 * s * 256].view(2, s, 1, 256)) is None
    why = flash_attention._tma_refusal("k", x[3:3 + 2 * 300 * 256]
                                       .view(2, 300, 1, 256))
    assert why is not None and why.startswith("k:") and "16-byte" in why


def _wgmma_emulation(q, k, v, *, causal, window, split_p=True):
    """The wgmma body's roundings in plain float32 torch: bf16 q/k/v, S and
    its scale in fp32, P in fp32 from the row max, ``l`` summed from the
    unrounded P, P in bf16 before P V, the output divided by ``l`` (0 where
    ``l`` is 0) and rounded to bf16.  With ``split_p`` (the body) P enters
    as hi, P cut to its top 16 bits, plus lo = bf16(P - hi); without it, as
    one rounding to bf16."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    pos = torch.arange(q.shape[1])
    live = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool)
    if causal:
        live &= pos[:, None] >= pos[None, :]
    if window is not None:
        live &= (pos[:, None] - pos[None, :]) < window
    s = s.masked_fill(~live, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(-1, keepdim=True)
    if split_p:
        hi = (p.view(torch.int32) & -65536).view(torch.float32)
        o = (torch.einsum("bqk,bkd->bqd", hi, v.float())
             + torch.einsum("bqk,bkd->bqd", (p - hi).bfloat16().float(),
                            v.float()))
    else:
        o = torch.einsum("bqk,bkd->bqd", p.bfloat16().float(), v.float())
    return torch.where(l == 0, 0.0, o / l).bfloat16()


@pytest.mark.parametrize("bh,sq,dh", [(1, 64, 16), (2, 300, 32), (4, 128, 64)])
@pytest.mark.parametrize("window", [None, 32])
def test_wgmma_roundings_match_pallas_kernel_on_the_sweep(bh, sq, dh, window):
    """The reference's bf16 sweep at 3e-2: the tensor-core body's roundings
    against the Pallas body in interpret mode."""
    rng = np.random.default_rng(bh * sq)
    (jq, jk, jv), (q, k, v) = _qkv(rng, (bh, sq, dh), jnp.bfloat16)
    exp = flash_attention_kernel(jq, jk, jv, causal=True, window=window,
                                 interpret=True, q_block=64, kv_block=64)
    _close(_wgmma_emulation(q, k, v, causal=True, window=window), exp, 3e-2)


@functools.lru_cache(maxsize=None)
def _path_case(dh, window):
    """``[2, 512, dh]`` bf16 causal: the torch inputs and the Pallas body's
    output (interpret mode, 128-row query blocks and the key tile of the
    card's body at ``dh``: 128 keys, 64 at head dim 256)."""
    rng = np.random.default_rng(7 if dh == 128 else dh)
    (jq, jk, jv), qkv = _qkv(rng, (2, 512, dh), jnp.bfloat16)
    exp = flash_attention_kernel(jq, jk, jv, causal=True, window=window,
                                 interpret=True, q_block=128,
                                 kv_block=64 if dh == 256 else 128)
    return qkv, np.asarray(exp, np.float32)


def _path_excess(got, exp):
    """Largest |got - exp| over the path's limit ``1e-3 + 1.6e-2 |exp|``."""
    d = np.abs(got.float().numpy() - exp)
    return float((d / (1e-3 + 1.6e-2 * np.abs(exp))).max())


@pytest.mark.parametrize("dh,window", [
    pytest.param(128, None, id="None"), pytest.param(128, 128, id="128"),
    pytest.param(256, None, id="d256-None"),
    pytest.param(256, 128, id="d256-128")])
def test_wgmma_roundings_hold_the_path_tolerance(dh, window):
    """At head dims 128 and 256, the path's ``rtol=1.6e-2, atol=1e-3``
    (about one bf16 step of each value) holds with P as hi + lo (P - (hi +
    lo) is at most 2^-16 P, whatever the head dim or the key tile)."""
    (q, k, v), exp = _path_case(dh, window)
    got = _wgmma_emulation(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(), exp, rtol=1.6e-2,
                               atol=1e-3)
    assert _path_excess(got, exp) < 0.5


def test_one_bf16_rounding_of_p_misses_the_path_tolerance():
    """Why P enters the P V product as two bf16 terms: rounded once, its
    2^-9 error is relative to each weight, not to the output, and where
    ``sum p v`` cancels in an early row the error exceeds ``1e-3 + 1.6e-2
    |o|`` (the card's run of the single-term body showed the same)."""
    (q, k, v), exp = _path_case(128, 128)
    got = _wgmma_emulation(q, k, v, causal=True, window=128, split_p=False)
    assert _path_excess(got, exp) > 1.0


def test_one_bf16_rounding_of_p_misses_the_path_tolerance_at_head_dim_256():
    """The same at head dim 256 with 64-key tiles: one rounding of P exceeds
    the path's limit, so the D = 256 body keeps P as hi + lo too."""
    (q, k, v), exp = _path_case(256, 128)
    got = _wgmma_emulation(q, k, v, causal=True, window=128, split_p=False)
    assert _path_excess(got, exp) > 1.0
