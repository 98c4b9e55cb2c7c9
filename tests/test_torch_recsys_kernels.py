"""K4 (segment sum) and K5 (CIN layer) of the port on the CPU against
``repro``'s Pallas bodies in interpret mode, on the reference's sweeps
(``tests/test_kernels.py``, ``tests/test_extras.py``) with the same numpy
inputs handed to both.

Tolerances are the reference's own: K4 1e-5 in fp32 and 2e-2 in fp16 (the
Pallas body sums a one-hot matmul in fp16; the port sums in fp32 and
rounds once), K5 2e-5 (fp32, sums in another order).  On CPU tensors the
wrappers take their plain versions and launch nothing.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.cin import cin_layer_kernel
from repro.kernels.segment_matmul import segment_matmul_kernel
from repro_torch.kernels import cin, ops, ref, segment_matmul

SEG_SWEEP = [(10, 4, 3), (100, 16, 17), (1000, 64, 77), (513, 32, 128),
             (257, 8, 1)]
CIN_SWEEP = [(8, 5, 7, 11, 6), (64, 40, 40, 200, 10), (130, 8, 8, 16, 16)]
TOL = {np.float32: 1e-5, np.float16: 2e-2}
TORCH_DTYPE = {np.float32: torch.float32, np.float16: torch.float16}


@pytest.fixture
def no_launch():
    """Every K4/K5 wrapper call in the test stays off the kernels."""
    n = segment_matmul.LAUNCHES, cin.LAUNCHES
    yield
    assert (segment_matmul.LAUNCHES, cin.LAUNCHES) == n


def _close(got, exp, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("e,d,n", SEG_SWEEP)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_segment_matmul_matches_pallas_kernel(no_launch, e, d, n, dtype):
    rng = np.random.default_rng(e + d + n)
    m = rng.normal(size=(e, d)).astype(dtype)
    seg = rng.integers(0, n, size=(e,), dtype=np.int32)
    exp = segment_matmul_kernel(jnp.asarray(m), jnp.asarray(seg), n,
                                interpret=True)
    got = ops.segment_matmul(torch.from_numpy(m), torch.from_numpy(seg), n)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (n, d)
    _close(got, exp, TOL[dtype])


@pytest.mark.parametrize("seg", [
    [0, 1, 2, 3, 4, 4, 4, 99],             # the reference's OOB padding
    [-1, 0, 4, -7, 2, 5, 2, 0],            # negative ids and id == n
    [4, 4, 3, 0, 1, 0, 3, 2],              # unsorted
    [3, 3, 3, 0, 0, 0, 0, 0],              # empty segments 1, 2, 4
])
def test_segment_matmul_drops_out_of_range_ids(no_launch, seg):
    rng = np.random.default_rng(len(seg))
    m = rng.normal(size=(8, 4)).astype(np.float32)
    seg = np.asarray(seg, np.int32)
    exp = jax.ops.segment_sum(jnp.asarray(m), jnp.asarray(seg), 5)
    pallas = segment_matmul_kernel(jnp.asarray(m), jnp.asarray(seg), 5,
                                   interpret=True)
    got = ops.segment_matmul(torch.from_numpy(m), torch.from_numpy(seg), 5)
    _close(got, exp, 1e-6)
    _close(got, pallas, 1e-5)


@pytest.mark.parametrize("e,d,n", SEG_SWEEP)
def test_gathered_entry_equals_rows_entry(no_launch, e, d, n):
    rng = np.random.default_rng(e * d)
    table = torch.from_numpy(rng.normal(size=(300, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 300, e).astype(np.int32))
    seg = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    got = ops.segment_matmul_gathered(table, idx, seg, n)
    torch.testing.assert_close(got, ops.segment_matmul(table[idx], seg, n),
                               rtol=0, atol=0)


def test_gathered_entry_takes_rows_as_jnp_take():
    """Negative indices count from the end; one outside ``[-R, R)`` makes
    its row NaN, as ``jnp.take`` fills it."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(6, 3)).astype(np.float32)
    idx = np.asarray([0, -1, 5, 6, -7, 2], np.int32)
    seg = np.asarray([0, 0, 1, 2, 3, 4], np.int32)
    exp = jax.ops.segment_sum(jnp.take(jnp.asarray(table), jnp.asarray(idx),
                                       axis=0), jnp.asarray(seg), 5)
    got = ops.segment_matmul_gathered(*map(torch.from_numpy,
                                           (table, idx, seg)), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                               atol=1e-6)
    assert np.isnan(got.numpy()[2:4]).all()


@pytest.mark.parametrize("b,h,m,o,d", CIN_SWEEP + [(8, 200, 40, 200, 10)])
def test_cin_layer_matches_pallas_kernel(no_launch, b, h, m, o, d):
    """The reference's sweep plus one xDeepFM layer-2 shape at B = 8."""
    rng = np.random.default_rng(b + h)
    xk = rng.normal(size=(b, h, d)).astype(np.float32)
    x0 = rng.normal(size=(b, m, d)).astype(np.float32)
    w = (rng.normal(size=(o, h, m)) * 0.1).astype(np.float32)
    if h == 200:     # a layer's scale: w ~ 1 / sqrt(H M), as init_params
        w = (rng.normal(size=(o, h, m)) / np.sqrt(h * m)).astype(np.float32)
    exp = cin_layer_kernel(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w),
                           interpret=True, b_block=32, d_block=8)
    got = ops.cin_layer(*map(torch.from_numpy, (xk, x0, w)))
    assert got.shape == (b, o, d) and got.dtype == torch.float32
    _close(got, exp, 2e-5)
    _close(got, jref.cin_layer_ref(jnp.asarray(xk), jnp.asarray(x0),
                                   jnp.asarray(w)), 2e-5)


def test_plain_versions_match_reference_refs():
    """``ref.segment_matmul_ref`` and ``ref.cin_layer_ref`` against
    ``repro``'s, including an fp16 cast-once check."""
    rng = np.random.default_rng(7)
    m = rng.normal(size=(64, 5)).astype(np.float16)
    seg = rng.integers(-2, 12, 64).astype(np.int32)
    got = ref.segment_matmul_ref(torch.from_numpy(m), torch.from_numpy(seg), 10)
    exp = jref.segment_matmul_ref(jnp.asarray(m), jnp.asarray(seg), 10)
    assert got.dtype == torch.float16
    _close(got, exp, 2e-2)
    xk = rng.normal(size=(4, 3, 5)).astype(np.float32)
    w = rng.normal(size=(6, 3, 3)).astype(np.float32)
    _close(ref.cin_layer_ref(*map(torch.from_numpy, (xk, xk, w))),
           jref.cin_layer_ref(jnp.asarray(xk), jnp.asarray(xk),
                              jnp.asarray(w)), 2e-5)


def test_launchers_reject_cpu_tensors():
    """The CUDA launchers validate before touching a pointer."""
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        segment_matmul.segment_sum_cuda(x, torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        cin.cin_layer_cuda(x[None], x[None], torch.zeros((2, 4, 4)))
