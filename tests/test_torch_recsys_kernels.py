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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _sorted_case(e, d, n, seed):
    """The sweep's inputs with sorted ids: a few ids outside ``[0, n)``
    (they sort first and last), empty segments where ids skip, and
    indices that wrap from the end."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(300, d)).astype(np.float32)
    idx = rng.integers(-300, 300, e).astype(np.int32)
    seg = np.sort(rng.integers(-2, n + 2, e)).astype(np.int32)
    return table, idx, seg


@pytest.mark.parametrize("e,d,n", SEG_SWEEP)
def test_sorted_entry_matches_pallas_kernel(no_launch, e, d, n):
    """The declared-sorted entry equals the sorting entry and ``repro``'s
    Pallas body on the rows ``jnp.take`` gathers (interpret mode)."""
    table, idx, seg = _sorted_case(e, d, n, e + d + n)
    rows = jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0)
    exp = segment_matmul_kernel(rows, jnp.asarray(seg), n, interpret=True)
    args = tuple(map(torch.from_numpy, (table, idx, seg))) + (n,)
    got = ops.segment_matmul_gathered(*args, ids_sorted=True)
    torch.testing.assert_close(got, ops.segment_matmul_gathered(*args),
                               rtol=0, atol=0)
    _close(got, exp, TOL[np.float32])


def test_sorted_entry_gives_nan_bags_as_jnp_take():
    """Indices outside ``[-R, R)`` make their (sorted) bags NaN, as
    ``jax.ops.segment_sum`` over ``jnp.take`` does; the others hold."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(6, 3)).astype(np.float32)
    idx = np.asarray([0, -1, 5, 6, -7, 2, 3], np.int32)
    seg = np.asarray([0, 0, 1, 2, 3, 4, 4], np.int32)
    exp = jax.ops.segment_sum(jnp.take(jnp.asarray(table), jnp.asarray(idx),
                                       axis=0), jnp.asarray(seg), 5)
    got = ops.segment_matmul_gathered(
        *map(torch.from_numpy, (table, idx, seg)), 5, ids_sorted=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                               atol=1e-6)
    assert np.isnan(got.numpy()[2:4]).all()
    assert not np.isnan(got.numpy()[[0, 1, 4]]).any()


@pytest.mark.parametrize("mean", [False, True])
def test_sorted_entry_raises_on_unsorted_ids(no_launch, mean):
    """A false declaration is loud: the plain version raises (the kernel
    writes NaN everywhere instead)."""
    table = torch.ones((4, 3))
    idx = torch.arange(4, dtype=torch.int32)
    seg = torch.tensor([0, 2, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="ascending"):
        ops.segment_matmul_gathered(table, idx, seg, 4, ids_sorted=True,
                                    mean=mean)
    ops.segment_matmul_gathered(table, idx, seg, 4, mean=mean)  # no claim


@pytest.mark.parametrize("e,d,n", SEG_SWEEP)
def test_mean_entry_matches_embedding_bag_mean(no_launch, e, d, n):
    """The fused mean equals ``repro``'s ``embedding_bag(mode="mean")`` at
    1e-6 (empty bags give 0, ids outside ``[0, n)`` count nowhere), on
    sorted and unsorted ids."""
    from repro.models.recsys import embedding_bag
    table, idx, seg = _sorted_case(e, d, n, e * n + d)
    for ids, declared in ((seg, True), (np.random.default_rng(e).permutation(
            seg), False)):
        exp = embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                            jnp.asarray(ids), n, mode="mean")
        got = ops.segment_matmul_gathered(
            *map(torch.from_numpy, (table, idx, ids)), n,
            ids_sorted=declared, mean=True)
        assert got.shape == (n, d) and got.dtype == torch.float32
        _close(got, exp, 1e-6)


def test_mean_entry_casts_once_in_fp16():
    """In fp16 the mean divides the fp32 sum and rounds once."""
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float16))
    idx = torch.from_numpy(rng.integers(0, 50, 40).astype(np.int32))
    seg = torch.from_numpy(np.sort(rng.integers(0, 6, 40)).astype(np.int32))
    got = ops.segment_matmul_gathered(table, idx, seg, 6, ids_sorted=True,
                                      mean=True)
    total = ref.segment_matmul_ref(table[idx.long()].float(), seg, 6)
    count = torch.bincount(seg.long(), minlength=6).clamp(min=1)
    assert got.dtype == torch.float16
    torch.testing.assert_close(got, (total / count[:, None]).half(), rtol=0,
                               atol=0)


@pytest.mark.parametrize("d,itemsize,ptr,unit", [
    (10, 4, 0, 8),        # xDeepFM's 40-byte rows: 8-byte loads
    (4, 4, 0, 16), (64, 4, 256, 16), (3, 4, 0, 4), (10, 4, 4, 4),
    (8, 2, 0, 16), (3, 2, 0, 2), (6, 2, 8, 4)])
def test_load_unit_is_the_widest_aligned(d, itemsize, ptr, unit):
    assert segment_matmul.load_unit(d, itemsize, ptr, 512) == unit


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


# xDeepFM's CIN layers on the path: (b, h, m, d, o) of layers 1 and 2 (3
# is layer 2's shape) at serve_p99 and serve_bulk
P99_LAYERS = [(512, 40, 40, 10, 200), (512, 200, 40, 10, 200)]
BULK_LAYERS = [(262_144, 40, 40, 10, 200), (262_144, 200, 40, 10, 200)]


@pytest.mark.parametrize("shape", P99_LAYERS)
def test_cin_plan_fills_the_wave_at_p99(shape):
    """40 row tiles: split over k so the one wave is >= 85% full."""
    row_tiles, out_tiles, slices = cin.plan(*shape)
    blocks = row_tiles * out_tiles * slices
    last = blocks - cin.H100_SMS * ((blocks - 1) // cin.H100_SMS)
    assert (row_tiles, out_tiles) == (40, 1) and slices > 1
    assert last >= 0.85 * cin.H100_SMS


@pytest.mark.parametrize("shape", BULK_LAYERS)
def test_cin_plan_takes_one_slice_at_bulk(shape):
    assert cin.plan(*shape) == (20_480, 1, 1)


@pytest.mark.parametrize("b,h,m,o,d", CIN_SWEEP + [(3, 2, 1, 70, 5)])
def test_cin_plan_is_valid_on_the_sweep(b, h, m, o, d):
    """Every row and output covered, 1 <= S <= min(h, MAX_SLICES), and the
    slices' ranges of whole h values cover [0, h) in order."""
    row_tiles, out_tiles, slices = cin.plan(b, h, m, d, o)
    assert row_tiles * cin.ROW_TILE >= b * d > (row_tiles - 1) * cin.ROW_TILE
    assert out_tiles * cin.OUT_TILE >= o > (out_tiles - 1) * cin.OUT_TILE
    assert 1 <= slices <= min(h, cin.MAX_SLICES)
    if row_tiles * out_tiles < cin.H100_SMS:
        assert row_tiles * out_tiles * slices <= cin.H100_SMS
    ranges = cin.h_ranges(h, slices)
    assert ranges[0][0] == 0 and ranges[-1][1] == h
    assert all(lo < hi for lo, hi in ranges)
    assert all(prev[1] == nxt[0] for prev, nxt in zip(ranges, ranges[1:]))


def test_cin_plan_pads_at_most_5_percent_at_o_200():
    _, out_tiles, _ = cin.plan(512, 200, 40, 10, 200)
    assert 1 - 200 / (out_tiles * cin.OUT_TILE) <= 0.05


def test_cin_split_k_order_of_sums_matches_pallas_kernel():
    """The kernel's order of sums at p99's plan, emulated on the CPU: S
    partial einsums over the plan's ranges of h (all of m), added in slice
    order, then relu; against the Pallas body in interpret mode and
    ``repro``'s ``cin_layer_ref`` at the reference's 2e-5."""
    slices = cin.plan(*P99_LAYERS[1])[2]
    assert slices > 1
    b, h, m, o, d = 8, 200, 40, 200, 10
    rng = np.random.default_rng(18)
    xk = rng.normal(size=(b, h, d)).astype(np.float32)
    x0 = rng.normal(size=(b, m, d)).astype(np.float32)
    w = (rng.normal(size=(o, h, m)) / np.sqrt(h * m)).astype(np.float32)
    txk, tx0, tw = map(torch.from_numpy, (xk, x0, w))
    total = None
    for lo, hi in cin.h_ranges(h, slices):
        part = torch.einsum("bhd,bmd,ohm->bod", txk[:, lo:hi], tx0,
                            tw[:, lo:hi])
        total = part if total is None else total + part
    got = torch.relu(total)
    exp = cin_layer_kernel(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w),
                           interpret=True, b_block=32, d_block=8)
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
