"""The port's kernel wrappers and plain versions against ``repro.kernels``:
the jnp references and the Pallas kernel bodies in interpret mode.  All
outputs are integers, so equality is bitwise (tolerance zero)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bitmap_support import bitmap_support_kernel
from repro.kernels.peel_wave import peel_wave_kernel
from repro_torch.kernels import bitmap_support, ops, peel_wave, ref

SHAPES = [(1, 1), (7, 3), (64, 32), (130, 37), (513, 129)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(rng, shape):
    """uint32 words with bit 31 forced on in a quarter of them."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    w[rng.random(shape) < 0.25] |= np.uint32(1 << 31)
    return w


def _t(x):
    """int32 torch view of uint32 host words (bits unchanged)."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _case(e, w):
    rng = np.random.default_rng(e * 1000 + w)
    return _words(rng, (e, w)), _words(rng, (e, w)), rng.random(e) < 0.8


def test_popcount32_every_bit():
    x = np.concatenate([np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32)),
                        np.array([0, 0xFFFFFFFF, 0x80000001, 0x7FFFFFFF],
                                 np.uint32)])
    got = ref.popcount32(_t(x)).numpy()
    np.testing.assert_array_equal(got, [1] * 32 + [0, 32, 2, 31])


@pytest.mark.parametrize("e,w", SHAPES)
def test_bitmap_support_matches_reference_and_pallas(e, w):
    a, b, _ = _case(e, w)
    got = ops.bitmap_support(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.bitmap_support_ref(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        got, np.asarray(bitmap_support_kernel(jnp.asarray(a), jnp.asarray(b),
                                              interpret=True)))


@pytest.mark.parametrize("e,w", SHAPES)
def test_peel_wave_matches_reference_and_pallas(e, w):
    a, b, alive = _case(e, w)
    ja, jb, jal = jnp.asarray(a), jnp.asarray(b), jnp.asarray(alive)
    for k in (2, 3, 7):
        sup, kill = ops.peel_wave(_t(a), _t(b), torch.from_numpy(alive),
                                  torch.tensor(k, dtype=torch.int32))
        for j_sup, j_kill in (jref.peel_wave_ref(ja, jb, jal, jnp.int32(k)),
                              peel_wave_kernel(ja, jb, jal, jnp.int32(k),
                                               interpret=True)):
            np.testing.assert_array_equal(sup.numpy(), np.asarray(j_sup))
            np.testing.assert_array_equal(kill.numpy(), np.asarray(j_kill))


@pytest.mark.parametrize("e,w", [(130, 37), (513, 129)])
def test_row_and_word_slabs_match_pallas(e, w):
    """Row blocks (K1, K2) and word slabs (K2, partial sums) select exactly
    what the Pallas kernels select, including a clamped out-of-range start."""
    a, b, alive = _case(e, w)
    ja, jb, jal = jnp.asarray(a), jnp.asarray(b), jnp.asarray(alive)
    for ro, rc in ((0, 64), (e // 3, e // 2), (e - 5, 20)):
        sup, kill = ops.peel_wave(_t(a), _t(b), torch.from_numpy(alive), 3,
                                  row_offset=ro, row_count=rc)
        j_sup, j_kill = peel_wave_kernel(ja, jb, jal, jnp.int32(3),
                                         interpret=True, row_offset=ro,
                                         row_count=rc)
        np.testing.assert_array_equal(sup.numpy(), np.asarray(j_sup))
        np.testing.assert_array_equal(kill.numpy(), np.asarray(j_kill))
        for wo, wc in ((0, w), (w // 3, w // 2), (w - 1, 1)):
            got = ops.bitmap_support(_t(a), _t(b), row_offset=ro, row_count=rc,
                                     word_offset=wo, word_count=wc)
            exp = bitmap_support_kernel(ja, jb, interpret=True, row_offset=ro,
                                        row_count=rc, word_offset=wo,
                                        word_count=wc)
            np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # partial supports over disjoint word slabs sum to the full count
    full = ops.bitmap_support(_t(a), _t(b))
    parts = sum(ops.bitmap_support(_t(a), _t(b), word_offset=s,
                                   word_count=min(16, w - s))
                for s in range(0, w, 16))
    np.testing.assert_array_equal(parts.numpy(), full.numpy())


@pytest.mark.parametrize("chunk", [None, 1, 50, 10_000])
def test_gathered_entries_equal_rows_entries(chunk):
    rng = np.random.default_rng(5)
    bm = _t(_words(rng, (300, 37)))
    eu = torch.from_numpy(rng.integers(0, 300, 777).astype(np.int32))
    ev = torch.from_numpy(rng.integers(0, 300, 777).astype(np.int32))
    alive = torch.from_numpy(rng.random(777) < 0.7)
    ra, rb = bm[eu.long()], bm[ev.long()]
    k = torch.tensor(6, dtype=torch.int32)
    for g, x in zip(ops.peel_wave_gathered(bm, eu, ev, alive, k, chunk=chunk),
                    ops.peel_wave(ra, rb, alive, k)):
        assert torch.equal(g, x)
    assert torch.equal(ops.bitmap_support_gathered(bm, eu, ev, chunk=chunk),
                       ops.bitmap_support(ra, rb))
    assert torch.equal(
        ops.bitmap_support_gathered(bm, eu, ev, chunk=chunk, word_offset=9,
                                    word_count=11),
        ops.bitmap_support(ra, rb, word_offset=9, word_count=11))


def test_cpu_tensors_take_the_plain_version_without_launching():
    """A CPU tensor never reaches a kernel: the launch counters stay at 0
    (and nothing needs nvcc), with kernels enabled or not."""
    peel_wave.LAUNCHES = bitmap_support.LAUNCHES = 0
    a, b, alive = _case(64, 32)
    for flag in (True, False):
        ops.use_kernels(flag)
        try:
            ops.peel_wave(_t(a), _t(b), torch.from_numpy(alive), 3)
            ops.peel_wave_gathered(_t(a), torch.arange(64, dtype=torch.int32),
                                   torch.arange(64, dtype=torch.int32),
                                   torch.from_numpy(alive), 3)
            ops.bitmap_support(_t(a), _t(b))
            ops.bitmap_support_gathered(_t(a), torch.zeros(3, dtype=torch.int32),
                                        torch.ones(3, dtype=torch.int32))
        finally:
            ops.use_kernels(True)
    assert peel_wave.LAUNCHES == 0 and bitmap_support.LAUNCHES == 0


def test_kernel_launchers_reject_cpu_tensors():
    """The CUDA launchers validate before touching a pointer: a CPU tensor
    raises instead of reaching the library (or a plain path)."""
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        bitmap_support.bitmap_support_cuda(a, a)
    with pytest.raises(ValueError):
        peel_wave.peel_wave_cuda(a, a, torch.ones(4, dtype=torch.bool), 3)
    assert peel_wave.LAUNCHES == 0 and bitmap_support.LAUNCHES == 0
