"""The digest body of K1 and K2 (``csrc/bitmap_popcount.cu``), emulated in
plain torch: mark the rows of live slots, digest each needed row's nonzero
words (capacity ``C``, ascending, slab-relative), count ``nnz``, probe from
the sparser endpoint (ties to ``a``) where it fits in ``C``, and stream
both rows where neither does.  The emulation is held bitwise against the
Pallas kernels of ``repro`` in interpret mode on the gathered rows and
against the port's plain versions; every branch of the plan is reached.
The kernel itself runs on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.bitmap_support import bitmap_support_kernel
from repro.kernels.peel_wave import peel_wave_kernel
from repro_torch import core
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.kernels import bitmap_support, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest_plan(bitmap, eu, ev, alive, capacity, word_offset=0,
                word_count=None):
    """The digest body's three passes on the CPU.  ``alive`` None is K2
    (every slot live).  Returns the support (0 on dead slots) and what
    each pass decided."""
    n, w = bitmap.shape
    wc = w - word_offset if word_count is None else word_count
    slab = bitmap[:, word_offset:word_offset + wc]
    e = eu.shape[0]
    live = torch.ones(e, dtype=torch.bool) if alive is None else alive.bool()
    eu, ev = eu.long(), ev.long()
    # 1. mark
    need = torch.zeros(n, dtype=torch.bool)
    need[eu[live]] = True
    need[ev[live]] = True
    # 2. digest: the first C nonzero words of each needed row, ascending
    nz = slab != 0
    nnz = nz.sum(1)
    rank = nz.long().cumsum(1) - 1
    keep = nz & (rank < capacity) & need[:, None]
    r, c = keep.nonzero(as_tuple=True)
    d_idx = torch.zeros((n, capacity), dtype=torch.long)
    d_word = torch.zeros((n, capacity), dtype=torch.int32)
    d_idx[r, rank[r, c]] = c
    d_word[r, rank[r, c]] = slab[r, c]
    # 3. probe from the sparser endpoint, or stream both rows
    na, nb = nnz[eu], nnz[ev]
    b_side = nb < na
    s, o = torch.where(b_side, ev, eu), torch.where(b_side, eu, ev)
    ns = torch.minimum(na, nb)
    fits = ns <= capacity
    j = torch.arange(capacity)
    entry = j[None, :] < ns[:, None]
    probed = slab[o[:, None], d_idx[s]]
    sup_probe = (ref.popcount32(d_word[s] & probed) * entry).sum(1)
    sup_stream = ref.popcount32(slab[eu] & slab[ev]).sum(1)
    sup = torch.where(fits, sup_probe, sup_stream).to(torch.int32)
    sup = torch.where(live, sup, 0)
    return sup, {"need": need, "nnz": nnz, "b_side": b_side, "fits": fits,
                 "live": live, "digest": (d_idx, d_word)}


def plan_wave(bitmap, eu, ev, alive, k, capacity):
    sup, info = digest_plan(bitmap, eu, ev, alive, capacity)
    return sup, info["live"] & (sup < k - 2), info


def _u32(t):
    return jnp.asarray(t.numpy().view(np.uint32))


def _pallas_support(bitmap, eu, ev, word_offset=0, word_count=None):
    ra, rb = bitmap[eu.long()], bitmap[ev.long()]
    kw = {} if word_count is None else {"word_offset": word_offset,
                                        "word_count": word_count}
    return np.asarray(bitmap_support_kernel(_u32(ra), _u32(rb),
                                            interpret=True, **kw))


def _pallas_wave(bitmap, eu, ev, alive, k):
    ra, rb = bitmap[eu.long()], bitmap[ev.long()]
    sup, kill = peel_wave_kernel(_u32(ra), _u32(rb), jnp.asarray(alive.numpy()),
                                 jnp.int32(k), interpret=True)
    return np.asarray(sup), np.asarray(kill)


def _graph(n, m):
    """Bitmap and clamped endpoint ids of every slot (sentinel slots read
    node n - 1, as the peel engine's ``_endpoints`` gives them)."""
    edges = powerlaw_graph(n, m, seed=0)
    spec = core.GraphSpec(n, d_max=2 * int(np.bincount(edges.reshape(-1)).max()),
                          e_cap=len(edges) + 64)
    st = core.from_edge_list(spec, edges, "cpu")
    bm = core.build_bitmap(spec, st, st.active)
    eu = torch.clamp(st.edges[:, 0], max=n - 1).contiguous()
    ev = torch.clamp(st.edges[:, 1], max=n - 1).contiguous()
    return bm, eu, ev, st.active.clone()


_GRAPHS = {}


def graph(n):
    if n not in _GRAPHS:
        _GRAPHS[n] = _graph(n, 5)
    return _GRAPHS[n]


def _words(rng, shape, density):
    """uint32 words as int32, nonzero with ``density``, bit 31 set in a
    quarter of those."""
    w = rng.integers(1, 2**32, size=shape, dtype=np.uint32)
    w[rng.random(shape) < 0.25] |= np.uint32(1 << 31)
    w[rng.random(shape) >= density] = 0
    return torch.from_numpy(w.view(np.int32))


def crafted(capacity, w=37, seed=0):
    """Random words with bit 31 set, an empty row, rows with exactly C and
    C + 1 nonzero words, slots pairing a row with itself, and sentinel-like
    slots all reading the last row."""
    rng = np.random.default_rng(seed)
    n = 40
    bm = _words(rng, (n, w), 0.3)
    bm[0] = 0                                     # empty row
    for row, cnt in ((1, capacity), (2, capacity + 1), (3, capacity),
                     (4, capacity + 1), (5, w)):
        cnt = min(cnt, w)
        bm[row] = 0
        cols = rng.choice(w, cnt, replace=False)
        bm[row, cols] = _words(rng, (cnt,), 1.0)
        bm[row, cols[0]] = np.int32(-(2**31))    # bit 31 alone: negative
    pairs = [(0, 1), (1, 0), (1, 2), (2, 1), (2, 4), (4, 2), (1, 3), (2, 2),
             (1, 1), (0, 0), (5, 2), (5, 5), (3, 5)]
    pairs += [tuple(p) for p in rng.integers(0, n, (200, 2))]
    pairs += [(n - 1, n - 1)] * 20
    ids = torch.tensor(pairs, dtype=torch.int32)
    return bm, ids[:, 0].contiguous(), ids[:, 1].contiguous()


def test_digest_capacity():
    assert bitmap_support.digest_capacity(2418) == 256   # the slice's width
    for w in (0, 1, 3, 37, 125, 129, 256):
        assert bitmap_support.digest_capacity(w) == w
    assert bitmap_support.digest_capacity(257) == 256


@pytest.mark.parametrize("n", [400, 4000])
@pytest.mark.parametrize("cap", [1, 2, 8, "W"])
def test_plan_on_powerlaw_bitmaps_equals_pallas(n, cap):
    """K2 on every slot (sentinels included) and K1 under all-alive, a
    random and an all-dead mask at k = 2, 3, 7: the plan == Pallas == ref."""
    bm, eu, ev, active = graph(n)
    c = bm.shape[1] if cap == "W" else cap
    sup, info = digest_plan(bm, eu, ev, None, c)
    np.testing.assert_array_equal(sup.numpy(), _pallas_support(bm, eu, ev))
    assert torch.equal(sup, ref.bitmap_support_gathered_ref(bm, eu, ev))
    fits = info["fits"]
    if cap == "W":
        assert bool(fits.all())
    elif cap == 8:                # both branches (at C = 1 the 4,000-node
        # graph has no row that fits: the crafted rows reach that case)
        assert bool(fits.any()) and bool((~fits).any())
    assert bool(info["b_side"].any()) and bool((~info["b_side"]).any())
    rng = np.random.default_rng(n)
    masks = (active, torch.from_numpy(rng.random(len(eu)) < 0.3),
             torch.ones(len(eu), dtype=torch.bool),
             torch.zeros(len(eu), dtype=torch.bool))
    for alive in masks:
        for k in (2, 3, 7):
            s1, k1, info = plan_wave(bm, eu, ev, alive, k, c)
            j_sup, j_kill = _pallas_wave(bm, eu, ev, alive, k)
            np.testing.assert_array_equal(s1.numpy(), j_sup)
            np.testing.assert_array_equal(k1.numpy(), j_kill)
            r_sup, r_kill = ref.peel_wave_gathered_ref(bm, eu, ev, alive, k)
            assert torch.equal(s1, r_sup) and torch.equal(k1, r_kill)
        # only rows of live slots are digested
        assert torch.equal(info["need"].nonzero().flatten(), torch.unique(
            torch.cat([eu[alive], ev[alive]]).long()))


@pytest.mark.parametrize("cap", [1, 2, 8, 37])
def test_plan_on_crafted_rows_equals_pallas(cap):
    """Empty rows, rows at exactly C and C + 1 nonzero words, bit 31, u ==
    v and repeated last-row slots: the plan == Pallas == ref for K1 and
    K2, and its digest holds each row's first C nonzero words in order."""
    bm, eu, ev = crafted(cap)
    sup, info = digest_plan(bm, eu, ev, None, cap)
    np.testing.assert_array_equal(sup.numpy(), _pallas_support(bm, eu, ev))
    assert torch.equal(sup, ref.bitmap_support_gathered_ref(bm, eu, ev))
    nnz, fits = info["nnz"], info["fits"]
    assert int(nnz[0]) == 0
    if cap < 37:
        assert int(nnz[1]) == cap and int(nnz[2]) == cap + 1
        assert bool(fits.any()) and bool((~fits).any())
    d_idx, d_word = info["digest"]
    for row in range(bm.shape[0]):
        cols = (bm[row] != 0).nonzero().flatten()[:cap]
        assert torch.equal(d_idx[row, :len(cols)], cols)
        assert torch.equal(d_word[row, :len(cols)], bm[row, cols])
    alive = torch.from_numpy(np.random.default_rng(cap).random(len(eu)) < 0.6)
    for k in (2, 3, 7):
        s1, k1, _ = plan_wave(bm, eu, ev, alive, k, cap)
        j_sup, j_kill = _pallas_wave(bm, eu, ev, alive, k)
        np.testing.assert_array_equal(s1.numpy(), j_sup)
        np.testing.assert_array_equal(k1.numpy(), j_kill)


@pytest.mark.parametrize("wo,wc", [(0, 37), (5, 20), (36, 1), (0, 0)])
@pytest.mark.parametrize("cap", [1, 2, 8])
def test_plan_on_word_slabs_equals_pallas(wo, wc, cap):
    """Digest indices are slab-relative and probes land at wo + w: a slab's
    partial support == Pallas's word-slab call == ref on the slab."""
    bm, eu, ev = crafted(cap, seed=wo + 1)
    sup, _ = digest_plan(bm, eu, ev, None, min(cap, wc), wo, wc)
    if wc:
        np.testing.assert_array_equal(
            sup.numpy(), _pallas_support(bm, eu, ev, wo, wc))
    assert torch.equal(sup, ref.bitmap_support_gathered_ref(
        bm[:, wo:wo + wc], eu, ev))


def test_digest_args_pick_the_body_and_size_the_workspace():
    """Gathered pairs from one bitmap take the digest body with capacity
    ``digest_capacity(word_count)`` and one workspace of 8·N·C + 5·N +
    4·E + 4 bytes; row pairs take the direct body; the rest raises."""
    args = bitmap_support.digest_args
    bm = torch.zeros((10, 37), dtype=torch.int32)
    ids = torch.zeros(3, dtype=torch.int32)
    body, cap, ws = args(bm, bm, ids, 37, None, None)
    assert (body, cap, ws.numel(), ws.dtype) == (
        "digest", 37, 8 * 10 * 37 + 50 + 12 + 4, torch.uint8)
    body, cap, ws = args(bm, bm, ids, 20, "digest", 2)
    assert (body, cap, ws.numel()) == ("digest", 2, 8 * 10 * 2 + 50 + 12 + 4)
    assert args(bm, bm, ids[:0], 37, None, None) == ("digest", 37, None)
    assert args(bm, bm, None, 37, None, None) == ("direct", 0, None)
    assert args(bm, bm, ids, 37, "direct", None) == ("direct", 0, None)
    for bad in ((bm, bm, ids, 37, "x", None),
                (bm, bm, None, 37, "digest", None),
                (bm, bm.clone(), ids, 37, "digest", None),
                (bm, bm, ids, 37, None, -1)):
        with pytest.raises(ValueError):
            args(*bad)


@pytest.mark.parametrize("pairs,body", [
    ("one bitmap by ids", "digest"),
    ("two bitmaps by ids", "direct"),
    ("two row blocks", "direct"),
    ("one bitmap, rows of another shape", "direct"),
])
def test_digest_args_default_follows_the_inputs(pairs, body):
    """With no body named, only gathered pairs whose rows both come from
    one bitmap run the digest body; any other pairs keep the direct body,
    as before the digest body existed."""
    bm = torch.zeros((10, 37), dtype=torch.int32)
    ids = torch.zeros(3, dtype=torch.int32)
    a, b, ia = {"one bitmap by ids": (bm, bm, ids),
                "two bitmaps by ids": (bm, bm.clone(), ids),
                "two row blocks": (bm, bm.clone(), None),
                "one bitmap, rows of another shape": (bm, bm[:5], ids),
                }[pairs]
    assert bitmap_support.digest_args(a, b, ia, 37, None, None)[0] == body
