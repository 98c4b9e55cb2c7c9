"""The port's peel engine against ``repro.core.peel``: phi and every
``PeelStats`` field bitwise equal across {sorted, bitmap} x {delta,
recompute}, with frozen boundaries and cached bitmaps, and equal to the
pure-Python oracle.  One pinned spec, as in ``tests/test_peel_engine.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import oracle
from repro_torch.launch.mesh import make_shard_mesh

N, D_MAX, E_CAP = 13, 16, 160
SJ, ST = J.GraphSpec(N, D_MAX, E_CAP), T.GraphSpec(N, D_MAX, E_CAP)
CASES = [(0, 0.2), (1, 0.35), (2, 0.6), (3, 0.05)]
METHODS = [(m, e) for m in ("sorted", "bitmap") for e in ("delta", "recompute")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_graph(rng, p, n=N):
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def both(edges):
    return (J.from_edge_list(SJ, np.asarray(edges)),
            T.from_edge_list(ST, np.asarray(edges), device="cpu"))


def stats_of(ps):
    return tuple(int(x) for x in ps)


def assert_same(out_j, out_t, tag):
    np.testing.assert_array_equal(np.asarray(out_j[0]), out_t[0].numpy(),
                                  err_msg=str(tag))
    assert stats_of(out_j[1]) == stats_of(out_t[1]), tag


@pytest.mark.parametrize("method,engine", METHODS)
def test_full_decomposition_matches_reference_and_oracle(method, engine):
    for seed, p in CASES:
        edges = _random_graph(np.random.default_rng(seed), p)
        sj, st = both(edges)
        out_j = J.peel(SJ, sj, sj.active, method=method, engine=engine)
        out_t = T.peel(ST, st, st.active, method=method, engine=engine,
                       device="cpu")
        assert_same(out_j, out_t, (method, engine, seed))
        assert oracle.phi_snapshot(st, out_t[0]) == oracle.scratch_phi(N, edges)


@pytest.mark.parametrize("method,engine", METHODS)
def test_frozen_boundary_peel_matches(method, engine):
    """A peel of a random subset with the rest frozen at its true phi —
    the fused batch engine's re-peel — including frozen retires."""
    for seed, p in CASES[:3]:
        rng = np.random.default_rng(100 + seed)
        edges = _random_graph(rng, p + 0.1)
        sj, st = both(edges)
        sj = sj._replace(phi=J.decompose(SJ, sj))
        st = st._replace(phi=T.decompose(ST, st, device="cpu"))
        mask = rng.random(E_CAP) < 0.4
        out_j = J.peel(SJ, sj, jnp.asarray(mask), method=method, engine=engine)
        out_t = T.peel(ST, st, torch.from_numpy(mask), method=method,
                       engine=engine, device="cpu")
        assert_same(out_j, out_t, (method, engine, seed))
        assert oracle.phi_snapshot(st, out_t[0]) == oracle.scratch_phi(N, edges)


@pytest.mark.parametrize("chunk", [4, 64])
def test_sorted_delta_chunked_admission_matches(chunk):
    """Small chunks force multi-chunk levels and the triangle budget."""
    edges = _random_graph(np.random.default_rng(7), 0.5)
    sj, st = both(edges)
    assert_same(J.delta_peel(SJ, sj, sj.active, method="sorted", chunk=chunk),
                T.delta_peel(ST, st, st.active, method="sorted", chunk=chunk),
                chunk)


def test_cached_bitmap_matches_engine_built_and_stays_untouched():
    edges = _random_graph(np.random.default_rng(11), 0.4)
    sj, st = both(edges)
    bj = J.build_bitmap(SJ, sj, sj.active)
    bt = T.build_bitmap(ST, st, st.active)
    before = bt.clone()
    for mask_seed in (None, 5):
        if mask_seed is None:
            mj, mt = sj.active, st.active
        else:  # frozen edges below level 3 are cleared off the cached copy
            sj = sj._replace(phi=J.decompose(SJ, sj))
            st = st._replace(phi=T.decompose(ST, st, device="cpu"))
            m = np.random.default_rng(mask_seed).random(E_CAP) < 0.5
            mj, mt = jnp.asarray(m), torch.from_numpy(m)
        out_j = J.delta_peel(SJ, sj, mj, bitmap=bj, method="bitmap")
        out_t = T.delta_peel(ST, st, mt, bitmap=bt, method="bitmap")
        assert_same(out_j, out_t, mask_seed)
        assert_same(out_t, T.delta_peel(ST, st, mt, method="bitmap"), mask_seed)
    assert torch.equal(bt, before)


def test_decompose_entry_points():
    edges = _random_graph(np.random.default_rng(2), 0.5)
    sj, st = both(edges)
    phi, stats = T.decompose_with_stats(ST, st, "bitmap", device="cpu")
    assert_same(J.decomposition.decompose_with_stats(SJ, sj, "bitmap"),
                (phi, stats), "decompose")
    assert T.stats_dict(stats)["kills"] == len(edges)
    st2 = T.decompose_and_set(ST, st, device="cpu")
    assert torch.equal(st2.phi, phi)
    with pytest.raises(TypeError):
        T.peel(ST, st, st.active, mesh=object(), device="cpu")
    mesh = make_shard_mesh(2, device="cpu")
    assert_same(J.decomposition.decompose_with_stats(SJ, sj, "bitmap"),
                T.peel(T.with_mesh(ST, mesh), st, st.active, method="bitmap",
                       mesh=mesh, device="cpu"), "mesh")
    with pytest.raises(ValueError):
        T.peel(ST, st, st.active, engine="nope", device="cpu")
