"""Algorithms 1/2, fused ``batch_maintain`` and the truss index of the port
against ``repro.core``: the whole state after each update, ``(state, lo, hi,
stats)`` of each batch, and component labels — all bitwise."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import oracle
from repro.data.streams import iter_batches, make_update_stream

N, D_MAX, E_CAP = 13, 16, 160
SJ, ST = J.GraphSpec(N, D_MAX, E_CAP), T.GraphSpec(N, D_MAX, E_CAP)


def _random_graph(rng, p, n=N):
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def decomposed(edges):
    sj = J.from_edge_list(SJ, np.asarray(edges))
    st = T.from_edge_list(ST, np.asarray(edges), device="cpu")
    return (sj._replace(phi=J.decompose(SJ, sj)),
            st._replace(phi=T.decompose(ST, st, device="cpu")))


def assert_same_state(sj, st, tag):
    for name, a, b in zip(J.GraphState._fields, sj, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{tag} {name}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_update_algorithms_match(seed):
    """Algorithm 1 (delete) and Algorithm 2 (insert), one update at a time."""
    edges = _random_graph(np.random.default_rng(seed), 0.35)
    sj, st = decomposed(edges)
    present = set(edges)
    for op, a, b in make_update_stream(np.asarray(edges), N, 16, seed=seed):
        op, a, b = int(op), int(a), int(b)
        if op == T.OP_INSERT:
            sj = J.insert_edge_maintain(SJ, sj, a, b)
            st = T.insert_edge_maintain(ST, st, a, b)
            present.add((a, b))
        else:
            sj = J.delete_edge_maintain(SJ, sj, a, b)
            st = T.delete_edge_maintain(ST, st, a, b)
            present.discard((a, b))
        assert_same_state(sj, st, (seed, op, a, b))
    assert oracle.phi_snapshot(st) == oracle.scratch_phi(N, present)


def test_apply_updates_stream_matches():
    edges = _random_graph(np.random.default_rng(9), 0.3)
    sj, st = decomposed(edges)
    stream = make_update_stream(np.asarray(edges), N, 12, seed=9)
    ops, aa, bb = (stream[:, i].astype(np.int32) for i in range(3))
    sj = J.apply_updates(SJ, sj, jnp.asarray(ops), jnp.asarray(aa), jnp.asarray(bb))
    st = T.apply_updates(ST, st, torch.from_numpy(ops), torch.from_numpy(aa),
                         torch.from_numpy(bb))
    assert_same_state(sj, st, "apply_updates")


def _pad(pairs, bsz):
    a = np.zeros(bsz, np.int32)
    b = np.zeros(bsz, np.int32)
    m = np.zeros(bsz, bool)
    for i, (x, y) in enumerate(pairs):
        a[i], b[i], m[i] = x, y, True
    return ((jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)),
            (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(m)))


@pytest.mark.parametrize("method", ["sorted", "bitmap"])
@pytest.mark.parametrize("kind", ["insert", "delete", "mixed", "mixed_touching"])
def test_batch_maintain_matches(method, kind):
    """Homogeneous batches (widened Theorem-1/2 range), a separable mixed
    batch and a mixed batch that touches (unfiltered fallback)."""
    rng = np.random.default_rng(len(kind))
    edges = _random_graph(rng, 0.35)
    present = set(edges)
    absent = [(i, j) for i in range(N) for j in range(i + 1, N)
              if (i, j) not in present]
    rng.shuffle(absent)
    pres = sorted(present)
    dels = {"insert": [], "delete": pres[:5], "mixed": pres[:3],
            "mixed_touching": pres[:3]}[kind]
    touched = {x for e in dels for x in e}
    inss = {"insert": absent[:5], "delete": [],
            "mixed": [e for e in absent if not set(e) & touched][:3],
            "mixed_touching": [e for e in absent if set(e) & touched][:3]}[kind]
    bsz = 8
    (dj, dt), (ij, it) = _pad(dels, bsz), _pad(inss, bsz)
    sj, st = decomposed(edges)
    bm_j = bm_t = None
    if method == "bitmap":  # the POST-update structural bitmap, as cached
        # (the bitmap depends only on the edge set, not on slot order)
        final = np.asarray(sorted((present - set(dels)) | set(inss)))
        post_j = J.from_edge_list(SJ, final)
        post_t = T.from_edge_list(ST, final, device="cpu")
        bm_j = J.build_bitmap(SJ, post_j, post_j.active)
        bm_t = T.build_bitmap(ST, post_t, post_t.active)
    out_j = J.batch_maintain(SJ, sj, *dj, *ij, method=method, bitmap=bm_j)
    out_t = T.batch_maintain(ST, st, *dt, *it, method=method, bitmap=bm_t)
    assert_same_state(out_j[0], out_t[0], (method, kind))
    for x, y in zip(out_j[1:3], out_t[1:3]):
        assert int(x) == int(y), (method, kind)
    assert tuple(int(x) for x in out_j[3]) == tuple(int(x) for x in out_t[3])
    if kind == "mixed_touching":  # unfiltered fallback: hi is +inf
        assert int(out_t[2]) == 2**30
    assert oracle.phi_snapshot(out_t[0]) == oracle.scratch_phi(
        N, (present - set(dels)) | set(inss))


@pytest.mark.parametrize("bsz", [1, 7, 64])
def test_batch_maintain_over_streams_matches(bsz):
    edges = _random_graph(np.random.default_rng(bsz), 0.3)
    sj, st = decomposed(edges)
    present = set(edges)
    stream = make_update_stream(np.asarray(edges), N, 24, seed=bsz + 1)
    for chunk in iter_batches(stream, bsz):
        cur = set(present)
        for op, a, b in chunk.tolist():
            (cur.add if op == 1 else cur.discard)((a, b))
        dels, inss = sorted(present - cur), sorted(cur - present)
        (dj, dt), (ij, it) = _pad(dels, 64), _pad(inss, 64)
        sj, lo_j, hi_j, ps_j = J.batch_maintain(SJ, sj, *dj, *ij)
        st, lo_t, hi_t, ps_t = T.batch_maintain(ST, st, *dt, *it)
        assert_same_state(sj, st, bsz)
        assert (int(lo_j), int(hi_j)) == (int(lo_t), int(hi_t))
        assert tuple(int(x) for x in ps_j) == tuple(int(x) for x in ps_t)
        present = cur


@pytest.mark.parametrize("seed,p", [(0, 0.15), (4, 0.3), (5, 0.5)])
def test_component_labels_and_representatives_match(seed, p):
    n = 40
    spec_j, spec_t = J.GraphSpec(n, 48, 800), T.GraphSpec(n, 48, 800)
    edges = _random_graph(np.random.default_rng(seed), p, n)
    sj = J.from_edge_list(spec_j, np.asarray(edges))
    st = T.from_edge_list(spec_t, np.asarray(edges), device="cpu")
    sj = sj._replace(phi=J.decompose(spec_j, sj))
    st = st._replace(phi=T.decompose(spec_t, st, device="cpu"))
    for k in range(2, int(st.phi.max()) + 2):
        rep_j, lab_j = J.representatives(spec_j, sj, k)
        rep_t, lab_t = T.representatives(spec_t, st, k)
        np.testing.assert_array_equal(np.asarray(lab_j), lab_t.numpy())
        np.testing.assert_array_equal(np.asarray(rep_j), rep_t.numpy())
    idx = T.TrussIndex(spec_t, (3, 4))
    assert torch.equal(idx.query(st, 3), T.component_labels(spec_t, st, 3))
    rep, lab = idx.query_representatives(st, 4)
    assert torch.equal(rep, T.representatives(spec_t, st, 4)[0])
