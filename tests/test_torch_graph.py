"""``repro_torch.core.graph`` against ``repro.core.graph``: every
``GraphState`` array and every bitmap bitwise equal after the same edits."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.graph as J
import repro_torch.core.graph as T
from repro.data.synthetic import er_graph, powerlaw_graph

N, D_MAX, E_CAP = 13, 16, 160
SPECS = (J.GraphSpec(N, D_MAX, E_CAP), T.GraphSpec(N, D_MAX, E_CAP))


def _random_graph(rng, p, n=N):
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def assert_same_state(sj, st, tag=""):
    for name, a, b in zip(J.GraphState._fields, sj, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{tag} {name}")


def both(edges, specs=SPECS):
    sj = J.from_edge_list(specs[0], np.asarray(edges))
    st = T.from_edge_list(specs[1], np.asarray(edges), device="cpu")
    return sj, st


def test_spec_fields_and_properties_match():
    for kw in ({}, {"n_shards": 2, "partition": "nodes"}):
        args = dict(n_nodes=77, d_max=9, e_cap=40, **kw)
        sj, st = J.GraphSpec(**args), T.GraphSpec(**args)
        assert dataclass_tuple(sj) == dataclass_tuple(st)
        for prop in ("n_words", "word_block", "bitmap_bytes_per_device",
                     "state_bytes_per_device"):
            assert getattr(sj, prop) == getattr(st, prop), prop
        assert hash(st) == hash(T.GraphSpec(**args))


def dataclass_tuple(spec):
    return (spec.n_nodes, spec.d_max, spec.e_cap, spec.n_shards,
            spec.shard_axis, spec.partition)


@pytest.mark.parametrize("gen", ["er", "powerlaw", "empty"])
def test_from_edge_list_and_bitmap_match(gen):
    n = 150
    edges = {"er": lambda: er_graph(n, 6, seed=1),
             "powerlaw": lambda: powerlaw_graph(n, 4, seed=2),
             "empty": lambda: np.zeros((0, 2), np.int64)}[gen]()
    deg = np.bincount(edges.reshape(-1), minlength=n)
    args = (n, max(8, 2 * int(deg.max(initial=0))), max(16, 2 * len(edges)))
    sj, st = both(edges, (J.GraphSpec(*args), T.GraphSpec(*args)))
    assert_same_state(sj, st, gen)
    bj = J.build_bitmap(J.GraphSpec(*args), sj, sj.active)
    bt = T.build_bitmap(T.GraphSpec(*args), st, st.active)
    np.testing.assert_array_equal(np.asarray(bj), T.bitmap_to_numpy(bt))


def test_numpy_round_trips_keep_every_bit():
    sj, st = both(_random_graph(np.random.default_rng(0), 0.4))
    arrays = [np.asarray(x) for x in sj]
    back = T.state_to_numpy(T.state_from_numpy(SPECS[1], arrays, device="cpu"))
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    words = np.array([[0, 1 << 31, 0xFFFFFFFF], [0x80000001, 7, 1 << 30]],
                     np.uint32)
    bm = T.bitmap_from_numpy(words, device="cpu")
    assert bm.dtype == torch.int32
    np.testing.assert_array_equal(T.bitmap_to_numpy(bm), words)
    with pytest.raises(ValueError):
        T.state_from_numpy(T.GraphSpec(N, D_MAX, E_CAP + 1), arrays,
                           device="cpu")


def test_single_edge_struct_edits_match():
    """A sequence of single inserts/deletes, state compared after each."""
    rng = np.random.default_rng(3)
    edges = _random_graph(rng, 0.3)
    sj, st = both(edges)
    present = set(edges)
    for step in range(24):
        if step % 3 == 2 and present:
            a, b = sorted(present)[rng.integers(len(present))]
            present.discard((a, b))
            sj, slot_j = J.delete_edge_struct(SPECS[0], sj, jnp.int32(b), jnp.int32(a))
            st, slot_t = T.delete_edge_struct(SPECS[1], st, b, a)
        else:
            absent = [(i, j) for i in range(N) for j in range(i + 1, N)
                      if (i, j) not in present]
            a, b = absent[rng.integers(len(absent))]
            present.add((a, b))
            sj, slot_j = J.insert_edge_struct(SPECS[0], sj, jnp.int32(a), jnp.int32(b))
            st, slot_t = T.insert_edge_struct(SPECS[1], st, a, b)
        assert int(slot_j) == int(slot_t)
        assert_same_state(sj, st, f"step {step}")
        for x, y in ((0, 1), (a, b), (b, a)):
            for r_j, r_t in zip(J.lookup_edge(SPECS[0], sj, jnp.int32(x), jnp.int32(y)),
                                T.lookup_edge(SPECS[1], st, torch.tensor(x),
                                              torch.tensor(y))):
                assert bool(r_j) == bool(r_t) and int(r_j) == int(r_t)


def _pad(pairs, bsz, jax_side):
    a = np.zeros(bsz, np.int32)
    b = np.zeros(bsz, np.int32)
    m = np.zeros(bsz, bool)
    for i, (x, y) in enumerate(pairs):
        a[i], b[i], m[i] = x, y, True
    if jax_side:
        return jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)
    return torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(m)


@pytest.mark.parametrize("bsz", [1, 7, 64])
def test_apply_edge_batch_struct_matches(bsz):
    n, d, e_cap = 40, 48, 600
    specs = (J.GraphSpec(n, d, e_cap), T.GraphSpec(n, d, e_cap))
    rng = np.random.default_rng(bsz)
    edges = _random_graph(rng, 0.2, n)
    sj, st = both(edges, specs)
    present = set(edges)
    for rnd in range(3):
        n_del = (bsz + 1) // 2 if rnd % 2 == 0 else bsz // 2
        pres = sorted(present)
        dels = [pres[i] for i in rng.choice(len(pres), n_del, replace=False)]
        absent = [(i, j) for i in range(n) for j in range(i + 1, n)
                  if (i, j) not in present]
        inss = [absent[i] for i in rng.choice(len(absent), bsz - n_del,
                                              replace=False)]
        # reversed endpoints and masked padding rows must not matter
        dels_in = [(b, a) if i % 2 else (a, b) for i, (a, b) in enumerate(dels)]
        sj, slots_j = J.apply_edge_batch_struct(
            specs[0], sj, *_pad(dels_in, bsz, True), *_pad(inss, bsz, True))
        st, slots_t = T.apply_edge_batch_struct(
            specs[1], st, *_pad(dels_in, bsz, False), *_pad(inss, bsz, False))
        np.testing.assert_array_equal(np.asarray(slots_j), slots_t.numpy())
        assert_same_state(sj, st, f"bsz {bsz}")
        present = (present - set(dels)) | set(inss)


def test_update_bitmap_bit31_set_and_clear():
    """Set and clear bits of node ids = 31 (mod 32) — int32 bit 31 — both
    through the incremental update and a rebuild, against the reference."""
    n = 130
    spec_j, spec_t = J.GraphSpec(n, 16, 64), T.GraphSpec(n, 16, 64)
    pairs = np.array([(31, 63), (0, 31), (63, 95), (95, 127), (31, 127),
                      (1, 2), (64, 95)], np.int32)
    u, v = pairs[:, 0], pairs[:, 1]
    valid = np.array([1, 1, 1, 1, 1, 0, 1], bool)
    bj = jnp.zeros((n, spec_j.n_words), jnp.uint32)
    bt = torch.zeros((n, spec_t.n_words), dtype=torch.int32)
    bj = J.update_bitmap(spec_j, bj, jnp.asarray(u), jnp.asarray(v),
                         jnp.asarray(valid), set_bits=True)
    T.update_bitmap(spec_t, bt, torch.from_numpy(u), torch.from_numpy(v),
                    torch.from_numpy(valid), set_bits=True)
    np.testing.assert_array_equal(np.asarray(bj), T.bitmap_to_numpy(bt))
    assert (T.bitmap_to_numpy(bt)[63] & np.uint32(1 << 31)).any()
    # rebuild of the same edge set equals the incremental one
    edges = np.full((64, 2), n, np.int32)
    edges[:len(pairs)] = pairs
    act = np.zeros(64, bool)
    act[:len(pairs)] = valid
    np.testing.assert_array_equal(
        T.bitmap_to_numpy(T.partial_bitmap(spec_t, torch.from_numpy(edges),
                                           torch.from_numpy(act))),
        T.bitmap_to_numpy(bt))
    clear = valid & (np.arange(len(pairs)) % 2 == 0)
    bj = J.update_bitmap(spec_j, bj, jnp.asarray(u), jnp.asarray(v),
                         jnp.asarray(clear), set_bits=False)
    T.update_bitmap(spec_t, bt, torch.from_numpy(u), torch.from_numpy(v),
                    torch.from_numpy(clear), set_bits=False)
    np.testing.assert_array_equal(np.asarray(bj), T.bitmap_to_numpy(bt))


@pytest.mark.parametrize("seed,p", [(0, 0.2), (1, 0.45), (2, 0.7)])
def test_support_all_and_bitmap_support_match(seed, p):
    rng = np.random.default_rng(seed)
    sj, st = both(_random_graph(rng, p))
    alive = rng.random(E_CAP) < 0.7
    aj, at = jnp.asarray(alive) & sj.active, torch.from_numpy(alive) & st.active
    sup_j = np.asarray(J.support_all(SPECS[0], sj, aj))
    np.testing.assert_array_equal(sup_j, T.support_all(SPECS[1], st, at).numpy())
    np.testing.assert_array_equal(
        np.asarray(J.support_all_bitmap(SPECS[0], sj, aj)),
        T.support_all_bitmap(SPECS[1], st, at).numpy())
    np.testing.assert_array_equal(
        sup_j, T.support_all_bitmap(SPECS[1], st, at).numpy())
    tj = J.triangle_partners(SPECS[0], sj, jnp.arange(N), jnp.arange(N)[::-1])
    tt = T.triangle_partners(SPECS[1], st, torch.arange(N), torch.arange(N).flip(0))
    for x, y in zip(tj, tt):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
