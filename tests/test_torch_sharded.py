"""The port's sharded peel substrate on the CPU: the twin of
``tests/test_sharded.py`` and of
``tests/test_distributed.py::test_distributed_truss_matches_oracle``.

The reference runs its mesh cases in subprocesses with forced host
devices; the port's ``ShardMesh`` is one process over a list of shard
devices, so these run in process on ``make_shard_mesh(S, device="cpu")``
(every shard on the one CPU device).  Each sharded result — phi, every
``PeelStats`` field, ``GraphState`` arrays, bitmaps — is held bitwise
against ``repro``'s ``mesh=None`` run in this process and against the
port's ``mesh=None``; ``distributed_decompose`` at 8 shards against the
oracle.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro.service as JS
import repro_torch.core as T
from repro.core import oracle
from repro.data.synthetic import powerlaw_graph
from repro_torch.core import distributed as dist
from repro_torch.core.distributed import distributed_decompose
from repro_torch.launch.mesh import make_shard_mesh, make_test_mesh
from repro_torch.service import TrussService, TrussStore

N = 48
EDGES = powerlaw_graph(N, 4, seed=11)
SJ0 = J.GraphSpec(n_nodes=N, d_max=N, e_cap=len(EDGES))
ST0 = T.GraphSpec(n_nodes=N, d_max=N, e_cap=len(EDGES))
DISCIPLINES = [("bitmap", "delta"), ("bitmap", "recompute"),
               ("sorted", "recompute")]
REPEELS = [("bitmap", "delta", False), ("bitmap", "delta", True),
           ("bitmap", "recompute", False), ("sorted", "recompute", False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats(ps):
    return tuple(int(x) for x in ps)


def _masks(e_cap, active):
    rng = np.random.default_rng(0)
    return [(rng.random(e_cap) < 0.4) & active for _ in range(3)]


@pytest.fixture(scope="module")
def reference():
    """``repro``'s mesh=None results on the unpadded spec, computed once:
    the full decomposition by each discipline, then frozen-boundary
    re-peels of three random subsets (with and without a cached bitmap)."""
    sj = J.from_edge_list(SJ0, EDGES)
    full = {}
    for method, engine in DISCIPLINES:
        phi, ps = J.peel(SJ0, sj, sj.active, method=method, engine=engine)
        full[method, engine] = (np.asarray(phi), _stats(ps))
    sj = sj._replace(phi=jnp.asarray(full["bitmap", "delta"][0]))
    bm = J.build_bitmap(SJ0, sj, sj.active)
    repeel = []
    for mask in _masks(SJ0.e_cap, np.asarray(sj.active)):
        out = {}
        for method, engine, cache in REPEELS:
            phi, ps = J.peel(SJ0, sj, jnp.asarray(mask),
                             bitmap=bm if cache else None, method=method,
                             engine=engine)
            out[method, engine, cache] = (np.asarray(phi), _stats(ps))
        repeel.append(out)
    return full, repeel


def _same(out, ref, e_cap0, tag):
    """A port (phi, PeelStats) against a reference (phi, stats): phi equal
    on the reference's slots, sentinel padding 0, stats equal."""
    phi = out[0].numpy()
    np.testing.assert_array_equal(phi[:e_cap0], ref[0], err_msg=str(tag))
    assert not phi[e_cap0:].any(), tag
    assert _stats(out[1]) == ref[1], tag


# -- the mesh and its collectives ---------------------------------------------

def test_shard_mesh_cycles_and_collectives():
    mesh = make_shard_mesh(4, device="cpu")
    assert mesh.shape == {"shard": 4} and mesh.axis_names == ("shard",)
    assert mesh.shard_devices("shard") == (torch.device("cpu"),) * 4
    assert make_shard_mesh(device="cpu").shape == {"shard": 1}
    grid = make_test_mesh((2, 3), ("data", "model"), device="cpu")
    assert grid.shape == {"data": 2, "model": 3}
    assert len(grid.shard_devices("data")) == 2
    assert len(grid.shard_devices("model")) == 3
    with pytest.raises(ValueError):
        T.ShardMesh(["cpu"] * 3, ("data", "model"), (2, 2))
    with pytest.raises(ValueError):
        make_shard_mesh(0, device="cpu")

    # int32 sums of disjoint bits stay int32 and equal the OR, bit 31 too
    bits = np.array([[1 << 31, 1], [2, 1 << 30], [4, 8]], np.uint32)
    parts = [torch.from_numpy(b.view(np.int32)) for b in bits]
    out = dist.psum(parts)
    assert len(out) == 3 and all(o.dtype == torch.int32 for o in out)
    assert (out[0].numpy().view(np.uint32)
            == np.bitwise_or.reduce(bits, axis=0)).all()
    assert parts[0].numpy().view(np.uint32)[0] == 1 << 31   # inputs kept
    lanes = [torch.tensor([5, 1, 1, 0], dtype=torch.int32),
             torch.tensor([3, 7, 0, 1], dtype=torch.int32)]
    assert dist.pmin(lanes)[1].tolist() == [3, 1, 0, 0]
    gathered = dist.all_gather([torch.tensor([True, False]),
                                torch.tensor([False])])
    assert gathered[0].tolist() == [True, False, False]


# -- sharded peel == single-device peel, bitwise, per shard count ---------------

@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_peel_bitwise_equal(shards, reference):
    full, repeel = reference
    mesh = make_shard_mesh(shards, device="cpu")
    spec = T.with_mesh(ST0, mesh)
    st = T.shard_state(spec, T.pad_state(
        ST0, T.from_edge_list(ST0, EDGES, device="cpu"), spec), mesh)
    adj = {i: set() for i in range(N)}
    for a, b in EDGES.tolist():
        adj[a].add(b)
        adj[b].add(a)
    ref_phi = oracle.truss_decomposition(adj)

    for method, engine in DISCIPLINES:
        single = T.peel(spec, st, st.active, method=method, engine=engine,
                        device="cpu")
        sharded = T.peel(spec, st, st.active, method=method, engine=engine,
                         mesh=mesh, device="cpu")
        _same(sharded, full[method, engine], ST0.e_cap, (shards, method))
        _same(single, full[method, engine], ST0.e_cap, (shards, method))
        got = {tuple(map(int, e)): int(p)
               for e, p in zip(EDGES, sharded[0][:len(EDGES)].tolist())}
        assert got == ref_phi, (method, engine)

    # frozen-boundary re-peels (the fused batch path's shape), with and
    # without a cached bitmap
    st = st._replace(phi=T.peel(spec, st, st.active, method="bitmap",
                                device="cpu")[0])
    bm = T.build_bitmap(spec, st, st.active)
    before = bm.clone()
    pad = spec.e_cap - ST0.e_cap
    for trial, mask in enumerate(_masks(ST0.e_cap,
                                        st.active[:ST0.e_cap].numpy())):
        mask = torch.from_numpy(np.pad(mask, (0, pad)))
        for method, engine, cache in REPEELS:
            kw = dict(bitmap=bm if cache else None, method=method,
                      engine=engine, device="cpu")
            ref = repeel[trial][method, engine, cache]
            _same(T.peel(spec, st, mask, mesh=mesh, **kw), ref, ST0.e_cap,
                  (shards, trial, method, engine, cache))
            _same(T.peel(spec, st, mask, **kw), ref, ST0.e_cap,
                  (trial, method, engine, cache))
    assert torch.equal(bm, before)   # the engine clears its own copy


def test_sharded_peel_validation():
    mesh = make_shard_mesh(4, device="cpu")
    st = T.from_edge_list(ST0, EDGES, device="cpu")
    spec2 = T.with_mesh(ST0, make_shard_mesh(2, device="cpu"))
    st2 = T.pad_state(ST0, st, spec2)
    with pytest.raises(ValueError, match="shards"):
        T.sharded_peel(spec2, st2, st2.active, mesh=mesh)
    with pytest.raises(ValueError, match="requires a mesh"):
        T.sharded_peel(spec2, st2, st2.active)
    spec4 = T.with_mesh(ST0, mesh)
    st4 = T.pad_state(ST0, st, spec4)
    with pytest.raises(ValueError, match="sorted delta"):
        T.peel(spec4, st4, st4.active, method="sorted", engine="delta",
               mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        T.peel(spec4, st4, st4.active, method="bitmap", engine="nope",
               mesh=mesh, device="cpu")
    with pytest.raises(TypeError, match="ShardMesh"):
        T.peel(spec4, st4, st4.active, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="device"):   # never the card
        T.peel(spec4, st4, st4.active, mesh=mesh, device="cuda")
    with pytest.raises(ValueError):                   # uneven row blocks
        T.shard_state(spec4, st, mesh)
    with pytest.raises(ValueError):
        T.pad_state(spec4, st4, ST0)
    # with_mesh and pad_state as the reference's (whose with_mesh reads
    # only ``mesh.shape[axis]``, which a ShardMesh has too)
    for partition in ("replicated", "nodes"):
        ours = T.with_mesh(ST0, mesh, partition=partition)
        theirs = J.with_mesh(SJ0, mesh, partition=partition)
        assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
        assert ours.n_words == theirs.n_words
    sj = J.pad_state(SJ0, J.from_edge_list(SJ0, EDGES),
                     J.with_mesh(SJ0, mesh))
    for name, a, b in zip(st4._fields, sj, st4):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


# -- fused batches and the service flush -----------------------------------------

BATCH_N = 24
E_CAP = 256   # a multiple of every shard count: whole states compare


def _batch_graph():
    rng = np.random.default_rng(7)
    edges = [(i, j) for i in range(BATCH_N) for j in range(i + 1, BATCH_N)
             if rng.random() < 0.2]
    present = set(edges)
    absent = sorted((i, j) for i in range(BATCH_N) for j in range(i + 1, BATCH_N)
                    if (i, j) not in present)
    rng.shuffle(absent)
    batches = []
    for _ in range(3):
        ins = [absent.pop() for _ in range(8)]
        dels = sorted(present)[:4]
        batches.append([(1, a, b) for a, b in ins]
                       + [(0, a, b) for a, b in dels])
        present.update(ins)
        present.difference_update(dels)
    return edges, batches


@pytest.fixture(scope="module")
def batch_reference():
    """``repro``'s mesh=None DynamicGraph through the same fused batches:
    every GraphState array and PeelStats after each batch, per method."""
    edges, batches = _batch_graph()
    out = {}
    for method in ("bitmap", "sorted"):
        g = J.DynamicGraph(BATCH_N, edges, support_method=method,
                           e_cap=E_CAP)
        steps = []
        for ups in batches:
            g.apply_batch(ups, strategy="fused")
            steps.append(([np.asarray(x) for x in g.state],
                          _stats(g.last_peel_stats), g.phi_dict()))
        out[method] = steps
    return out


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_batch_and_service_flush_bitwise(shards, batch_reference,
                                                 tmp_path):
    """DynamicGraph.apply_batch (fused) and the TrussService flush shard
    transparently: every GraphState array and PeelStats field equal to
    the port's and to ``repro``'s mesh=None engines, phi equal to the
    oracle; the sharded service's WAL bytes equal ``repro``'s."""
    edges, batches = _batch_graph()
    mesh = make_shard_mesh(shards, device="cpu")
    for method in ("bitmap", "sorted"):
        g1 = T.DynamicGraph(BATCH_N, edges, support_method=method,
                            e_cap=E_CAP, device="cpu")
        g2 = T.DynamicGraph(BATCH_N, edges, support_method=method,
                            e_cap=E_CAP, mesh=mesh, device="cpu")
        orc = oracle.Oracle(BATCH_N, edges)
        for ups, (arrays, stats, phi) in zip(batches,
                                             batch_reference[method]):
            g1.apply_batch(ups, strategy="fused")
            g2.apply_batch(ups, strategy="fused")
            orc.apply(ups)
            assert g1.phi_dict() == g2.phi_dict() == phi == orc.phi
            assert _stats(g2.last_peel_stats) == _stats(g1.last_peel_stats)
            assert _stats(g2.last_peel_stats) == stats
            for name, a, b, c in zip(g1.state._fields, arrays, g1.state,
                                     g2.state):
                np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
                np.testing.assert_array_equal(a, c.numpy(), err_msg=name)
            if method == "bitmap":
                assert torch.equal(g1._bitmap, g2._bitmap)

    # the service: one write stream through a sharded port service and a
    # mesh=None repro service
    rng = np.random.default_rng(3)
    present = set(edges)
    absent = [(i, j) for i in range(BATCH_N) for j in range(i + 1, BATCH_N)
              if (i, j) not in present]
    rng.shuffle(absent)
    roots = tmp_path / "j", tmp_path / "t"
    sj = JS.TrussService(BATCH_N, edges, flush_every=8, e_cap=E_CAP,
                         support_method="bitmap",
                         store=JS.TrussStore(str(roots[0])))
    stt = TrussService(BATCH_N, edges, flush_every=8, e_cap=E_CAP,
                       support_method="bitmap", mesh=mesh, device="cpu",
                       store=TrussStore(str(roots[1])))
    orc = oracle.Oracle(BATCH_N, edges)
    acked = []
    for step in range(16):
        if present and rng.random() < 0.4:
            e = sorted(present)[rng.integers(len(present))]
            present.discard(e)
            up = (0, *e)
        else:
            e = absent.pop()
            present.add(e)
            up = (1, *e)
        sj.submit(*up)
        stt.submit(*up)
        acked.append(up)
        assert sj.gen == stt.gen
        if step % 8 == 7:   # a generation boundary
            for name, a, b in zip(stt.graph.state._fields, sj.graph.state,
                                  stt.graph.state):
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=name)
    sj.flush()
    stt.flush()
    orc.apply(acked)
    assert sj.graph.phi_dict() == stt.graph.phi_dict() == orc.phi
    assert stt.stats()["memory"]["n_shards"] == shards
    for svc in (sj, stt):
        svc.store.fsync()
    for name in ("wal.log", "commit.json"):
        assert ((roots[0] / name).read_bytes()
                == (roots[1] / name).read_bytes()), name


# -- the façade ---------------------------------------------------------------

@pytest.mark.parametrize("delta", [False, True])
def test_distributed_truss_matches_oracle(delta):
    edges = powerlaw_graph(60, 4, seed=5)
    adj = {i: set() for i in range(60)}
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    ref = oracle.truss_decomposition(adj)
    spec = T.GraphSpec(n_nodes=60, d_max=60, e_cap=len(edges))
    mesh = make_test_mesh((8,), ("data",), device="cpu")
    phi = distributed_decompose(spec, mesh, np.asarray(edges), delta=delta)
    got = {tuple(map(int, e)): int(p) for e, p in zip(edges, phi)}
    assert got == ref, delta
