"""The port's node-partitioned bitmap (``partition="nodes"``) on the CPU:
the twin of the mesh cases of ``tests/test_scale.py``.

Each shard of ``make_shard_mesh(S, device="cpu")`` holds one word slab of
the adjacency bitmap, and a wave sums the shards' partial supports.  Held
bitwise: the slab algebra (per-slab partial bitmaps and updates joining to
the full ones, against ``repro``'s word-slab arguments), the spec's
geometry and memory gauges, the partitioned peel (both engines, and the
re-peel over cached slabs) against ``repro``'s ``mesh=None`` engines and
the port's, and the partitioned service — its restore, its replicas, and a
``repro`` replica tailing its store and the reverse — at every generation.
The graphs are the ones ``tests/test_torch_sharded.py`` uses, so the two
files share ``repro``'s compiled engines when one worker runs both.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.cluster as JC
import repro.core as J
import repro.service as JS
import repro_torch.core as T
from repro.core import oracle
from repro.data.synthetic import powerlaw_graph
from repro_torch.cluster import Replica
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.obs import expo, metrics as obs_metrics
from repro_torch.service import TrussService, TrussStore

N = 48
EDGES = powerlaw_graph(N, 4, seed=11)
SJ0 = J.GraphSpec(n_nodes=N, d_max=N, e_cap=len(EDGES))
ST0 = T.GraphSpec(n_nodes=N, d_max=N, e_cap=len(EDGES))
SVC_N, SVC_E_CAP = 24, 256


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


def _u32(bm) -> np.ndarray:
    """uint32 host view of a bitmap of either package (slabs joined)."""
    if isinstance(bm, (torch.Tensor, list)):
        return T.bitmap_to_numpy(bm)
    return np.asarray(bm)


def _padded_equal(ours, theirs, tag):
    """A bitmap (tensor or slabs) against a narrower or equal one: equal on
    the narrower one's words, the padding words of the slab layout zero."""
    ours, theirs = _u32(ours), _u32(theirs)
    w = theirs.shape[1]
    np.testing.assert_array_equal(ours[:, :w], theirs, err_msg=str(tag))
    assert not ours[:, w:].any(), tag


# -- geometry, validation, gauges ---------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4])
def test_partition_geometry_matches_reference(shards):
    mesh = make_shard_mesh(shards, device="cpu")
    base = dict(n_nodes=100, d_max=16, e_cap=64)
    for partition in ("replicated", "nodes"):
        ours = T.with_mesh(T.GraphSpec(**base), mesh, partition=partition)
        theirs = J.with_mesh(J.GraphSpec(**base), mesh, partition=partition)
        assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
        for prop in ("n_words", "word_block", "bitmap_bytes_per_device",
                     "state_bytes_per_device"):
            assert getattr(ours, prop) == getattr(theirs, prop), prop
        assert ours.word_block * ours.n_shards == ours.n_words \
            if partition == "nodes" else ours.word_block == ours.n_words
        sh = T.bitmap_sharding(ours, mesh)
        assert sh.partition == partition and sh.word_count == ours.word_block
        assert len(sh.devices) == (shards if partition == "nodes" else 1)
    with pytest.raises(ValueError):
        T.GraphSpec(n_nodes=8, d_max=4, e_cap=8, partition="columns")


def test_partitioned_requires_mesh_and_a_shard_mesh():
    tri = [(0, 1), (1, 2), (0, 2)]
    with pytest.raises(ValueError, match="needs a mesh"):
        T.DynamicGraph(16, tri, partition="nodes", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        TrussService(16, tri, partition="nodes", device="cpu")
    with pytest.raises(TypeError, match="ShardMesh"):
        T.DynamicGraph(16, tri, mesh=object(), partition="nodes",
                       device="cpu")
    with pytest.raises(ValueError, match="device"):
        T.DynamicGraph(16, tri, mesh=make_shard_mesh(2, device="cpu"),
                       device="cuda")


def test_memory_gauges_and_service_stats_under_mesh():
    """The gauges and ``stats()["memory"]`` publish the partitioned spec's
    per-device bytes: a 1/S slab of the bitmap."""
    mesh = make_shard_mesh(4, device="cpu")
    g = T.DynamicGraph(64, [(0, 1), (1, 2), (0, 2)], mesh=mesh,
                       partition="nodes", support_method="bitmap",
                       device="cpu")
    reg = obs_metrics.REGISTRY
    assert reg.value("truss_bitmap_bytes") == g.spec.bitmap_bytes_per_device
    assert reg.value("truss_state_bytes_per_device") == \
        g.spec.state_bytes_per_device
    assert g.spec.bitmap_bytes_per_device == 64 * 1 * 4   # 2 words -> 4, 1 a shard
    assert [tuple(s.shape) for s in g._bitmap] == [(64, 1)] * 4
    text = expo.render(reg)
    assert "# TYPE truss_bitmap_bytes gauge" in text
    svc = TrussService(32, [(0, 1), (1, 2), (0, 2)], support_method="bitmap",
                       mesh=mesh, partition="nodes", device="cpu")
    mem = svc.stats()["memory"]
    assert mem["partition"] == "nodes" and mem["n_shards"] == 4
    assert mem["bitmap_bytes_per_device"] == \
        svc.graph.spec.bitmap_bytes_per_device
    assert mem["state_bytes_per_device"] > mem["bitmap_bytes_per_device"]


# -- word-slab algebra ----------------------------------------------------------

@pytest.mark.parametrize("slabs", [2, 7])
def test_partial_bitmap_slabs_partition_build_and_update(slabs):
    """Per-slab partial bitmaps and owner-local updates equal ``repro``'s
    word-slab calls and join to the full-width build / update."""
    n = 200
    edges = powerlaw_graph(n, 4, seed=5)
    sj_spec = J.GraphSpec(n_nodes=n, d_max=n, e_cap=len(edges))
    spec = T.GraphSpec(n_nodes=n, d_max=n, e_cap=len(edges))
    sj = J.from_edge_list(sj_spec, edges)
    st = T.from_edge_list(spec, edges, device="cpu")
    full = T.build_bitmap(spec, st, st.active)
    _padded_equal(full, J.build_bitmap(sj_spec, sj, sj.active), "full")
    blk = spec.n_words // slabs          # 7 words: slabs of 3 (+1 dropped) or 1
    parts = []
    for i in range(slabs):
        ours = T.partial_bitmap(spec, st.edges, st.active,
                                word_offset=i * blk, word_count=blk)
        theirs = J.partial_bitmap(sj_spec, sj.edges, sj.active,
                                  word_offset=i * blk, word_count=blk)
        _padded_equal(ours, theirs, (slabs, i))
        parts.append(ours)
    assert torch.equal(T.join_slabs(parts), full[:, :slabs * blk])

    dead = np.zeros(spec.e_cap, bool)
    dead[::3] = True
    u, v = st.edges[:, 0], st.edges[:, 1]
    mask = torch.from_numpy(dead) & st.active
    after = T.update_bitmap(spec, full.clone(), u, v, mask, set_bits=False)
    _padded_equal(after, J.update_bitmap(
        sj_spec, J.build_bitmap(sj_spec, sj, sj.active), sj.edges[:, 0],
        sj.edges[:, 1], jnp.asarray(dead) & sj.active, set_bits=False),
        "update")
    pieces = [T.update_bitmap(spec, full[:, i * blk:(i + 1) * blk].clone(),
                              u, v, mask, set_bits=False, word_offset=i * blk,
                              word_count=blk) for i in range(slabs)]
    assert torch.equal(T.join_slabs(pieces), after[:, :slabs * blk])

    # the mesh forms: one slab a shard, joined == the full build / update
    mesh = make_shard_mesh(slabs, device="cpu")
    pspec = T.with_mesh(spec, mesh, partition="nodes")
    pst = T.pad_state(spec, st, pspec)
    built = T.build_bitmap_partitioned(pspec, pst, pst.active, mesh)
    assert [tuple(s.shape) for s in built] == \
        [(n, pspec.word_block)] * slabs
    _padded_equal(built, full, "partitioned build")
    pmask = torch.from_numpy(np.pad(dead, (0, pspec.e_cap - spec.e_cap))) \
        & pst.active
    T.update_bitmap_partitioned(pspec, built, pst.edges[:, 0],
                                pst.edges[:, 1], pmask, set_bits=False,
                                mesh=mesh)
    _padded_equal(built, after, "partitioned update")


# -- partitioned peel == replicated peel, bitwise, per shard count ---------------

@pytest.fixture(scope="module")
def reference():
    """``repro``'s mesh=None engines on the unpadded spec: both bitmap
    engines, then delta re-peels over the cached bitmap."""
    sj = J.from_edge_list(SJ0, EDGES)
    full = {}
    for engine in ("delta", "recompute"):
        phi, ps = J.peel(SJ0, sj, sj.active, method="bitmap", engine=engine)
        full[engine] = (np.asarray(phi), _stats(ps))
    sj = sj._replace(phi=jnp.asarray(full["delta"][0]))
    bm = J.build_bitmap(SJ0, sj, sj.active)
    rng = np.random.default_rng(0)
    masks, repeel = [], []
    for _ in range(3):
        mask = (rng.random(SJ0.e_cap) < 0.4) & np.asarray(sj.active)
        phi, ps = J.peel(SJ0, sj, jnp.asarray(mask), bitmap=bm,
                         method="bitmap", engine="delta")
        masks.append(mask)
        repeel.append((np.asarray(phi), _stats(ps)))
    return full, masks, repeel


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_partitioned_peel_bitwise_equal(shards, reference):
    """Both engines and the cached-slab re-peel equal ``repro``'s and the
    port's replicated mesh=None engines, with each shard holding a 1/S
    word slab."""
    full, masks, repeel = reference
    mesh = make_shard_mesh(shards, device="cpu")
    spec = T.with_mesh(ST0, mesh, partition="nodes")
    st0 = T.from_edge_list(ST0, EDGES, device="cpu")
    st = T.shard_state(spec, T.pad_state(ST0, st0, spec), mesh)
    assert spec.n_words == shards * spec.word_block
    e0 = ST0.e_cap

    def same(out, ref, tag):
        np.testing.assert_array_equal(out[0].numpy()[:e0], ref[0],
                                      err_msg=str(tag))
        assert not out[0][e0:].any() and _stats(out[1]) == ref[1], tag

    for engine in ("delta", "recompute"):
        same(T.peel(spec, st, st.active, method="bitmap", engine=engine,
                    mesh=mesh, device="cpu"), full[engine], engine)
        same(T.peel(ST0, st0, st0.active, method="bitmap", engine=engine,
                    device="cpu"), full[engine], engine)

    slabs = T.build_bitmap_partitioned(spec, st, st.active, mesh)
    before = [s.clone() for s in slabs]
    st = st._replace(phi=torch.from_numpy(
        np.pad(full["delta"][0], (0, spec.e_cap - e0))))
    st0 = st0._replace(phi=torch.from_numpy(full["delta"][0].copy()))
    bm0 = T.build_bitmap(ST0, st0, st0.active)
    _padded_equal(slabs, bm0, "build")
    for trial, (mask, ref) in enumerate(zip(masks, repeel)):
        same(T.peel(spec, st, torch.from_numpy(
            np.pad(mask, (0, spec.e_cap - e0))), bitmap=slabs,
            method="bitmap", engine="delta", mesh=mesh, device="cpu"),
            ref, trial)
        same(T.peel(ST0, st0, torch.from_numpy(mask), bitmap=bm0,
                    method="bitmap", engine="delta", device="cpu"), ref, trial)
    assert all(torch.equal(a, b) for a, b in zip(slabs, before))
    with pytest.raises(ValueError, match="word slabs"):
        T.peel(spec, st, st.active, bitmap=bm0, method="bitmap",
               engine="delta", mesh=mesh, device="cpu")


# -- the partitioned service, its restore and its replicas ------------------------

def _svc_graph():
    rng = np.random.default_rng(7)
    edges = [(i, j) for i in range(SVC_N) for j in range(i + 1, SVC_N)
             if rng.random() < 0.2]
    present = set(edges)
    absent = [(i, j) for i in range(SVC_N) for j in range(i + 1, SVC_N)
              if (i, j) not in present]
    rng.shuffle(absent)
    # 24 inserts then 8 deletes of base edges: four generations of 8
    ups = [(1, a, b) for a, b in absent[:24]] + \
        [(0, a, b) for a, b in sorted(present)[::7][:8]]
    return edges, ups


def _arrays(node):
    g = node.svc.graph if isinstance(node, (Replica, JC.Replica)) \
        else node.graph
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in g.state]


def _assert_bitwise(a, b):
    for name, x, y in zip(T.GraphState._fields, _arrays(a), _arrays(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _port(edges, root=None, **kw):
    return TrussService(SVC_N, edges, flush_every=8, e_cap=SVC_E_CAP,
                        support_method="bitmap", device="cpu",
                        store=None if root is None else TrussStore(str(root)),
                        **kw)


def _reference(edges, root=None):
    return JS.TrussService(SVC_N, edges, flush_every=8, e_cap=SVC_E_CAP,
                           support_method="bitmap",
                           store=None if root is None else JS.TrussStore(
                               str(root)))


@pytest.mark.parametrize("shards", [2, 4])
def test_partitioned_service_flush_bitwise(shards, tmp_path):
    """A node-partitioned service runs a write stream to the state of a
    ``repro`` mesh=None service at every generation; its restore, a
    partitioned replica and a replicated mesh=None replica agree too."""
    edges, ups = _svc_graph()
    mesh = make_shard_mesh(shards, device="cpu")
    ref = _reference(edges)
    svc = _port(edges, tmp_path, mesh=mesh, partition="nodes")
    for i, up in enumerate(ups):
        ref.submit(*up)
        svc.submit(*up)
        if i % 8 == 7:
            _assert_bitwise(ref, svc)
    orc = oracle.Oracle(SVC_N, edges)
    orc.apply(ups)
    assert svc.graph.phi_dict() == orc.phi
    _padded_equal(svc.graph._bitmap, ref.graph._bitmap, "service bitmap")
    svc.snapshot()

    back = TrussService.restore(TrussStore(str(tmp_path)),
                                support_method="bitmap", mesh=mesh,
                                partition="nodes", device="cpu")
    _assert_bitwise(back, svc)
    for kw in (dict(mesh=mesh, partition="nodes"), {}):
        rep = Replica(str(tmp_path), support_method="bitmap", device="cpu",
                      **kw)
        rep.poll()
        _assert_bitwise(rep, svc)


@pytest.mark.parametrize("writer", ["repro_torch", "repro"])
def test_replica_tails_other_package_across_layouts(writer, tmp_path):
    """A sharded ``partition="nodes"`` port primary tailed by a ``repro``
    mesh=None replica, then a ``repro`` primary tailed by a sharded
    partitioned port replica: bitwise equal at every generation."""
    edges, ups = _svc_graph()
    mesh = make_shard_mesh(2 if writer == "repro_torch" else 4, device="cpu")
    if writer == "repro_torch":
        primary = _port(edges, tmp_path, mesh=mesh, partition="nodes")
        rep = JC.Replica(str(tmp_path), "x0", support_method="bitmap")
    else:
        primary = _reference(edges, tmp_path)
        rep = Replica(str(tmp_path), "x0", support_method="bitmap",
                      mesh=mesh, partition="nodes", device="cpu")
    gens = []
    for i, up in enumerate(ups):
        primary.submit(*up)
        if i % 8 == 7:
            assert rep.poll() == primary.gen
            _assert_bitwise(rep, primary)
            gens.append(rep.gen)
    assert gens == [1, 2, 3, 4]
