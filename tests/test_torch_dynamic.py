"""The slice end to end: ``DynamicGraph`` of the port against
``repro.core.DynamicGraph`` and the pure-Python oracle under one seeded
stream that exercises every update path (progressive, fused, recompute,
capacity growth, batchUpdate re-decomposition) and the query views."""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import oracle
from repro.data.synthetic import er_graph
from repro_torch.launch.mesh import make_shard_mesh

N = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _components(edges) -> set:
    """Connected components of an edge list as frozensets of nodes."""
    parent = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            x = parent[x]
        return x

    for a, b in edges:
        parent[find(a)] = find(b)
    groups = {}
    for x in list(parent):
        groups.setdefault(find(x), set()).add(x)
    return {frozenset(g) for g in groups.values()}


def _label_components(labels, edges) -> set:
    groups = {}
    for lab, (a, b) in zip(labels.tolist(), edges.tolist()):
        if lab < 2**30:
            groups.setdefault(lab, set()).update((a, b))
    return {frozenset(g) for g in groups.values()}


def _batch(rng, present, n_del, n_ins):
    pres = sorted(present)
    dels = [pres[i] for i in rng.choice(len(pres), n_del, replace=False)]
    absent = [(i, j) for i in range(N) for j in range(i + 1, N)
              if (i, j) not in present]
    inss = [absent[i] for i in rng.choice(len(absent), n_ins, replace=False)]
    ups = [(0, a, b) for a, b in dels] + [(1, b, a) for a, b in inss]
    rng.shuffle(ups)
    return [tuple(map(int, u)) for u in ups]


def _check(gj, gt, present):
    phi = gt.phi_dict()
    assert phi == gj.phi_dict() == oracle.scratch_phi(N, present)
    assert gt.max_truss() == gj.max_truss()
    for k in (3, 4, gt.max_truss()):
        np.testing.assert_array_equal(gt.k_truss(k), np.asarray(gj.k_truss(k)))
        lab_t = gt.index.query(gt.state, k).numpy()
        np.testing.assert_array_equal(lab_t, np.asarray(gj.index.query(gj.state, k)))
        # components compared as sets (list order is not meaningful)
        members = [e for e, p in phi.items() if p >= k]
        assert (_label_components(lab_t, gt.state.edges.numpy())
                == _components(members))


@pytest.mark.slow  # the reference's jit compiles dominate (>5 s on CPU)
@pytest.mark.parametrize("method", ["bitmap", "sorted"])
def test_dynamic_graph_stream_matches_reference_and_oracle(method):
    rng = np.random.default_rng(17)
    edges = er_graph(N, 3.5, seed=3)
    present = {tuple(map(int, e)) for e in edges}
    # a tight e_cap so one 8-insert batch forces _grow; every fused batch
    # pads to 8 rows, which keeps the reference's jit compiles few
    e_cap0 = len(edges) + 6
    gj = J.DynamicGraph(N, edges, e_cap=e_cap0, support_method=method,
                        tracked_ks=(3, 4))
    gt = T.DynamicGraph(N, edges, e_cap=e_cap0, support_method=method,
                        tracked_ks=(3, 4), device="cpu")
    assert gt.spec == T.GraphSpec(*[getattr(gj.spec, f) for f in
                                    ("n_nodes", "d_max", "e_cap")])
    _check(gj, gt, present)
    steps = [("progressive", dict(n_del=2, n_ins=3), {}),
             ("fused", dict(n_del=6, n_ins=5), {}),
             ("recompute", dict(n_del=5, n_ins=5), {"engine": "recompute"}),
             ("grow", dict(n_del=0, n_ins=8), {}),
             ("progressive", dict(n_del=3, n_ins=2), {}),
             ("redecompose", dict(n_del=4, n_ins=6), None),
             ("fused", dict(n_del=8, n_ins=7), {})]
    for name, sizes, kw in steps:
        ups = _batch(rng, present, **sizes)
        if kw is None:
            gj.batch_update_then_decompose(ups)
            gt.batch_update_then_decompose(ups)
        else:
            gj.apply_batch(ups, **kw)
            gt.apply_batch(ups, **kw)
        for op, a, b in ups:
            (present.add if op == 1 else present.discard)((min(a, b), max(a, b)))
        assert gt.spec.e_cap == gj.spec.e_cap and gt.spec.d_max == gj.spec.d_max
        assert (tuple(int(x) for x in gt.last_peel_stats)
                == tuple(int(x) for x in gj.last_peel_stats)), name
        if method == "bitmap" and gt._bitmap is not None:
            np.testing.assert_array_equal(T.bitmap_to_numpy(gt._bitmap),
                                          np.asarray(gj._bitmap))
        _check(gj, gt, present)
    assert gt.spec.e_cap > e_cap0  # the grow step really regrew


def test_from_state_and_single_device_guards():
    edges = er_graph(N, 4, seed=5)
    gj = J.DynamicGraph(N, edges)
    arrays = [np.asarray(x) for x in gj.state]
    spec = T.GraphSpec(gj.spec.n_nodes, gj.spec.d_max, gj.spec.e_cap)
    gt = T.DynamicGraph.from_state(spec, arrays, device="cpu")
    assert gt.phi_dict() == gj.phi_dict()
    gt.apply_batch([(0, *map(int, edges[0])), (1, 0, N - 1)]
                   if (0, N - 1) not in gt.phi_dict() else
                   [(0, *map(int, edges[0]))])
    assert gt.phi_dict() == oracle.scratch_phi(N, gt.phi_dict().keys())
    with pytest.raises(TypeError):
        T.DynamicGraph(N, edges, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        T.DynamicGraph(N, edges, partition="nodes", device="cpu")
    gm = T.DynamicGraph(N, edges, mesh=make_shard_mesh(2, device="cpu"),
                        device="cpu")
    assert gm.spec.n_shards == 2 and gm.phi_dict() == gj.phi_dict()
    with pytest.raises(ValueError):
        gt.apply_batch([(1, 3, 3)])
