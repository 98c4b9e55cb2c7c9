"""The port's GNN family against ``repro``'s: the sampler's arrays, the
differentiable segment sum (K4's Function), the four models' losses and
gradients, GIN's graph logits, and the registry.

Inputs are the reference's smoke configs on its 48-node power-law graph
(``tests/test_archs.py``), with the reference's parameters carried across
by ``gnn.params_from_numpy``.  Tolerance: losses within rtol 1e-5 plus
atol 1e-6 of the reference's; every gradient leaf within rtol 1e-5 plus an
atol of 1e-6 or 1e-5 of the leaf's largest magnitude, whichever is larger,
of ``jax.grad`` (both sides compute float32 math; only the order of sums
differs).  The segment sum's backward is bitwise equal to ``jax.vjp``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget
from repro.data import sampler as jsampler
from repro.data import synthetic as jsynthetic
from repro.models import gnn as jgnn
from repro_torch.configs import REGISTRY, all_cells, get_config
from repro_torch.data import sampler, synthetic
from repro_torch.kernels import ops, ref
from repro_torch.models import gnn
from repro_torch.training.optimizer import tree_leaves, value_and_grad

RTOL, ATOL = 1e-5, 1e-6
GNN_ARCHS = ["gcn-cora", "gin-tu", "meshgraphnet", "dimenet"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_arrays(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _batch(cfg):
    edges = synthetic.powerlaw_graph(48, 3, seed=2)
    return sampler.make_gnn_batch(
        edges, 48, d_feat=8, n_classes=cfg.n_classes, with_pos=True,
        with_triplets=(cfg.model == "dimenet"), seed=3)


def _carried(cfg, d_in=8):
    jp = jgnn.init_params(cfg, jax.random.PRNGKey(0), d_in)
    return jp, gnn.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, exp, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(exp, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# sampler: every function gives the reference's arrays at the same seed
# ---------------------------------------------------------------------------

def test_sampler_arrays_identical():
    edges = synthetic.powerlaw_graph(60, 3, seed=7)
    np.testing.assert_array_equal(edges, jsynthetic.powerlaw_graph(60, 3, seed=7))
    c, jc = sampler.CSRGraph(60, edges), jsampler.CSRGraph(60, edges)
    for name in ("src_sorted", "adj", "indptr"):
        np.testing.assert_array_equal(getattr(c, name), getattr(jc, name))
    np.testing.assert_array_equal(c.neighbors(5), jc.neighbors(5))
    seeds = np.asarray([0, 3, 9, 17])
    for got, exp in zip(sampler.fanout_sample(c, seeds, (4, 3), seed=2),
                        jsampler.fanout_sample(jc, seeds, (4, 3), seed=2)):
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    for fn, kw in (("build_triplets", {"max_per_edge": 3}),
                   ("build_triplets_fixed", {"fanout": 3})):
        for got, exp in zip(getattr(sampler, fn)(src, dst, 60, seed=4, **kw),
                            getattr(jsampler, fn)(src, dst, 60, seed=4, **kw)):
            assert got.dtype == exp.dtype
            np.testing.assert_array_equal(got, exp)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    for n in (3, 6, 9):
        np.testing.assert_array_equal(sampler.pad_to(x, n, fill=-1),
                                      jsampler.pad_to(x, n, fill=-1))
    for kw in ({}, {"with_pos": True, "with_triplets": True,
                    "pad_nodes": 64, "pad_edges": 300,
                    "graph_id": np.arange(60) % 3}):
        _same_arrays(sampler.make_gnn_batch(edges, 60, 5, n_classes=4, seed=6, **kw),
                     jsampler.make_gnn_batch(edges, 60, 5, n_classes=4, seed=6, **kw))
    _same_arrays(sampler.make_batched_graphs(4, 8, 10, 6, n_classes=5, seed=1),
                 jsampler.make_batched_graphs(4, 8, 10, 6, n_classes=5, seed=1))
    np.testing.assert_array_equal(synthetic.random_positions(9, seed=3),
                                  jsynthetic.random_positions(9, seed=3))


# ---------------------------------------------------------------------------
# K4's Function: forward and backward against jax.ops.segment_sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,d,n", [(40, 5, 7), (300, 16, 31), (64, 1, 9)])
def test_segment_sum_function_matches_jax(e, d, n):
    """Ids span ``[-3, n + 3)``: those outside ``[0, n)`` are dropped
    forward and get a zero gradient backward (exactly)."""
    rng = np.random.default_rng(e + d + n)
    data = rng.normal(size=(e, d)).astype(np.float32)
    ids = rng.integers(-3, n + 3, size=e).astype(np.int32)
    cot = rng.normal(size=(n, d)).astype(np.float32)
    jout, vjp = jax.vjp(lambda x: jax.ops.segment_sum(x, jnp.asarray(ids),
                                                      num_segments=n),
                        jnp.asarray(data))
    (jgrad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(data).requires_grad_(True)
    out = ops.segment_sum(x, torch.from_numpy(ids), n)
    assert out.shape == (n, d) and out.dtype == torch.float32
    _close(out, jout, what="forward")
    (grad,) = torch.autograd.grad(out, x, torch.from_numpy(cot))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(jgrad))
    outside = (ids < 0) | (ids >= n)
    assert outside.any() and not grad.numpy()[outside].any()
    np.testing.assert_array_equal(
        ref.segment_sum_vjp_ref(torch.from_numpy(cot), torch.from_numpy(ids)).numpy(),
        np.asarray(jgrad))


def test_segment_sum_function_1d_and_padding_edges():
    """The GNN's 1-D path (``[E]`` as ``[E, 1]``) and its padding edges:
    masked-off messages at node ``pn - 1`` give zero gradient to both
    sides of a GCN layer."""
    cfg = get_config("gcn-cora").smoke
    edges = synthetic.powerlaw_graph(30, 2, seed=1)
    nb = sampler.make_gnn_batch(edges, 30, 6, n_classes=cfg.n_classes,
                                pad_nodes=32, pad_edges=200, seed=2)
    b = gnn.batch_to_torch(nb, "cpu")
    deg = gnn._segment_sum(b["edge_mask"].float(), b["edge_dst"], 32)
    np.testing.assert_array_equal(
        deg.numpy(), np.asarray(jax.ops.segment_sum(
            jnp.asarray(nb["edge_mask"], jnp.float32), jnp.asarray(nb["edge_dst"]),
            num_segments=32)))
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), 6)
    feat = b["node_feat"].clone().requires_grad_(True)
    loss = gnn.loss_fn(cfg, params, dict(b, node_feat=feat))
    (g,) = torch.autograd.grad(loss, feat)
    # padded nodes 30, 31 are masked out of the loss and reached only by
    # masked edges: no gradient flows to their features
    assert not g[30:].any() and g[:30].abs().sum() > 0


# ---------------------------------------------------------------------------
# the four models: loss and every gradient leaf against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_loss_and_grads_match_jax(arch_id):
    cfg = jget(arch_id).smoke
    assert dataclasses.asdict(cfg) == dataclasses.asdict(get_config(arch_id).smoke)
    nb = _batch(cfg)
    jp, tp = _carried(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jgnn.loss_fn(cfg, p, b)))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, grads = value_and_grad(lambda p, b: gnn.loss_fn(cfg, p, b), tp,
                                 gnn.batch_to_torch(nb, "cpu"))
    _close(loss, jloss, what="loss")
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl) and len(tl) > 0
    for i, (g, jg) in enumerate(zip(tl, jl)):
        assert tuple(g.shape) == jg.shape, i
        scale = float(np.abs(np.asarray(jg)).max())
        _close(g, jg, atol=max(ATOL, RTOL * scale), what=f"{arch_id} leaf {i}")
    assert any(float(g.abs().max()) > 0 for g in tl)


def test_params_round_trip_and_init_shapes():
    for arch_id in GNN_ARCHS:
        cfg = get_config(arch_id).smoke
        jp, tp = _carried(cfg)
        back = gnn.params_to_numpy(tp)
        assert jax.tree.structure(back) == jax.tree.structure(
            jax.tree.map(np.asarray, jp))
        own = gnn.init_params(cfg, torch.Generator().manual_seed(0), 8)
        assert [tuple(x.shape) for x in tree_leaves(own)] == \
            [x.shape for x in jax.tree.leaves(jp)]


def test_gin_graph_logits_on_batched_graphs():
    cfg = jget("gin-tu").smoke
    mb = sampler.make_batched_graphs(6, 8, 12, 8, n_classes=cfg.n_classes, seed=4)
    _same_arrays(mb, jsampler.make_batched_graphs(6, 8, 12, 8,
                                                  n_classes=cfg.n_classes, seed=4))
    jp, tp = _carried(cfg)
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}
    b = gnn.batch_to_torch(mb, "cpu")
    logits = gnn.gin_graph_logits(cfg, tp, b, 6)
    assert logits.shape == (6, cfg.n_classes)
    _close(logits, jax.jit(lambda p, bb: jgnn.gin_graph_logits(cfg, p, bb, 6))(
        jp, jmb))
    for model in ("gin-tu", "dimenet"):
        c = jget(model).smoke
        jp, tp = _carried(c)
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, bb: jgnn.loss_fn(c, p, bb, n_graphs=6)))(jp, jmb)
        loss, grads = value_and_grad(
            lambda p, bb: gnn.loss_fn(c, p, bb, n_graphs=6), tp, b)
        _close(loss, jl, what=f"{model} graph loss")
        for g, j in zip(tree_leaves(grads), jax.tree.leaves(jg)):
            _close(g, j, atol=max(ATOL, RTOL * float(np.abs(np.asarray(j)).max())),
                   what=f"{model} graph grads")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_complete_and_equal_to_reference():
    assert len(REGISTRY) == 10 and sorted(REGISTRY) == sorted(JREGISTRY)
    cells = sum(1 for c in REGISTRY.values() for _ in c.shapes)
    assert cells == 40
    runnable = sum(1 for c in REGISTRY.values() for _ in c.cells())
    skipped = sum(1 for c in REGISTRY.values() for _ in c.skipped_cells())
    assert runnable + skipped == 40 and skipped == 4
    assert len(all_cells()) == runnable
    for arch_id, jc in JREGISTRY.items():
        c = REGISTRY[arch_id]
        assert (c.family, c.notes) == (jc.family, jc.notes), arch_id
        assert dataclasses.asdict(c.model) == dataclasses.asdict(jc.model)
        assert dataclasses.asdict(c.smoke) == dataclasses.asdict(jc.smoke)
        assert c.shapes == jc.shapes
