"""The GNN family at full config against ``repro``'s, on each cell kind's
batch, and ``chip_smoke.py``'s glue for the GNN cells on the card.

- Parity: each of the four archs at its full ``GNNConfig`` (the smoke
  configs are ``tests/test_torch_gnn.py``'s), the loss and every gradient
  leaf against ``jax.value_and_grad`` of ``repro.models.gnn.loss_fn`` on
  carried parameters, on three tiny batches: a full graph (48 nodes), a
  directed fanout minibatch from a 200-node graph with fanout (3, 2) built
  as ``chip_smoke.gnn_cell_batch`` builds ``minibatch_lg``'s, and 4 batched
  graphs of 8 nodes with the ``n_graphs`` readout.  Tolerance: the loss
  within rtol 1e-5 plus atol 1e-6, each leaf within rtol 1e-5 plus an atol
  of 1e-6 or 1e-5 of the leaf's largest magnitude, whichever is larger
  (float32 on both sides; only the order of sums differs).
- A label outside the logits: ``gnn._gold`` reads NaN and passes no
  gradient there, as ``jnp.take_along_axis`` does; the whole loss and its
  gradients then equal the reference's.
- The glue: ``gnn_cell_batch`` at scaled-down cells of each kind gives the
  plan's tree (``specs.build_cell`` on a CPU test mesh) and the dry-run's
  argument bytes; a full graph has exactly the cell's edges, from the
  smallest ``m_per_node`` that has them, and only ``_round_up``'s padding;
  a minibatch's directed edges are neither doubled nor cut; and
  ``k4_per_step`` equals the count of ``gnn._segment_sum`` calls in one
  step, for each arch and kind; ``relu_tape`` records and replays relu
  decisions; ``step_vs_plain`` runs on the CPU.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import gnn as jgnn
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import sampler, synthetic
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import gnn
from repro_torch.training.optimizer import tree_leaves, value_and_grad

RTOL, ATOL = 1e-5, 1e-6
RELU_TIE = 1e-4      # a relu decision the packages may take apart
GNN_ARCHS = ["gcn-cora", "gin-tu", "meshgraphnet", "dimenet"]
D_FEAT = 8
# scaled-down cells of each kind: the molecule cell's 2 x 8 x 32 directed
# edge slots fill the plans' 512-slot pad exactly, as 2 x 128 x 64 does
CELLS = {
    "full_graph": ShapeCell("full_graph_sm", "full_graph",
                            {"n_nodes": 60, "n_edges": 150, "d_feat": D_FEAT}),
    "minibatch": ShapeCell("minibatch_lg", "minibatch",
                           {"n_nodes": 200, "n_edges": 1200, "batch_nodes": 8,
                            "fanout": (3, 2), "d_feat": D_FEAT}),
    "batched_graphs": ShapeCell("molecule", "batched_graphs",
                                {"n_nodes": 10, "n_edges": 32, "batch": 8,
                                 "d_feat": D_FEAT}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (its ``main`` is not run)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scaled(arch_id):
    """The arch at full config with the scaled-down cells."""
    return dataclasses.replace(get_config(arch_id), shapes=tuple(CELLS.values()))


def _close(got, exp, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(exp, np.float32), rtol=RTOL,
                               atol=atol, err_msg=what)


def _parity_batch(cs, arch_id, kind):
    """The numpy batch and ``n_graphs`` of one parity case."""
    cfg = get_config(arch_id).model
    if kind == "full_graph":
        nb = sampler.make_gnn_batch(
            synthetic.powerlaw_graph(48, 3, seed=2), 48, d_feat=D_FEAT,
            n_classes=cfg.n_classes, with_pos=True,
            with_triplets=cfg.model == "dimenet", seed=3)
        return nb, 0
    if kind == "minibatch":
        nb, n_graphs, _ = cs.gnn_cell_batch(_scaled(arch_id), CELLS["minibatch"])
        return nb, n_graphs
    nb = sampler.make_batched_graphs(4, 8, 12, D_FEAT, n_classes=cfg.n_classes,
                                     seed=4)
    # node labels over the model's classes (make_batched_graphs draws them
    # over 16 whatever n_classes; test_out_of_range_labels_read_nan_as_the_
    # reference has the labels past the logits)
    nb["labels"] = nb["labels"] % np.int32(cfg.n_classes)
    return nb, 4


def _loss_and_grads_against_jax(cfg, nb, n_graphs, what, monkeypatch):
    """The port's loss and gradients, held to the reference's at matched
    relu decisions: each MLP relu of the reference (``_mlp_apply``) takes
    the port's decision, and every decision that differs from the
    reference's own must be a near-tie, its pre-activation within
    ``RELU_TIE`` of 0.  At full depth (meshgraphnet's 15 blocks) such ties
    occur: fp32 sums in another order move a pre-activation by ~1e-6, and
    one flipped unit moves the gradients by ~1e-3 of their scale."""
    jp = jgnn.init_params(cfg, jax.random.PRNGKey(0), D_FEAT)
    tp = gnn.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    masks, mlp = [], gnn._mlp_apply

    def recorded(p, x, act=torch.relu, final_act=False):
        def relu(z):
            masks.append((z > 0).numpy())
            return act(z)
        return mlp(p, x, act=relu, final_act=final_act)

    monkeypatch.setattr(gnn, "_mlp_apply", recorded)
    loss, grads = value_and_grad(
        lambda p, b: gnn.loss_fn(cfg, p, b, n_graphs=n_graphs), tp,
        gnn.batch_to_torch(nb, "cpu"))
    monkeypatch.setattr(gnn, "_mlp_apply", mlp)
    jmlp = jgnn._mlp_apply

    def loss_at_matched(p, b):
        decided, zs = iter(masks), []

        def matched(q, x, act=jax.nn.relu, final_act=False):
            def relu(z):
                zs.append(z)
                return jnp.where(next(decided), z, 0.0)
            return jmlp(q, x, act=relu, final_act=final_act)

        monkeypatch.setattr(jgnn, "_mlp_apply", matched)
        try:
            return jgnn.loss_fn(cfg, p, b, n_graphs=n_graphs), zs
        finally:
            monkeypatch.setattr(jgnn, "_mlp_apply", jmlp)

    (jloss, zs), jgrads = jax.jit(jax.value_and_grad(
        loss_at_matched, has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    assert len(zs) == len(masks)
    for z, m in zip(zs, masks):
        z = np.asarray(z)
        assert (np.abs(z[(z > 0) != m]) <= RELU_TIE).all(), what
    _close(loss, jloss, what=f"{what} loss")
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl) and len(tl) > 0
    for i, (g, jg) in enumerate(zip(tl, jl)):
        assert tuple(g.shape) == jg.shape, i
        scale = float(np.abs(np.asarray(jg)).max())
        _close(g, jg, atol=max(ATOL, RTOL * scale), what=f"{what} leaf {i}")
    return loss, tl


# ---------------------------------------------------------------------------
# parity at full config, every cell kind
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_full_config_loss_and_grads_match_jax(cs, monkeypatch, arch_id, kind):
    cfg = jget(arch_id).model
    assert dataclasses.asdict(cfg) == dataclasses.asdict(get_config(arch_id).model)
    nb, n_graphs = _parity_batch(cs, arch_id, kind)
    loss, grads = _loss_and_grads_against_jax(cfg, nb, n_graphs,
                                              f"{arch_id}/{kind}", monkeypatch)
    assert np.isfinite(float(loss))
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_out_of_range_labels_read_nan_as_the_reference(monkeypatch):
    """gcn-cora (7 classes) on ``make_batched_graphs``'s own node labels,
    drawn over 16 classes: the reference's loss is NaN
    (``jnp.take_along_axis`` fills a label past the logits) and its
    gradients finite; the port's equal them, where ``torch.gather`` raised."""
    cfg = jget("gcn-cora").model
    nb = sampler.make_batched_graphs(4, 8, 12, D_FEAT, n_classes=cfg.n_classes,
                                     seed=4)
    assert nb["labels"].max() >= cfg.n_classes
    loss, grads = _loss_and_grads_against_jax(cfg, nb, 4, "gcn/out of range",
                                              monkeypatch)
    assert np.isnan(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_gold_takes_along_axis_as_jax():
    """``gnn._gold`` against ``jnp.take_along_axis``: values (a negative
    label counting from the end, one outside ``[-C, C)`` NaN) and the
    gradient (none through a NaN read)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(7, 5)).astype(np.float32)
    labels = np.array([0, 4, -1, -5, 5, -6, 9], np.int32)

    def jgold(x):
        return jnp.take_along_axis(x, jnp.asarray(labels)[:, None], -1)[:, 0]

    x = torch.from_numpy(logits).requires_grad_(True)
    got = gnn._gold(x, torch.from_numpy(labels))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(jgold(logits)))
    w = rng.normal(size=7).astype(np.float32)
    (g,) = torch.autograd.grad(torch.nansum(got * torch.from_numpy(w)), x)
    jg = jax.grad(lambda z: jnp.nansum(jgold(z) * w))(logits)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------------
# chip_smoke's glue for phase 19
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_cell_inputs_equal_the_plan(cs, arch_id, kind):
    """The card's arguments (``_plan_args`` over ``gnn_cell_batch``) have
    the plan's paths, shapes and dtypes and the dry-run's argument bytes;
    the plan's step (on a clone of the arguments it donates) equals the
    model's own step bitwise on the CPU."""
    arch, cell = _scaled(arch_id), CELLS[kind]
    plan = specs.build_cell(arch, cell, make_test_mesh((1, 1), device="cpu"))
    args = cs._plan_args(arch, cell, plan, "cpu")
    assert cs._tree_sig(args) == cs._tree_sig(plan.args)
    rec = dryrun.run_cell(arch, cell.name, make_test_mesh((1, 1), device="meta"),
                          "1x1")
    assert rec["ok"], rec.get("error")
    assert sum(x.numel() * x.element_size() for _, x in specs.tree_paths(args)) \
        == rec["argument_size_in_bytes"]
    n_graphs = specs._gnn_batch_structs(arch, cell)[1]
    assert n_graphs == (8 if kind == "batched_graphs" else 0)
    # the plan's step donates its parameters and optimizer state: it steps
    # on a clone, the model's own (returning) step on the originals
    out = plan.fn(*cs.clone_donated(args))
    direct = cs._direct(arch, args, n_graphs)
    for (p, x), (_, y) in zip(specs.tree_paths(out), specs.tree_paths(direct)):
        assert torch.equal(x, y), p
    assert np.isfinite(float(out[2]["loss"]))


def test_full_graph_has_exactly_the_cells_edges(cs):
    """The smallest ``m_per_node`` with enough edges (``m - 1`` falls
    short), the edges truncated to the cell's count, and only
    ``_round_up``'s padding slots; at ``full_graph_sm``'s size the edges
    are the ones phase 16 ran (``powerlaw_graph(2708, 4)[:10556]``)."""
    cell = CELLS["full_graph"]
    n, n_edges = cell.params["n_nodes"], cell.params["n_edges"]
    edges, info = cs.full_graph_edges(n, n_edges)
    m = info["m_per_node"]
    assert len(edges) == n_edges and info["tried"][m]["edges"] >= n_edges
    assert info["tried"][m - 1]["edges"] < n_edges
    np.testing.assert_array_equal(
        edges, synthetic.powerlaw_graph(n, m, seed=cs.PLAN_SEED)[:n_edges])
    nb, _, built = cs.gnn_cell_batch(_scaled("gcn-cora"), cell)
    assert int(nb["edge_mask"].sum()) == built["real_edge_slots"] == 2 * n_edges
    assert built["padding_edge_slots"] == specs._round_up(2 * n_edges) - 2 * n_edges
    assert 0 <= built["padding_edge_slots"] < 512
    assert not nb["edge_mask"][2 * n_edges:].any()
    sm, sm_info = cs.full_graph_edges(2708, 10556)
    assert sm_info["m_per_node"] == 4
    np.testing.assert_array_equal(sm, synthetic.powerlaw_graph(2708, 4)[:10556])


def test_minibatch_edges_are_neither_doubled_nor_cut(cs):
    """The sample's directed edges sit in the batch as they are, in order:
    ``batch_nodes · (f1 + f1 · f2)`` of them, each once, the padding after
    them on node ``pad_nodes - 1``; DimeNet's triplets index those edges."""
    cell = CELLS["minibatch"]
    nodes, src, dst, info = cs.minibatch_sample(cell)
    assert len(src) == 8 * (3 + 3 * 2) == info["sampled_edges"]
    assert info["min_degree"] >= 3
    arch = _scaled("dimenet")
    nb, _, built = cs.gnn_cell_batch(arch, cell, (nodes, src, dst, info))
    e, pn = len(src), nb["node_feat"].shape[0]
    assert built["real_edge_slots"] == e == int(nb["edge_mask"].sum())
    np.testing.assert_array_equal(nb["edge_src"][:e], src)
    np.testing.assert_array_equal(nb["edge_dst"][:e], dst)
    assert (nb["edge_src"][e:] == pn - 1).all() and (nb["edge_dst"][e:] == pn - 1).all()
    assert int(nb["node_mask"].sum()) == len(nodes)
    t_kj, _, tmask = sampler.build_triplets_fixed(src, dst, len(nodes),
                                                  fanout=cs.TRIPLET_FANOUT)
    np.testing.assert_array_equal(nb["triplet_kj"][:len(t_kj)], t_kj)
    np.testing.assert_array_equal(nb["triplet_mask"][:len(tmask)], tmask)
    assert len(nb["triplet_kj"]) == cs.TRIPLET_FANOUT * len(nb["edge_src"])
    # a batch through make_gnn_batch would add each edge's reverse
    doubled = sampler.make_gnn_batch(np.stack([src, dst], 1), len(nodes), D_FEAT)
    assert int(doubled["edge_mask"].sum()) == 2 * e


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_k4_per_step_counts_the_segment_sums(cs, monkeypatch, arch_id, kind):
    """``k4_per_step`` (phase 19's launch gate) against the calls of
    ``gnn._segment_sum`` in one step of the plan on the CPU."""
    arch, cell = _scaled(arch_id), CELLS[kind]
    plan = specs.build_cell(arch, cell, make_test_mesh((1, 1), device="cpu"))
    args = cs._plan_args(arch, cell, plan, "cpu")
    calls, inner = [], gnn._segment_sum
    monkeypatch.setattr(gnn, "_segment_sum",
                        lambda *a: calls.append(a[2]) or inner(*a))
    plan.fn(*args)
    n_graphs = specs._gnn_batch_structs(arch, cell)[1]
    assert len(calls) == cs.k4_per_step(arch.model, n_graphs)


def test_relu_tape_replays_the_recorded_decisions(cs):
    """``relu_tape``: a replay of a step's own recording gives its loss and
    gradients bitwise with no decision apart; with one recorded decision
    flipped, that decision is counted apart (its ``|z|`` over its layer's
    largest as ``tie``) and the replay follows the tape, not ``z``."""
    arch, cell = _scaled("meshgraphnet"), CELLS["full_graph"]
    plan = specs.build_cell(arch, cell, make_test_mesh((1, 1), device="cpu"))
    params, _, batch = cs._plan_args(arch, cell, plan, "cpu")
    loss_fn = lambda p, b: gnn.loss_fn(arch.model, p, b)
    with cs.relu_tape() as tape:
        loss, grads = value_and_grad(loss_fn, params, batch)
    assert len(tape["masks"]) == 2 * (2 + 2 * arch.model.n_layers) + 1
    with cs.relu_tape(tape) as replayed:
        loss2, grads2 = value_and_grad(loss_fn, params, batch)
    assert replayed["apart"] == 0 and replayed["tie"] == 0.0
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                 tree_leaves(grads2)))
    tape["masks"][-1][0, 0] = ~tape["masks"][-1][0, 0]    # the decoder's
    with cs.relu_tape(tape) as flipped:
        loss3, _ = value_and_grad(loss_fn, params, batch)
    assert flipped["apart"] == 1 and 0 < flipped["tie"] <= 1
    assert not torch.equal(loss, loss3)


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch_id", ["gin-tu", "dimenet"])
def test_step_vs_plain_on_the_cpu(cs, arch_id, kind):
    """``chip_smoke.step_vs_plain`` on a plan's arguments on the CPU, where
    both routes run the plain version: nothing apart, K4's inputs as many
    as ``k4_per_step``, each equal to the in-order sum."""
    arch, cell = _scaled(arch_id), CELLS[kind]
    plan = specs.build_cell(arch, cell, make_test_mesh((1, 1), device="cpu"))
    params, _, batch = cs._plan_args(arch, cell, plan, "cpu")
    n_graphs = specs._gnn_batch_structs(arch, cell)[1]
    errs, seen = cs.step_vs_plain(
        ops, ref, lambda p, b: gnn.loss_fn(arch.model, p, b, n_graphs=n_graphs),
        params, batch, f"{arch_id}/{kind}")
    assert len(seen) == cs.k4_per_step(arch.model, n_graphs)
    assert errs["loss_abs_err"] == 0.0 and max(errs["grad_rel_err"]) == 0.0
    assert errs["k4_unequal_elements"] == 0 and errs["relu_apart"] == 0
