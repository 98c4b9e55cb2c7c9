"""Per-(architecture x shape-cell) plans (port of ``repro.launch.specs``):
the function to run, its inputs as ``meta`` tensors (shapes and dtypes,
never allocated), and their in/out shardings under the reference's
partition rules.

The parameter structs come from the port's own ``init_params`` (run under
``FakeTensorMode``, each leaf then taken to ``meta``), not from a table of
shapes.  The LM plan describes its parameters in the reference's stacked
layout (``transformer.stack_layers``: ``layers`` as ``[L, ...]`` leaves),
so every leaf's path, shape, partition spec and shard shape compares one to
one with the reference's plan; its ``fn`` unstacks them with views, so
gradients and AdamW act on the stacked leaves.  A plan whose
``donate_argnums`` is ``(0, 1)`` (every train cell) steps with
``make_train_step(..., donate=True)``: its parameters and optimizer state
are updated in place, as the reference's donated buffers are.  ``fn``
binds the plan's mesh (the MoE expert block's model-sharded branch reads
it).  Leaf paths are jax's ``keystr`` form, e.g.
``['layers']['attn']['wq']``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.base import ArchConfig, GNNConfig, LMConfig, RecsysConfig, ShapeCell
from ..models import gnn, recsys, transformer
from ..models.layers import COMPUTE_DTYPE
from ..training import optimizer as opt_lib
from .mesh import (NamedSharding, PartitionSpec as P, dp_axes, model_size,
                   named, replicated)

I32, F32, BOOL = torch.int32, torch.float32, torch.bool


def S(shape, dtype) -> torch.Tensor:
    """A ``ShapeDtypeStruct``: a ``meta`` tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass
class CellPlan:
    arch_id: str
    cell: str
    fn: Callable
    args: tuple                 # trees of meta tensors
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    mesh_program: bool = False  # the traced program reads the mesh


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_paths(tree, prefix: str = "") -> list:
    """``(keystr path, leaf)`` pairs in jax's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _map_paths(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(v, fn, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def sharded_leaves(shardings, tree) -> list:
    """``(sharding, leaf)`` pairs of ``tree`` under ``shardings``, a tree of
    ``NamedSharding`` of the same structure or a prefix of it (a sharding
    covers every leaf below it).  Raises where the structures differ."""
    if isinstance(shardings, NamedSharding):
        return [(shardings, leaf) for _, leaf in tree_paths(tree)]
    if isinstance(shardings, dict) and isinstance(tree, dict) \
            and set(shardings) == set(tree):
        return [x for k in sorted(tree)
                for x in sharded_leaves(shardings[k], tree[k])]
    if isinstance(shardings, (list, tuple)) and isinstance(tree, (list, tuple)) \
            and len(shardings) == len(tree):
        return [x for s, t in zip(shardings, tree) for x in sharded_leaves(s, t)]
    raise ValueError(f"sharding tree {type(shardings).__name__} does not "
                     f"match a {type(tree).__name__}")


def shard_bytes(shardings, tree) -> int:
    """Bytes of one position's shards of every leaf of ``tree``."""
    total = 0
    for sh, leaf in sharded_leaves(shardings, tree):
        n = 1
        for x in sh.shard_shape(leaf.shape):
            n *= x
        total += n * leaf.element_size()
    return total


def _shard_tree(tree, spec_fn, mesh):
    return _map_paths(tree, lambda path, leaf: NamedSharding(
        mesh, spec_fn(path, leaf)))


def _param_structs(init) -> dict:
    """The tree ``init(gen)`` returns, as meta tensors: run under
    ``FakeTensorMode`` with a CPU generator, nothing drawn or allocated."""
    gen = torch.Generator().manual_seed(0)
    with FakeTensorMode():
        tree = init(gen)
    return _map_paths(tree, lambda _, t: S(t.shape, t.dtype))


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _with_fsdp(spec: P, shape, fsdp_axes, dsize: int) -> P:
    """Add FSDP sharding on the first free dim divisible by the DP size
    (prefers the stacked-layer dim; falls back to d_model etc.)."""
    if not fsdp_axes:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for dim in range(len(shape)):
        if parts[dim] is None and shape[dim] % dsize == 0 and shape[dim] >= dsize:
            parts[dim] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
            break
    return P(*parts)


def lm_param_spec(cfg: LMConfig, model_axis_size: int, data_axes=None):
    """TP rules on the "model" axis + FSDP sharding over the data axes
    (train cells only), on the stacked ``[L, ...]`` leaves."""
    ep = cfg.moe_experts > 0 and cfg.moe_experts % model_axis_size == 0
    fsdp_axes = tuple(a[0] for a in (data_axes or ()))
    dsize = 1
    for a in (data_axes or ()):
        dsize *= a[1]

    def base(path: str, nd: int) -> P:
        if "embed" in path and "unembed" not in path:
            return P("model", None)
        if "unembed" in path:
            return P(None, "model")
        if any(k in path for k in ("wq", "wk", "wv")):
            return P(None, None, "model")
        if "wo" in path:
            return P(None, "model", None)
        if "router" in path:
            return P(None, None, None)
        if "moe" in path and nd == 4:  # [L, E, din, dout]
            if ep:
                return P(None, "model", None, None)
            if "w_down" in path:
                return P(None, None, "model", None)
            return P(None, None, None, "model")
        if nd == 3 and ("w_gate" in path or "w_up" in path):
            return P(None, None, "model")
        if nd == 3 and "w_down" in path:
            return P(None, "model", None)
        return P(*([None] * nd))

    def rule(path: str, leaf) -> P:
        spec = base(path, len(leaf.shape))
        return _with_fsdp(spec, leaf.shape, fsdp_axes, dsize)

    return rule


def _lm_param_structs(cfg: LMConfig) -> dict:
    return transformer.stack_layers(
        _param_structs(lambda gen: transformer.init_params(cfg, gen)))


def _opt_structs(param_structs):
    f32 = lambda s: S(s.shape, F32)  # noqa: E731
    return {"mu": opt_lib.tree_map(f32, param_structs),
            "nu": opt_lib.tree_map(f32, param_structs),
            "step": S((), I32)}


def _opt_shardings(param_shardings, mesh):
    return {"mu": param_shardings, "nu": param_shardings,
            "step": replicated(mesh)}


def build_lm_cell(arch: ArchConfig, cell: ShapeCell, mesh) -> CellPlan:
    cfg: LMConfig = arch.model
    dp = dp_axes(mesh)
    p_structs = _lm_param_structs(cfg)
    # FSDP over the data axes only where optimizer states exist (training);
    # serving keeps params replicated across data for latency
    data_axes = ([(a, mesh.shape[a]) for a in ("pod", "data") if a in mesh.axis_names]
                 if cell.kind == "train" else None)
    rule = lm_param_spec(cfg, model_size(mesh), data_axes=data_axes)
    p_shard = _shard_tree(p_structs, rule, mesh)
    repl = replicated(mesh)
    # the expert block's model-sharded branch runs each mesh position
    mesh_program = bool(cfg.moe_experts) and \
        cfg.moe_experts % model_size(mesh) != 0
    plan = dict(mesh_program=mesh_program)

    if cell.kind == "train":
        b, s = cell.params["batch"], cell.params["seq"]
        step_fn = opt_lib.make_train_step(
            lambda p, batch: transformer.loss_fn(
                cfg, transformer.unstack_layers(p), batch,
                xent_chunk=min(512, s), mesh=mesh), opt_lib.AdamWConfig(),
            donate=True)
        o_structs = _opt_structs(p_structs)
        batch_structs = {"tokens": S((b, s), I32), "targets": S((b, s), I32)}
        batch_shard = {"tokens": named(mesh, dp, None),
                       "targets": named(mesh, dp, None)}
        return CellPlan(
            arch.arch_id, cell.name, step_fn,
            (p_structs, o_structs, batch_structs),
            (p_shard, _opt_shardings(p_shard, mesh), batch_shard),
            (p_shard, _opt_shardings(p_shard, mesh),
             {"grad_norm": repl, "lr": repl, "loss": repl}),
            donate_argnums=(0, 1), **plan)

    if cell.kind == "prefill":
        b, s = cell.params["batch"], cell.params["seq"]

        def fn(params, tokens):
            return transformer.prefill(cfg, transformer.unstack_layers(params),
                                       tokens, mesh=mesh)

        return CellPlan(
            arch.arch_id, cell.name, fn, (p_structs, S((b, s), I32)),
            (p_shard, named(mesh, dp, None)),
            named(mesh, dp, "model"), **plan)

    if cell.kind in ("decode", "long_decode"):
        b, s = cell.params["batch"], cell.params["seq"]
        c = transformer.cache_len(cfg, s)
        bdp = dp if cell.kind == "decode" else None  # batch=1: unshardable
        cache_structs = {
            "k": S((cfg.n_layers, b, c, cfg.n_kv, cfg.head_dim), COMPUTE_DTYPE),
            "v": S((cfg.n_layers, b, c, cfg.n_kv, cfg.head_dim), COMPUTE_DTYPE)}
        cache_shard = {k: named(mesh, None, bdp, "model", None, None)
                       for k in ("k", "v")}

        def fn(params, cache, token, pos):
            return transformer.decode_step(
                cfg, transformer.unstack_layers(params), cache, token, pos,
                mesh=mesh)

        args = (p_structs, cache_structs, S((b,), I32), S((), I32))
        return CellPlan(
            arch.arch_id, cell.name, fn, args,
            (p_shard, cache_shard, named(mesh, bdp), repl),
            (named(mesh, bdp, "model"), cache_shard),
            donate_argnums=(1,), **plan)

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _round_up(x: int, q: int = 512) -> int:
    """Pad quantum: edge/triplet arrays shard over up to 32 DP ways."""
    return -(-x // q) * q


def _gnn_batch_structs(arch: ArchConfig, cell: ShapeCell):
    """Static padded shapes per cell (node-replicated, edge-sharded layout)."""
    m: GNNConfig = arch.model
    p = cell.params
    need_pos = m.model in ("meshgraphnet", "dimenet")
    need_trip = m.model == "dimenet"
    if cell.kind == "full_graph":
        n, e2, f = p["n_nodes"], _round_up(2 * p["n_edges"]), p["d_feat"]
        n_graphs = 0
    elif cell.kind == "minibatch":
        bn = p["batch_nodes"]
        f1, f2 = p["fanout"]
        n = bn * (1 + f1 + f1 * f2)
        e2 = _round_up(bn * f1 + bn * f1 * f2)
        f = p["d_feat"]
        n_graphs = 0
    else:  # batched_graphs
        b = p["batch"]
        n, e2, f = b * p["n_nodes"], _round_up(2 * b * p["n_edges"]), p["d_feat"]
        n_graphs = b
    batch = {
        "node_feat": S((n, f), F32),
        "edge_src": S((e2,), I32),
        "edge_dst": S((e2,), I32),
        "edge_mask": S((e2,), BOOL),
        "node_mask": S((n,), BOOL),
        "labels": S((n,), I32),
        "graph_id": S((n,), I32),
    }
    if m.model == "meshgraphnet":
        batch["targets"] = S((n, 3), F32)
    if need_pos:
        batch["pos"] = S((n, 3), F32)
    if need_trip:
        t = 8 * e2  # capped triplets (sampler cap = 8/edge)
        batch["triplet_kj"] = S((t,), I32)
        batch["triplet_ji"] = S((t,), I32)
        batch["triplet_mask"] = S((t,), BOOL)
        if n_graphs:
            batch["graph_targets"] = S((n_graphs,), F32)
        else:
            batch["energy_target"] = S((), F32)
    if n_graphs and m.model == "gin":
        batch["graph_labels"] = S((n_graphs,), I32)
    return batch, n_graphs, f


def _gnn_batch_shardings(batch_structs, mesh):
    dp = dp_axes(mesh)

    def spec(name: str, leaf) -> P:
        if name.startswith(("edge_", "triplet_")):
            return P(dp, *([None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))

    return {k: NamedSharding(mesh, spec(k, v)) for k, v in batch_structs.items()}


def build_gnn_cell(arch: ArchConfig, cell: ShapeCell, mesh) -> CellPlan:
    m: GNNConfig = arch.model
    batch_structs, n_graphs, d_in = _gnn_batch_structs(arch, cell)
    p_structs = _param_structs(lambda gen: gnn.init_params(m, gen, d_in))
    repl_tree = opt_lib.tree_map(lambda _: replicated(mesh), p_structs)
    repl = replicated(mesh)
    step_fn = opt_lib.make_train_step(
        lambda p, b: gnn.loss_fn(m, p, b, n_graphs=n_graphs),
        opt_lib.AdamWConfig(), donate=True)
    o_structs = _opt_structs(p_structs)
    o_shard = _opt_shardings(repl_tree, mesh)
    b_shard = _gnn_batch_shardings(batch_structs, mesh)
    return CellPlan(
        arch.arch_id, cell.name, step_fn,
        (p_structs, o_structs, batch_structs),
        (repl_tree, o_shard, b_shard),
        (repl_tree, o_shard, {"grad_norm": repl, "lr": repl, "loss": repl}),
        donate_argnums=(0, 1))


# ---------------------------------------------------------------------------
# recsys family
# ---------------------------------------------------------------------------

def recsys_param_spec(path: str, leaf) -> P:
    if "table" in path:
        return P("model", None)
    if "linear_w" in path:
        return P("model")
    return P(*([None] * len(leaf.shape)))


def build_recsys_cell(arch: ArchConfig, cell: ShapeCell, mesh) -> CellPlan:
    cfg: RecsysConfig = arch.model
    dp = dp_axes(mesh)
    p_structs = _param_structs(lambda gen: recsys.init_params(cfg, gen))
    p_shard = _shard_tree(p_structs, recsys_param_spec, mesh)
    repl = replicated(mesh)

    def batch_structs(b):
        return {
            "sparse_ids": S((b, cfg.n_sparse), I32),
            "multihot_ids": S((b, cfg.n_multihot, cfg.bag_size), I32),
            "dense": S((b, cfg.n_dense), F32),
            "labels": S((b,), I32),
        }

    def batch_shardings(b):
        return {k: named(mesh, dp, *([None] * (len(v.shape) - 1)))
                for k, v in batch_structs(b).items()}

    if cell.kind == "train_batch":
        b = cell.params["batch"]
        step_fn = opt_lib.make_train_step(
            lambda p, bt: recsys.loss_fn(cfg, p, bt), opt_lib.AdamWConfig(),
            donate=True)
        o_structs = _opt_structs(p_structs)
        o_shard = _opt_shardings(p_shard, mesh)
        return CellPlan(
            arch.arch_id, cell.name, step_fn,
            (p_structs, o_structs, batch_structs(b)),
            (p_shard, o_shard, batch_shardings(b)),
            (p_shard, o_shard, {"grad_norm": repl, "lr": repl, "loss": repl}),
            donate_argnums=(0, 1))

    if cell.kind == "serve":
        b = cell.params["batch"]

        def fn(params, batch):
            return recsys.serve(cfg, params, batch)

        return CellPlan(
            arch.arch_id, cell.name, fn,
            (p_structs, batch_structs(b)),
            (p_shard, batch_shardings(b)),
            named(mesh, dp))

    if cell.kind == "retrieval":
        b = cell.params["batch"]
        nc = cell.params["n_candidates"]
        bs = batch_structs(b)
        bs["candidate_ids"] = S((nc,), I32)
        bshard = {k: named(mesh, *([None] * len(v.shape)))
                  for k, v in bs.items()}
        bshard["candidate_ids"] = named(mesh, dp)

        def fn(params, batch):
            return recsys.retrieval_score(cfg, params, batch)

        return CellPlan(
            arch.arch_id, cell.name, fn, (p_structs, bs),
            (p_shard, bshard), repl)

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def build_cell(arch: ArchConfig, cell: ShapeCell, mesh) -> CellPlan:
    if arch.family == "lm":
        return build_lm_cell(arch, cell, mesh)
    if arch.family == "gnn":
        return build_gnn_cell(arch, cell, mesh)
    if arch.family == "recsys":
        return build_recsys_cell(arch, cell, mesh)
    raise ValueError(arch.family)
