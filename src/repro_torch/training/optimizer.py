"""Optimizers from scratch (PyTorch port of ``repro/training/optimizer.py``):
AdamW + SGD, global-norm clipping, warmup-cosine / linear schedules.

Parameters, gradients and optimizer states are trees of tensors (dicts and
lists), as the reference's pytrees are; a tree's leaves are visited with
dict keys in sorted order, as ``jax.tree`` visits them, so sums over leaves
add in the reference's order.  The AdamW state keeps the reference's keys
(``mu``, ``nu``, an int32 0-d ``step``), so optimizer checkpoints cross
packages.  ``adamw_update`` returns new tensors and never writes into its
inputs, as ``loop.run`` and ``launch/train.py`` use it (the reference's
loop jits without donation).  ``adamw_update_`` writes the same values,
bit for bit, into the parameters and state it is given: the port's
counterpart of ``jax.jit(..., donate_argnums=(0, 1))``, which the cell
plans' train steps (``make_train_step(..., donate=True)``) record.
``make_train_step`` takes the gradient with ``torch.autograd.grad``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable

import torch

F32 = torch.float32
# elements a slice of ``adamw_update_``: its temporaries are at most three
# fp32 slices (192 MiB), whatever a leaf's size
ADAMW_SLICE = 1 << 24


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """The leaves of a dict/list tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # cosine | linear | constant


def schedule_value(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d integer tensor), float32."""
    s = step.to(F32)
    warm = torch.minimum(s / max(cfg.warmup_steps, 1), torch.ones_like(s))
    if cfg.schedule in ("cosine", "linear"):
        t = (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
        t = torch.minimum(torch.maximum(t, torch.zeros_like(t)), torch.ones_like(t))
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * t))
        else:
            decay = 1.0 - t
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.minimum(torch.ones_like(gn),
                         max_norm / torch.maximum(gn, torch.full_like(gn, 1e-12)))


def clip_by_global_norm(tree, max_norm: float):
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), gn


def adamw_init(params) -> dict:
    zeros = lambda p: tree_map(lambda x: torch.zeros_like(x, dtype=F32), p)
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """One AdamW step: ``(new params, new state, {"grad_norm", "lr"})``;
    every returned tensor is new."""
    step = opt_state["step"] + 1
    lr = schedule_value(cfg, step)
    if cfg.clip_norm is not None:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gn = global_norm(grads)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(F32)
    c1 = 1 - torch.pow(b1, t)
    c2 = 1 - torch.pow(b2, t)

    def upd(g, m, v, p):
        g = g.to(F32)
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        mhat = m2 / c1
        vhat = v2 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m2, v2

    flat_p = tree_leaves(params)
    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(opt_state["mu"]),
        tree_leaves(opt_state["nu"]), flat_p)]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"mu": new_m, "nu": new_v, "step": step}, {"grad_norm": gn, "lr": lr}


def _slices(*xs):
    """Matching slices of the same-shaped tensors ``xs``: runs of
    ``ADAMW_SLICE`` elements of their flat views where all are contiguous,
    else (and on ``meta``, which holds no memory) the whole tensors.
    Elementwise ops give each element the same bits whatever the
    slicing."""
    if xs[0].device.type == "meta" or not all(x.is_contiguous() for x in xs):
        yield xs
        return
    flat = [x.view(-1) for x in xs]
    for i in range(0, flat[0].numel(), ADAMW_SLICE):
        yield [f[i:i + ADAMW_SLICE] for f in flat]


def _scale_(leaves: list, scale: torch.Tensor) -> list:
    """``x * scale`` of each leaf, written into the leaf where it is
    contiguous and its storage is its own, else a new tensor (autograd may
    hand two inputs one gradient tensor, or views of one)."""
    owners = collections.Counter(x.untyped_storage().data_ptr()
                                 for x in leaves)
    return [x.mul_(scale.to(x.dtype))
            if x.is_contiguous() and owners[x.untyped_storage().data_ptr()] == 1
            else x * scale.to(x.dtype) for x in leaves]


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, grads, opt_state, params):
    """``adamw_update`` in place: the new parameters, ``mu``, ``nu`` and
    ``step`` are written into the tensors given, and the same trees are
    returned with the same stats.  Every value equals ``adamw_update``'s
    bit for bit: the same elementwise ops in the same order, each product
    rounded apart as there (no fused multiply-add forms), over slices of
    ``ADAMW_SLICE`` elements.  Clipping scales ``grads``, the step's own
    intermediates, in place."""
    step = opt_state["step"].add_(1)
    lr = schedule_value(cfg, step)
    gn, g_leaves = global_norm(grads), tree_leaves(grads)
    if cfg.clip_norm is not None:
        g_leaves = _scale_(g_leaves, _clip_scale(gn, cfg.clip_norm))
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(F32)
    c1 = 1 - torch.pow(b1, t)
    c2 = 1 - torch.pow(b2, t)
    for g_all, m_all, v_all, p_all in zip(
            g_leaves, tree_leaves(opt_state["mu"]),
            tree_leaves(opt_state["nu"]), tree_leaves(params)):
        for g, m, v, p in _slices(g_all, m_all, v_all, p_all):
            g = g.to(F32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = m / c1
            delta.div_((v / c2).sqrt_().add_(cfg.eps))
            delta.add_(cfg.weight_decay * p.to(F32))
            delta.mul_(lr)
            if p.dtype == F32:
                p.sub_(delta)
            else:
                p.copy_((p.to(F32) - delta).to(p.dtype))
    return params, opt_state, {"grad_norm": gn, "lr": lr}


@torch.no_grad()
def sgd_update(lr: float, grads, params):
    return tree_map(lambda p, g: (p.to(F32) - lr * g.to(F32)).to(p.dtype),
                    params, grads)


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` by
    ``torch.autograd.grad``; a leaf the loss does not use gets zeros, as
    under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    compression=None, *, donate: bool = False) -> Callable:
    """Generic train step: value_and_grad -> (optional grad compression) ->
    AdamW.  ``compression`` maps the gradient tree to the tree the update
    sees (see training/compression.py).  With ``donate`` the step updates
    its parameters and optimizer state in place (``adamw_update_``) and
    returns them, as a step jitted with ``donate_argnums=(0, 1)`` reuses
    their buffers; else it returns new tensors (``adamw_update``).  The
    step keeps its arguments as attributes (``loss_fn``, ``opt_cfg``,
    ``compression``, ``donate``), so the other kind can be built from it."""

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        if compression is not None:
            grads = compression(grads)
        update = adamw_update_ if donate else adamw_update
        params, opt_state, stats = update(opt_cfg, grads, opt_state, params)
        stats["loss"] = loss
        return params, opt_state, stats

    train_step.loss_fn, train_step.opt_cfg = loss_fn, opt_cfg
    train_step.compression, train_step.donate = compression, donate
    return train_step
