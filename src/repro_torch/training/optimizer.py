"""Optimizers from scratch (PyTorch port of ``repro/training/optimizer.py``):
AdamW + SGD, global-norm clipping, warmup-cosine / linear schedules.

Parameters, gradients and optimizer states are trees of tensors (dicts and
lists), as the reference's pytrees are; a tree's leaves are visited with
dict keys in sorted order, as ``jax.tree`` visits them, so sums over leaves
add in the reference's order.  The AdamW state keeps the reference's keys
(``mu``, ``nu``, an int32 0-d ``step``), so optimizer checkpoints cross
packages.  Updates return new tensors and never write into their inputs.
``make_train_step`` takes the gradient with ``torch.autograd.grad``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

F32 = torch.float32


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


def clip_by_global_norm(tree, max_norm: float):
    gn = global_norm(tree)
    scale = torch.minimum(torch.ones_like(gn),
                          max_norm / torch.maximum(gn, torch.full_like(gn, 1e-12)))
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
                    compression=None) -> Callable:
    """Generic train step: value_and_grad -> (optional grad compression) ->
    AdamW.  ``compression`` maps the gradient tree to the tree the update
    sees (see training/compression.py)."""

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        if compression is not None:
            grads = compression(grads)
        params, opt_state, stats = adamw_update(opt_cfg, grads, opt_state, params)
        stats["loss"] = loss
        return params, opt_state, stats

    return train_step
