"""Fault-tolerant training loop (PyTorch port of ``repro/training/loop.py``):
checkpoint/restart, straggler monitoring, placement onto a new device or
mesh, preemption handling.

* every state element (params, optimizer, data-stream cursor) is part of
  the checkpoint => bitwise-resumable;
* checkpoints are device-agnostic (training/checkpoint.py) and hold the
  reference's layout, so a run of either package resumes in the other;
* a per-step wall-time EWMA flags stragglers;
* SIGTERM triggers checkpoint-and-exit (preemption/maintenance events).

``run`` takes ``device=`` where the reference takes ``jit_kwargs``: each
batch goes to the device with ``torch.as_tensor``, and a restored state
is placed there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..core.distributed import ShardMesh
from . import checkpoint as ckpt_lib
from .optimizer import AdamWConfig, adamw_init, make_train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_path: str
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0   # step slower than factor x EWMA => flagged
    ewma_alpha: float = 0.1


class StragglerMonitor:
    def __init__(self, factor: float, alpha: float):
        self.factor, self.alpha = factor, alpha
        self.ewma: float | None = None
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.factor * self.ewma
        if slow:
            self.flagged.append((step, dt))
        # only fold non-outlier steps into the baseline
        if not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def run(loop_cfg: LoopConfig, opt_cfg: AdamWConfig, loss_fn: Callable,
        init_params_fn: Callable, stream, *, device="cuda",
        resume: bool = True, preemption=None, async_ckpt: bool = True,
        hooks: list[Callable] | None = None) -> dict[str, Any]:
    """Generic training loop.  ``stream`` must expose next()/state_dict().  Returns
    the final state bundle (also what lands in the checkpoint)."""
    device = torch.device(device)
    train_step = make_train_step(loss_fn, opt_cfg)
    preemption = preemption or ckpt_lib.PreemptionHandler()
    writer = ckpt_lib.AsyncCheckpointer() if async_ckpt else None

    start_step = 0
    restored = None
    if resume:
        prev = ckpt_lib.latest_step(loop_cfg.ckpt_path)
        if prev is not None:
            restored = ckpt_lib.restore(loop_cfg.ckpt_path)
            start_step = prev

    if restored is not None:
        params = ckpt_lib.to_device(restored["params"], device)
        opt_state = ckpt_lib.to_device(restored["opt_state"], device)
        if hasattr(stream, "load_state_dict"):
            # GraphUpdateStream & co.: restores the evolving present-edge
            # set too, not just (seed, step) — resume is exact
            stream.load_state_dict(restored["stream"])
        elif hasattr(stream, "seed"):
            stream.seed = int(restored["stream"]["seed"])
            stream.step = int(restored["stream"]["step"])
    else:
        params = init_params_fn()
        opt_state = adamw_init(params)

    monitor = StragglerMonitor(loop_cfg.straggler_factor, loop_cfg.ewma_alpha)
    history = []

    def do_ckpt(step):
        bundle = {"params": params, "opt_state": opt_state,
                  "stream": stream.state_dict()}
        if writer:
            writer.save(loop_cfg.ckpt_path, bundle, step)
        else:
            ckpt_lib.save(loop_cfg.ckpt_path, bundle, step)

    step = start_step
    for step in range(start_step, loop_cfg.total_steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in stream.next().items()}
        t0 = time.perf_counter()
        params, opt_state, stats = train_step(params, opt_state, batch)
        stats = {k: float(v) for k, v in stats.items()}
        dt = time.perf_counter() - t0
        slow = monitor.observe(step, dt)
        history.append({"step": step, "dt": dt, "straggler": slow, **stats})
        for h in (hooks or []):
            h(step, stats)
        if (step + 1) % loop_cfg.ckpt_every == 0:
            do_ckpt(step + 1)
        if preemption.preempted:
            do_ckpt(step + 1)
            break

    do_ckpt(min(step + 1, loop_cfg.total_steps))
    if writer:
        writer.wait()
        writer.close()
    return {"params": params, "opt_state": opt_state, "history": history,
            "stragglers": monitor.flagged}


def reshard_for_mesh(tree, target):
    """Elastic re-scaling: place a (restored, host-resident) state bundle
    onto ``target``.  A device (or its name) gives the tree on it; a
    ``ShardMesh`` gives one replica a shard along its first axis, on that
    shard's device (shards on one device share one copy)."""
    if isinstance(target, ShardMesh):
        devices = target.shard_devices(target.axis_names[0])
        copies = {d: ckpt_lib.to_device(tree, d) for d in dict.fromkeys(devices)}
        return [copies[d] for d in devices]
    return ckpt_lib.to_device(tree, torch.device(target))
