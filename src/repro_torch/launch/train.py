"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(port of ``repro/launch/train.py``).

Trains any of the three families on ``--device`` (the card by default):
the reduced (smoke) config by default, the assigned config with
``--full``, through ``training/loop.py``'s fault-tolerant loop:
checkpoint/restart, straggler flags, preemption-safe.  The LM family reads
``TokenStream`` batches of ``--batch`` x ``--seq`` tokens and trains
``transformer.loss_fn`` with ``xent_chunk = min(512, seq)``; the recsys
family reads ``ClickStream`` batches of ``--batch`` rows; the GNN family
reads a 256-node power-law graph whose batch is rebuilt each step, as the
reference does.  Parameters come from a ``torch.Generator`` seeded with
``--seed`` on the device.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, NamedTuple

import torch

from ..configs import get_config
from ..data import sampler, synthetic
from ..models import gnn, recsys, transformer
from ..training import loop as loop_lib
from ..training.optimizer import AdamWConfig


def _lm_setup(model_cfg, batch, seq, seed, device):
    stream = synthetic.TokenStream(model_cfg.vocab, batch, seq, seed=seed)
    loss = lambda p, b: transformer.loss_fn(model_cfg, p, b,
                                            xent_chunk=min(512, seq))
    init = lambda: transformer.init_params(
        model_cfg, torch.Generator(device).manual_seed(seed))
    return stream, loss, init


class _GraphStream:
    """Re-samples a fanout minibatch each step (gnn family)."""

    def __init__(self, model_cfg, seed=0, step=0, n=256, deg=4):
        edges = synthetic.powerlaw_graph(n, deg, seed=seed)
        self.csr = sampler.CSRGraph(n, edges)
        self.edges, self.n = edges, n
        self.model = model_cfg
        self.seed, self.step = seed, step

    def next(self):
        need_pos = self.model.model in ("meshgraphnet", "dimenet")
        batch = sampler.make_gnn_batch(
            self.edges, self.n, d_feat=16, n_classes=self.model.n_classes,
            with_pos=need_pos, with_triplets=self.model.model == "dimenet",
            seed=(self.seed + self.step) % (2**31))
        self.step += 1
        return batch

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}


class Setup(NamedTuple):
    """What the launcher hands ``loop.run`` for one arch."""
    loop: loop_lib.LoopConfig
    opt: AdamWConfig
    loss: Callable
    init: Callable
    stream: object          # next() / state_dict(), as loop.run reads it


def setup(arch_id: str, *, steps: int, ckpt: str, lr: float = 3e-4,
          full: bool = False, seed: int = 0, batch: int = 8, seq: int = 128,
          device="cuda") -> Setup:
    """The loop config, AdamW settings, loss, initialiser and batch stream
    that ``main`` trains ``arch_id`` with (the smoke config unless
    ``full``); ``batch`` and ``seq`` size the LM and recsys batches."""
    arch = get_config(arch_id)
    model_cfg = arch.model if full else arch.smoke
    opt = AdamWConfig(lr=lr, total_steps=steps,
                      warmup_steps=max(1, steps // 10))
    lc = loop_lib.LoopConfig(total_steps=steps, ckpt_path=ckpt)
    gen = lambda: torch.Generator(device).manual_seed(seed)
    if arch.family == "lm":
        stream, loss, init = _lm_setup(model_cfg, batch, seq, seed, device)
    elif arch.family == "gnn":
        stream = _GraphStream(model_cfg, seed=seed)
        loss = lambda p, b: gnn.loss_fn(model_cfg, p, b)
        init = lambda: gnn.init_params(model_cfg, gen(), 16)
    else:
        stream = synthetic.ClickStream(model_cfg, batch, seed=seed)
        loss = lambda p, b: recsys.loss_fn(model_cfg, p, b)
        init = lambda: recsys.init_params(model_cfg, gen())
    return Setup(lc, opt, loss, init, stream)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt", "train.npz"))
    ap.add_argument("--full", action="store_true",
                    help="use the assigned production config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    s = setup(args.arch, steps=args.steps, ckpt=args.ckpt, lr=args.lr,
              full=args.full, seed=args.seed, batch=args.batch,
              seq=args.seq, device=args.device)
    out = loop_lib.run(s.loop, s.opt, s.loss, s.init, s.stream,
                       device=args.device)
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"{args.arch}: step0 loss={losses[0]:.4f} "
              f"final loss={losses[-1]:.4f} ({len(losses)} steps) on "
              f"{args.device}")
    return out


if __name__ == "__main__":
    main()
