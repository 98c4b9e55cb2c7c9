"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``
(port of ``repro/launch/serve.py``).

Runs the arch's smoke config on ``--device`` (the card by default), as the
reference does: LM archs run the batched decode engine; recsys runs batched
scoring of ``--requests`` rows of a ``ClickStream`` batch.  The GNN family
has no serving path (the reference reaches it only through training) and
exits with a message, as does an arch the port does not know.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import REGISTRY, get_config
from ..data import synthetic
from ..models import recsys, transformer
from ..serving import DecodeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch not in REGISTRY:
        raise SystemExit(f"{args.arch}: not ported yet (the port serves "
                         f"{sorted(REGISTRY)})")
    arch = get_config(args.arch)
    cfg = arch.smoke
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(args.device).manual_seed(args.seed)

    if arch.family == "lm":
        params = transformer.init_params(cfg, gen)
        eng = DecodeEngine(cfg, params, batch_slots=args.slots, max_seq=128,
                           device=args.device)
        for r in range(args.requests):
            prompt = rng.integers(1, cfg.vocab, size=rng.integers(2, 8)).tolist()
            eng.submit(Request(rid=r, prompt=prompt, max_new=args.max_new))
        t0 = time.perf_counter()
        done = eng.run()
        dt = time.perf_counter() - t0
        toks = sum(len(r.out) for r in done)
        print(f"{args.arch}: served {len(done)} requests, {toks} tokens "
              f"in {dt:.2f}s ({toks / max(dt, 1e-9):.1f} tok/s) on "
              f"{args.device}")
        return done

    if arch.family == "recsys":
        params = recsys.init_params(cfg, gen)
        stream = synthetic.ClickStream(cfg, args.requests, seed=args.seed)
        batch = recsys.batch_to_torch(stream.next(), args.device)
        scores = recsys.serve(cfg, params, batch)
        print(f"{args.arch}: scored {args.requests} requests, "
              f"mean ctr={float(scores.mean()):.4f} on {args.device}")
        return scores

    raise SystemExit(f"{args.arch}: family {arch.family} has no serving path")


if __name__ == "__main__":
    main()
