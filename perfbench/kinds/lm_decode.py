"""Kind ``lm_decode``: ``batch`` sessions decode greedily, one
``transformer.decode_step`` over all of them a wave, the argmax as each
session's next token and one host read a wave.

Set-up makes the weights on the device from the seed, the cache of every
session filled to position ``mix["start"]`` from the seed
(``traffic.fill_cache``), the first tokens, and warms up the wave
``mix["warmup"]`` times (each rewrites slot ``start`` alone).  A window
that would run past a cache that is no ring raises.

The check holds a sample of the sessions (as many from each half of the
batch) to the plain reference, which reads the cache the benchmark filled
and runs the tokens each session was fed: per compared position ``gap``
(the gap by which the served token's reference logit lies below the
reference's best) and ``logit_err`` (the largest gap between the wave's
logits and the reference's, over the reference's largest |logit|); per
session ``kv_med`` (over the layers' K and V, the largest median over
positions of the gap between what a step wrote into the cache and the
reference's, over the reference's largest |K| or |V| of that layer).
``control`` gives the readings of the reference in float8 put in the
program's place (for the token that model puts first), ``witness`` of the
reference in bf16.
"""
from __future__ import annotations

from time import perf_counter as now

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import check, drive, model, traffic

KIND = "lm_decode"


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, reference,
                 marks: dict):
        from repro_torch.models import transformer    # the system under test

        self.t, self.mix, self.seed = transformer, mix, seed
        self.m, self.device, self.reference = cfg["model"], device, reference
        self.port = model.port_config(cfg)
        self.params = model.make_params(cfg, seed, device)
        drive.sync(device)
        marks["weights"] = now()
        self.batch = traffic.decode_batch(mix, self.m)
        self.slots = traffic.cache_slots(mix, self.m)
        self.cache = self.t.init_cache(self.port, self.batch, mix["seq"], device=device)
        traffic.fill_cache(self.cache, seed, mix["start"])
        self.first = traffic.first_tokens(self.m["vocab"], self.batch, seed, device)
        self.sessions = check.sample_sessions(self.batch, mix["check_sessions"], seed)
        self.pos = torch.full((), mix["start"], dtype=torch.long, device=device)
        self.end = None if self.m.get("window") else self.slots
        drive.sync(device)
        marks["inputs"] = now()
        self.warm = []
        for _ in range(mix["warmup"]):
            t = now()
            drive.answer(self.t.decode_step(self.port, self.params, self.cache,
                                            self.first, self.pos)[0])
            self.warm.append(round(now() - t, 3))
        drive.sync(device)
        self.token, self.p, self.window = self.first, mix["start"], None
        self.served, self.kept = [], []

    def measure(self, seconds: float | None, count: int | None = None):
        """Waves from the next position on; of the first window, each
        wave's served tokens and the sampled sessions' logits are kept."""
        first_window = self.window is None
        sess = torch.as_tensor(self.sessions, device=self.device)

        def step(j):
            p = self.p
            if self.end is not None and p >= self.end:
                raise RuntimeError(f"the cache is full at position {p}: the "
                                   f"mix's window outran its cache")
            with record_function("perfbench.decode"):
                logits, _ = self.t.decode_step(self.port, self.params, self.cache,
                                               self.token, self.pos)
                self.token = logits.argmax(-1)
                self.pos += 1
            with record_function("perfbench.read"):
                served, ok = drive.answer(logits, self.token)
            if first_window:
                self.served.append(served)
                self.kept.append(logits.index_select(0, sess))
            self.p += 1
            return self.batch, 1, p, ok

        w = drive.timed(KIND, step, seconds, count, self.device)
        if first_window:
            self.window = w
        return w

    def check(self, traced_items: int):
        return Check(self, traced_items)


class Check:
    """The sampled sessions' fed and served tokens, logits and written
    slots, taken from the cell, so that the cell (and its cache) can be
    freed before the reference runs; ``later`` waves ran after the window,
    whose writes a ring may have put over the window's first slots."""

    def __init__(self, cell: Cell, later: int):
        m, mix = cell.m, cell.mix
        served = torch.stack(cell.served)                       # [n, B]
        n = served.shape[0]
        self.sessions, self.slots = cell.sessions, cell.slots
        self.start, self.seed = mix["start"], cell.seed
        self.kv_from = max(0, n + later - self.slots)
        pos = self.start + np.arange(n)
        dev = cell.device
        slot_idx = torch.as_tensor(pos % self.slots, device=dev)
        sess = torch.as_tensor(self.sessions, device=dev)
        self.kv = [tuple(cell.cache[w][:, s].index_select(1, slot_idx).clone()
                         for w in ("k", "v")) for s in sess]
        logits = torch.stack(cell.kept)                         # [n, k, V]
        self.got = [logits[:, i].float() for i in range(len(self.sessions))]
        fed = torch.cat([cell.first.cpu()[None], served[:-1]])  # [n, B]
        self.fed = [fed[:, s].to(dev) for s in self.sessions]
        self.served = [served[:, s] for s in self.sessions]
        self.layer_shape = (cell.batch, self.slots, m["n_kv"], m["head_dim"])
        self.m, self.params, self.ref = m, cell.params, cell.reference
        cell.kept, cell.served = [], []
        self.rows = None

    def _prefix(self, s: int):
        ppos, pslot = traffic.prefix_positions(self.start, self.slots)

        def read(layer: int):
            dev = self.fed[0].device
            k, v = (traffic.fill_layer(self.layer_shape, self.seed, w, layer,
                                       self.start, dev)[s, pslot]
                    for w in ("k", "v"))
            return k, v, torch.as_tensor(ppos, device=dev)
        return read

    def _run(self, precision: str) -> list:
        dec = self.ref.Decoder(self.m, self.params, precision=precision)
        with self.ref.fp32_exact():
            return [dec.forward_row(t, self.start, self._prefix(s), compare="all",
                                    per_token_capacity=True)
                    for s, t in zip(self.sessions, self.fed)]

    def reference(self) -> None:
        self.rows = self._run("fp32")

    def items(self, served=None, got=None, kv=None) -> dict:
        served = self.served if served is None else served
        got = self.got if got is None else got
        kv = self.kv if kv is None else kv
        out = {"gap": [], "logit_err": [], "kv_med": []}
        for row, toks, g, (pk, pv) in zip(self.rows, served, got, kv):
            toks = toks.to(row.logits.device).long()
            ref = row.logits
            out["gap"] += (ref.max(-1).values
                           - ref.gather(-1, toks[:, None])[:, 0]).tolist()
            out["logit_err"] += ((g.float() - ref).abs().amax(-1)
                                 / ref.abs().amax(-1)).tolist()
            med = 0.0
            for li, lk in enumerate(row.kv):
                for w, written in ((0, pk[li]), (1, pv[li])):
                    e = (written.float() - lk[w]).abs().amax((1, 2))
                    med = max(med, float(e[self.kv_from:].median() / lk[w].abs().max()))
            out["kv_med"].append(med)
        return out

    def _lower(self, precision: str) -> dict:
        rows = self._run(precision)
        served = [r.logits.argmax(-1).cpu() for r in rows]
        got = [r.logits for r in rows]
        kv = [tuple(torch.stack([lk[w] for lk in r.kv]) for w in (0, 1))
              for r in rows]
        return self.items(served, got, kv)

    def control(self) -> dict:
        return self._lower("fp8")

    def witness(self) -> dict:
        return self._lower("bf16")
