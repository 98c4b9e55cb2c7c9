"""Batched decode serving engine for the LM family (port of
``repro/serving/engine.py``).

Continuous batching over B slots with a ring-buffer KV cache (SWA archs
carry only ``window`` positions), greedy/temperature sampling, and per-slot
completion tracking.  Each wave is one ``transformer.decode_step`` over all
slots, which writes the cache in place, and one host read of the sampled
tokens.  Sampling at ``temperature > 0`` draws from a ``torch.Generator``:
its draws are not JAX's, so parity with the reference holds for greedy
decoding.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import LMConfig
from ..models import transformer


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeEngine:
    def __init__(self, cfg: LMConfig, params, batch_slots: int, max_seq: int,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.b = batch_slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.device = torch.device(device)
        self.cache = transformer.init_cache(cfg, batch_slots, max_seq,
                                            device=self.device)
        self.slots: list[Request | None] = [None] * batch_slots
        self.pos = 0
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        # sampling draws (temperature > 0); seed 0 unless the caller's own
        self._gen = generator
        if self._gen is None and temperature > 0:
            self._gen = torch.Generator(self.device).manual_seed(0)

    def submit(self, req: Request):
        self.queue.append(req)

    def _fill_slots(self):
        """Admit queued requests only at a generation boundary (all slots
        empty): every slot shares one position counter and one KV cache, so
        a request joining mid-stream would decode against another request's
        cache.  When the batch drains, rewind and start a fresh generation."""
        if any(r is not None for r in self.slots):
            return
        if not self.queue:
            return
        if self.pos:
            self.pos = 0
            for t in self.cache.values():
                t.zero_()
        for i in range(self.b):
            if self.queue:
                self.slots[i] = self.queue.pop(0)

    def _next_token_host(self, i: int) -> int:
        """Token each slot feeds next (prompt first, then its own samples)."""
        r = self.slots[i]
        if r is None:
            return 0
        consumed = self.pos
        if consumed < len(r.prompt):
            return r.prompt[consumed]
        return r.out[-1] if r.out else r.prompt[-1]

    def step(self) -> int:
        """One synchronous decode wave across all slots; returns #active."""
        self._fill_slots()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active or self.pos >= self.max_seq:
            return 0
        tokens = torch.tensor([self._next_token_host(i) for i in range(self.b)],
                              dtype=torch.int64, device=self.device)
        logits, self.cache = transformer.decode_step(
            self.cfg, self.params, self.cache, tokens, self.pos)
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            next_tok = torch.argmax(logits, dim=-1)
        next_tok = next_tok.tolist()
        self.pos += 1
        for i in active:
            r = self.slots[i]
            if self.pos < len(r.prompt):
                continue  # still prefilling this slot's prompt
            r.out.append(int(next_tok[i]))
            if len(r.out) >= r.max_new:
                r.done = True
                self.finished.append(r)
                self.slots[i] = None
        return len(active)

    def run(self, max_waves: int = 10_000):
        while (any(self.slots) or self.queue) and max_waves > 0:
            if self.step() == 0:
                break
            max_waves -= 1
        return self.finished
