"""The measured window: a closed loop over a cell's requests, one host read
of each answer, timed on the host's clock.

A kind of cell (``kinds/<kind>.py``) gives the step that sends request
``i`` and reads its answer; ``timed`` runs steps until ``seconds`` have
passed (or ``count`` steps are done) and records each as an ``Item``.
"""
from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class Item:
    """One request (a prefill call, a decode wave): its shape, its
    host-clock start and end, the position it wrote (decode), and whether
    its answer came back whole (every logit finite)."""
    rows: int
    length: int
    t0: float
    t1: float
    pos: int = 0
    ok: bool = True

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Window:
    kind: str
    items: list
    seconds: float

    @property
    def attempted(self) -> int:
        """Rows sent (a decode wave sends one a session)."""
        return sum(it.rows for it in self.items)

    @property
    def failed(self) -> int:
        """Rows of requests whose answer did not come back whole."""
        return sum(it.rows for it in self.items if not it.ok)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(kind: str, step, seconds: float | None, count: int | None,
          device) -> Window:
    """Steps ``step(0), step(1), ..`` until ``seconds`` have passed, or
    ``count`` steps are done; ``step(i)`` sends request ``i``, reads its
    answer to the host and returns ``(rows, length, pos, ok)``."""
    items = []
    sync(device)
    start = prev = time.perf_counter()
    while True:
        rows, length, pos, ok = step(len(items))
        now = time.perf_counter()
        items.append(Item(rows, length, prev, now, pos, ok))
        prev = now
        if (count is not None and len(items) >= count) or \
                (count is None and now - start >= seconds):
            return Window(kind, items, now - start)


def answer(logits: torch.Tensor, top: torch.Tensor | None = None) -> tuple:
    """One host read of a step's answer: the argmax of each row of
    ``logits [rows, V]`` (the served tokens; ``top`` where the caller has
    it on the device already) and whether every logit is finite."""
    top = logits.argmax(-1) if top is None else top
    both = torch.cat([top, torch.isfinite(logits).all()[None].long()])
    host = both.cpu()
    return host[:-1], bool(host[-1])
