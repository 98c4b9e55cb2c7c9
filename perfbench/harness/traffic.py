"""The one generator of traffic: it reads a mix's parameters (a
``traffic/<mix>.json``) and the run's seed, and gives the requests.

Two kinds of mix (``kinds/<kind>.py`` drives each):

- ``lm_prefill``: one client in a closed loop sends prompt batches to the
  prefill entry.  ``shapes`` lists ``[rows, length, count]``: each block
  of ``sum(count)`` calls holds ``count`` calls of each shape, in an order
  drawn from the seed, so every seed does the same work a block.  Prompt
  ids come from a pool of ``pool_calls`` calls drawn on the device.
- ``lm_decode``: ``batch`` sessions (``"fit"``: the largest batch whose
  cache fits the mix's ``fit`` rule, from the configuration's sizes) whose
  caches hold ``start`` positions drawn from the seed at set-up; each wave
  decodes one token for every session, greedily.
"""
from __future__ import annotations

import numpy as np
import torch

from . import counts
from .model import sub_seed


def schedule(mix: dict, seed: int, n_calls: int) -> list:
    """The ``(rows, length)`` of the first ``n_calls`` prefill calls."""
    block = [(r, s) for r, s, c in mix["shapes"] for _ in range(c)]
    rng = np.random.default_rng(sub_seed(seed, "schedule"))
    out = []
    while len(out) < n_calls:
        out += [block[i] for i in rng.permutation(len(block))]
    return out[:n_calls]


def prompt_pool(mix: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """``[pool_calls, tokens_per_call]`` prompt ids; call ``i`` reads row
    ``i % pool_calls`` as its ``[rows, length]``."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "prompts"))
    return torch.randint(0, vocab, (mix["pool_calls"], mix["tokens_per_call"]),
                         generator=gen, device=device)


def call_tokens(pool: torch.Tensor, i: int, shape: tuple) -> torch.Tensor:
    rows, length = shape
    return pool[i % pool.shape[0], :rows * length].view(rows, length)


def decode_batch(mix: dict, m: dict) -> int:
    if mix["batch"] == "fit":
        return counts.decode_batch(m, mix["fit"], mix["seq"])
    return int(mix["batch"])


def cache_slots(mix: dict, m: dict) -> int:
    return min(mix["seq"], m["window"]) if m.get("window") else mix["seq"]


def fill_layer(shape: tuple, seed: int, which: str, layer: int, start: int,
               device) -> torch.Tensor:
    """One layer's cache ``[B, C, Hkv, Dh]`` in bf16 as set-up fills it:
    normal values from the seed, and zeros in the slots past ``start``
    (unwritten positions; a ring whose window ``start`` has passed is full).
    The reference calls it again to read the same values."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "cache", which, layer))
    t = torch.empty(shape, dtype=torch.bfloat16, device=device)
    t.normal_(generator=gen)
    if start < shape[1]:
        t[:, start:] = 0
    return t


def fill_cache(cache: dict, seed: int, start: int) -> None:
    """Every layer of ``cache`` (``k``, ``v``: ``[L, B, C, Hkv, Dh]``)
    filled in place by ``fill_layer``."""
    for which in ("k", "v"):
        for i, layer in enumerate(cache[which]):
            layer.copy_(fill_layer(tuple(layer.shape), seed, which, i, start,
                                   layer.device))


def prefix_positions(start: int, slots: int) -> tuple:
    """The absolute positions the filled cache holds before ``start``, and
    the slot of each (``p % slots`` in a ring)."""
    lo = max(0, start - slots)
    pos = np.arange(lo, start)
    return pos, pos % slots


def first_tokens(vocab: int, batch: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "first"))
    return torch.randint(0, vocab, (batch,), generator=gen, device=device)
