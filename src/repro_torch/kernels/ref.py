"""Plain PyTorch versions of the kernels (the ground truth they are held to).

Bitmaps are int32 tensors carrying uint32 bits.  Popcount is SWAR on the
words widened to int64 (masks after every shift), so no step depends on
int32 overflow or on an arithmetic right shift.
"""
from __future__ import annotations

import torch


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words holding uint32 bits -> int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def bitmap_support_ref(rows_a: torch.Tensor, rows_b: torch.Tensor) -> torch.Tensor:
    """sup[i] = sum_w popcount(rows_a[i, w] & rows_b[i, w]) as int32 [E]."""
    return popcount32(rows_a & rows_b).sum(1).to(torch.int32)


def _wave(sup: torch.Tensor, alive: torch.Tensor, k):
    alive = alive.to(torch.bool)
    sup = torch.where(alive, sup, 0)
    k = torch.as_tensor(k, dtype=torch.int32, device=sup.device)
    return sup, alive & (sup < k - 2)


def peel_wave_ref(rows_a: torch.Tensor, rows_b: torch.Tensor,
                  alive: torch.Tensor, k):
    """(support, kill-frontier) of the level-k peel wave: support masked to
    0 outside ``alive``, ``kill = alive & (sup < k - 2)``."""
    return _wave(bitmap_support_ref(rows_a, rows_b), alive, k)


def bitmap_support_gathered_ref(bitmap: torch.Tensor, eu: torch.Tensor,
                                ev: torch.Tensor,
                                chunk: int | None = None) -> torch.Tensor:
    """``bitmap_support_ref(bitmap[eu], bitmap[ev])`` gathered in
    ``chunk``-row batches, so the transient is ``[chunk, W]``."""
    e = eu.shape[0]
    step = e if chunk is None or chunk >= e else chunk
    out = [bitmap_support_ref(bitmap[eu[i:i + step].long()],
                              bitmap[ev[i:i + step].long()])
           for i in range(0, e, max(step, 1))]
    return torch.cat(out) if out else eu.new_zeros((0,))


def peel_wave_gathered_ref(bitmap: torch.Tensor, eu: torch.Tensor,
                           ev: torch.Tensor, alive: torch.Tensor, k,
                           chunk: int | None = None):
    """``peel_wave_ref(bitmap[eu], bitmap[ev], alive, k)`` gathered in
    ``chunk``-row batches."""
    return _wave(bitmap_support_gathered_ref(bitmap, eu, ev, chunk), alive, k)
