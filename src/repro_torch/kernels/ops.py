"""Public wrappers around the port's kernels (the truss half of ``repro``'s
``kernels/ops.py``).

Each wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the hand-written kernel (``peel_wave``, ``bitmap_support``),
which raises if it cannot run; a CPU tensor takes the plain version in
``ref``.  There is no fallback from one to the other.  ``use_kernels(False)``
is the explicit A/B switch that sends every device to the plain version.
"""
from __future__ import annotations

import torch

from . import ref
from .bitmap_support import bitmap_support_cuda
from .peel_wave import peel_wave_cuda

_USE_KERNELS = True


def use_kernels(flag: bool) -> None:
    """Route CUDA tensors to the kernels (True, the default) or to the plain
    versions (False) — for A/B timing of the same call."""
    global _USE_KERNELS
    _USE_KERNELS = bool(flag)


def _on_card(*tensors: torch.Tensor) -> bool:
    """True when the call launches a kernel: every tensor on one CUDA device
    and kernels enabled.  CPU tensors take the plain version; any other
    device raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "cuda":
        return _USE_KERNELS
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {dev}")


def _slab(row_offset, row_count, *arrays):
    """Row-block slab selection shared by every bitmap-row entry point:
    rows ``[row_offset, row_offset + row_count)``, the start clamped into
    range as ``lax.dynamic_slice_in_dim`` clamps it.  Views, no copies."""
    if row_count is None:
        return arrays
    start = min(max(int(row_offset), 0), arrays[0].shape[0] - row_count)
    return tuple(a[start:start + row_count] for a in arrays)


def _word_start(word_offset, word_count, width: int) -> int:
    """Clamped start of a word slab (the word-axis twin of ``_slab``)."""
    return min(max(int(word_offset), 0), width - word_count)


def bitmap_support(rows_a, rows_b, row_offset=0, row_count=None,
                   word_offset=0, word_count=None):
    """``sup[i] = popcount(rows_a[i] & rows_b[i]).sum()`` for int32 rows
    ``[E, W]`` (K2's rows entry), over a row block and/or a word slab."""
    rows_a, rows_b = _slab(row_offset, row_count, rows_a, rows_b)
    wo = 0 if word_count is None else _word_start(word_offset, word_count,
                                                  rows_a.shape[1])
    if _on_card(rows_a, rows_b):
        return bitmap_support_cuda(rows_a, rows_b, word_offset=wo,
                                   word_count=word_count)
    if word_count is not None:
        rows_a = rows_a[:, wo:wo + word_count]
        rows_b = rows_b[:, wo:wo + word_count]
    return ref.bitmap_support_ref(rows_a, rows_b)


def bitmap_support_gathered(bitmap, eu, ev, chunk=None, word_offset=0,
                            word_count=None):
    """Support counts straight from an int32 ``[N, W]`` bitmap and endpoint
    ids (K2's gathered entry): no ``[E, W]`` row gather exists on the card.
    ``chunk`` bounds the plain version's gather transient to ``[chunk, W]``;
    the kernel needs no chunking.  A word slab gives a partial sum."""
    wo = 0 if word_count is None else _word_start(word_offset, word_count,
                                                  bitmap.shape[1])
    if _on_card(bitmap, eu, ev):
        return bitmap_support_cuda(bitmap, bitmap, eu, ev, word_offset=wo,
                                   word_count=word_count)
    if word_count is not None:
        bitmap = bitmap[:, wo:wo + word_count]
    return ref.bitmap_support_gathered_ref(bitmap, eu, ev, chunk)


def peel_wave(rows_a, rows_b, alive, k, row_offset=0, row_count=None):
    """Fused (support, kill-frontier) of the level-``k`` wave over int32
    rows ``[E, W]`` (K1's rows entry).  Returns ``(sup int32, kill bool)``."""
    rows_a, rows_b, alive = _slab(row_offset, row_count, rows_a, rows_b, alive)
    if _on_card(rows_a, rows_b, alive):
        return peel_wave_cuda(rows_a, rows_b, alive, k)
    return ref.peel_wave_ref(rows_a, rows_b, alive, k)


def peel_wave_gathered(bitmap, eu, ev, alive, k, chunk=None):
    """K1's gathered entry — the one the bitmap peel engine calls each wave:
    ``peel_wave(bitmap[eu], bitmap[ev], alive, k)`` without building the
    row gathers on the card.  ``chunk`` bounds the plain version's gather."""
    if _on_card(bitmap, eu, ev, alive):
        return peel_wave_cuda(bitmap, bitmap, alive, k, eu, ev)
    return ref.peel_wave_gathered_ref(bitmap, eu, ev, alive, k, chunk)
