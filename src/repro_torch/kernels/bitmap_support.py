"""Hopper kernel K2: edge support as AND + popcount of two bitmap rows.

Replaces ``repro/kernels/bitmap_support.py::bitmap_support_kernel`` (the
Pallas kernel over pre-gathered uint32 rows).  The CUDA body is
``csrc/bitmap_popcount.cu`` (``and_popcount_rows<false>``); its note says
what bounds it on an H100 (device-memory bytes) and what the design does
about it.  The same launcher serves the rows entry (``rows_a``/``rows_b``
``[E, W]``, as the reference takes them) and the gathered entry (rows read
straight from the ``[N, W]`` bitmap by endpoint ids), with an optional word
slab for partial sums.  Plain version: ``ref.bitmap_support_ref``.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of this kernel since import (reset by callers that count a run)
LAUNCHES = 0


def row_pair_args(a: torch.Tensor, b: torch.Tensor, ia, ib, word_offset: int,
                  word_count: int | None):
    """Validate one AND+popcount launch and return ``(a_ptr, b_ptr, stride,
    ia_ptr, ib_ptr, n_rows, n_words)`` for the C entry.

    ``a``/``b``: int32 ``[R, W]`` on the card, rows contiguous.  With
    ``ia``/``ib`` (int32 ``[E]``) row ``ia[i]`` of ``a`` pairs with row
    ``ib[i]`` of ``b``; without them row ``i`` pairs with row ``i``."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name}: need an int32 [R, W] CUDA tensor, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous")
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError(f"row widths/devices differ: {tuple(a.shape)} "
                         f"{a.device} vs {tuple(b.shape)} {b.device}")
    w = a.shape[1]
    wc = w - word_offset if word_count is None else word_count
    if word_offset < 0 or wc < 0 or word_offset + wc > w:
        raise ValueError(f"word slab [{word_offset}, {word_offset + wc}) "
                         f"outside [0, {w})")
    if ia is None:
        if a.shape != b.shape:
            raise ValueError(f"row shapes differ: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        n_rows, ia_ptr, ib_ptr = a.shape[0], None, None
    else:
        for name, t, rows in (("eu", ia, a.shape[0]), ("ev", ib, b.shape[0])):
            if (t.device != a.device or t.dtype != torch.int32
                    or t.dim() != 1 or not t.is_contiguous()):
                raise ValueError(f"{name}: need a contiguous int32 [E] tensor "
                                 f"on {a.device}")
            if t.numel() and (int(t.min()) < 0 or int(t.max()) >= rows):
                raise ValueError(f"{name}: row id outside [0, {rows})")
        if ia.shape != ib.shape:
            raise ValueError("eu and ev differ in length")
        n_rows, ia_ptr, ib_ptr = ia.shape[0], ia.data_ptr(), ib.data_ptr()
    off = word_offset * a.element_size()
    return (a.data_ptr() + off, b.data_ptr() + off, w, ia_ptr, ib_ptr,
            n_rows, wc)


def bitmap_support_cuda(a: torch.Tensor, b: torch.Tensor, ia=None, ib=None,
                        word_offset: int = 0,
                        word_count: int | None = None) -> torch.Tensor:
    """Launch K2: int32 ``sup[i] = Σ_w popcount(a[ra_i, w] & b[rb_i, w])``
    over words ``[word_offset, word_offset + word_count)``."""
    global LAUNCHES
    a_p, b_p, stride, ia_p, ib_p, n, nw = row_pair_args(
        a, b, ia, ib, word_offset, word_count)
    sup = torch.empty((n,), dtype=torch.int32, device=a.device)
    if n == 0:
        return sup
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = _build.library().bitmap_support_launch(
            a_p, b_p, stride, ia_p, ib_p, n, nw, sup.data_ptr(), stream)
    _build.check(status, "bitmap_support")
    LAUNCHES += 1
    return sup
