"""Hopper kernel K4: segment sum (the embedding-bag reduction).

Replaces ``repro/kernels/segment_matmul.py::segment_matmul_kernel`` (the
Pallas kernel that sums segments as one-hot matmuls on the MXU).  The CUDA
body is ``csrc/segment_sum.cu``; its note says what bounds it on an H100
(device-memory bytes, two 32-byte sectors per gathered 40-byte row) and
what the design does about it.  A boundary pass finds each segment's run of
ids in ascending order and flags a descending pair; the sum kernel gives a
thread one load unit of one segment's rows, issues a chunk of independent
row loads before it adds any, and sums each run in ascending index order
in fp32, so the result is deterministic.

Ids come in ascending order either because the caller declares them sorted
(``ids_sorted=True``: no sort, no ``order`` array; a false declaration
makes the whole output NaN, with no host sync) or because the wrapper
stable-sorts them (``torch.sort``, the default).  The choice is the
caller's, never a fallback.  ``mean=True`` divides each segment's fp32 sum
by ``max(count, 1)`` in the same launch.  One launcher serves the rows
entry (``messages [E, D]``, as the reference takes them) and the gathered
entry (``table[indices[i]]`` read in place, so the ``[E, D]`` gather never
exists on the card).  Plain versions: ``ref.segment_matmul_ref``,
``ref.segment_matmul_gathered_ref`` and ``ref.segment_mean_gathered_ref``.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of this kernel since import (reset by callers that count a run)
LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.float16: 1}
_MAX_ROWS = 2**31 - 1


def load_unit(d: int, itemsize: int, *ptrs: int) -> int:
    """Bytes of one load of the sum kernel: the widest of 16, 8, 4 and 2
    that a row of ``d`` values and every pointer in ``ptrs`` are aligned
    to (8 at xDeepFM's 40-byte fp32 rows; never less than one value)."""
    return next(u for u in (16, 8, 4, 2) if u >= itemsize and
                (d * itemsize) % u == 0 and all(p % u == 0 for p in ptrs))


def segment_sum_cuda(src: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int,
                     indices: torch.Tensor | None = None, *,
                     ids_sorted: bool = False,
                     mean: bool = False) -> torch.Tensor:
    """Launch K4: ``out[s] = Σ_{i: seg_ids[i] = s} row_i`` with ``row_i =
    src[i]`` (rows entry) or ``src[indices[i]]`` (gathered entry), ``[N,
    D]`` in ``src.dtype``; with ``mean``, divided by ``max(count, 1)``.
    ``ids_sorted`` declares ``seg_ids`` ascending: no sort; if they are not,
    every output is NaN.  Raises on what the kernel does not take; never
    falls back to the plain version."""
    global LAUNCHES
    if src.device.type != "cuda" or src.dim() != 2 or src.dtype not in DTYPES:
        raise ValueError(f"src: need a float32 or float16 [R, D] CUDA "
                         f"tensor, got {src.dtype} {tuple(src.shape)} on "
                         f"{src.device}")
    if not src.is_contiguous():
        raise ValueError("src: rows must be contiguous")
    ids = (("seg_ids", seg_ids),) + (() if indices is None
                                     else (("indices", indices),))
    for name, t in ids:
        if (t.device != src.device or t.dtype != torch.int32 or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous int32 [E] tensor on "
                             f"{src.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    e = seg_ids.shape[0]
    if indices is None and e != src.shape[0]:
        raise ValueError(f"{e} segment ids for {src.shape[0]} rows")
    if indices is not None and indices.shape[0] != e:
        raise ValueError(f"{indices.shape[0]} indices for {e} segment ids")
    n = int(num_segments)
    if n < 0 or max(n, e, src.shape[0]) >= _MAX_ROWS:
        raise ValueError(f"num_segments {n}, {e} ids or {src.shape[0]} rows "
                         f"outside the kernel's int32 range")
    out = torch.empty((n, src.shape[1]), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    if ids_sorted:
        sorted_ids, order = seg_ids, None
    else:
        sorted_ids, order = torch.sort(seg_ids, stable=True)
    scratch = torch.empty((n + 2,), dtype=torch.int32, device=src.device)
    unit = load_unit(src.shape[1], src.element_size(), src.data_ptr(),
                     out.data_ptr())
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        status = _build.library("segment_sum").segment_sum_launch(
            src.data_ptr(), src.shape[0],
            None if indices is None else indices.data_ptr(),
            sorted_ids.data_ptr(), None if order is None else order.data_ptr(),
            e, n, src.shape[1], DTYPES[src.dtype], unit, int(mean),
            scratch.data_ptr(), out.data_ptr(), stream)
    _build.check(status, "segment_matmul")
    LAUNCHES += 1
    return out
