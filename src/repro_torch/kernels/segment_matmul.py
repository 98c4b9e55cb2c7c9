"""Hopper kernel K4: segment sum (the embedding-bag reduction).

Replaces ``repro/kernels/segment_matmul.py::segment_matmul_kernel`` (the
Pallas kernel that sums segments as one-hot matmuls on the MXU).  The CUDA
body is ``csrc/segment_sum.cu``; its note says what bounds it on an H100
(device-memory bytes) and what the design does about it.  The wrapper
stable-sorts the ids (``torch.sort``, index preparation, no host sync);
the kernel finds each segment's run of the sorted order and sums its rows
in ascending index order in fp32, so the result is deterministic.  One
launcher serves the rows entry (``messages [E, D]``, as the reference takes
them) and the gathered entry (``table[indices[i]]`` read in place, so the
``[E, D]`` gather never exists on the card).  Plain versions:
``ref.segment_matmul_ref`` and ``ref.segment_matmul_gathered_ref``.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of this kernel since import (reset by callers that count a run)
LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.float16: 1}
_MAX_ROWS = 2**31 - 1


def segment_sum_cuda(src: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int,
                     indices: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K4: ``out[s] = Σ_{i: seg_ids[i] = s} row_i`` with ``row_i =
    src[i]`` (rows entry) or ``src[indices[i]]`` (gathered entry), ``[N,
    D]`` in ``src.dtype``.  Raises on what the kernel does not take; never
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
    if n < 0 or n >= _MAX_ROWS or e >= _MAX_ROWS:
        raise ValueError(f"num_segments {n} or {e} ids outside the kernel's "
                         f"int32 range")
    out = torch.empty((n, src.shape[1]), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    sorted_ids, order = torch.sort(seg_ids, stable=True)
    starts = torch.empty((n + 1,), dtype=torch.int32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        status = _build.library("segment_sum").segment_sum_launch(
            src.data_ptr(), src.shape[0],
            None if indices is None else indices.data_ptr(),
            sorted_ids.data_ptr(), order.data_ptr(), e, n, src.shape[1],
            DTYPES[src.dtype], starts.data_ptr(), out.data_ptr(), stream)
    _build.check(status, "segment_matmul")
    LAUNCHES += 1
    return out
