"""Hopper kernel K1: the fused peel wave — support and kill frontier.

Replaces ``repro/kernels/peel_wave.py::peel_wave_kernel``: for each row
pair, ``sup = Σ_w popcount(a & b)`` masked to 0 outside ``alive`` and
``kill = alive & (sup < k - 2)``, with ``k`` a device scalar so one kernel
serves every peel level.  The CUDA body is ``csrc/bitmap_popcount.cu``
(``and_popcount_rows<true>``); its note says what bounds it on an H100
(device-memory bytes) and what the design does about it.  The peel engine
calls the gathered entry (rows read straight from the ``[N, W]`` bitmap by
endpoint ids), so the reference's per-wave ``[E, W]`` row gathers never
exist.  Plain version: ``ref.peel_wave_ref``.
"""
from __future__ import annotations

import torch

from . import _build
from .bitmap_support import row_pair_args

#: launches of this kernel since import (reset by callers that count a run)
LAUNCHES = 0


def peel_wave_cuda(a: torch.Tensor, b: torch.Tensor, alive: torch.Tensor, k,
                   ia=None, ib=None):
    """Launch K1 over row pairs (see ``bitmap_support.row_pair_args`` for
    the addressing).  Returns ``(sup int32[E], kill bool[E])``."""
    global LAUNCHES
    a_p, b_p, stride, ia_p, ib_p, n, nw = row_pair_args(a, b, ia, ib, 0, None)
    if (alive.device != a.device or alive.dtype not in (torch.bool, torch.uint8)
            or alive.shape != (n,) or not alive.is_contiguous()):
        raise ValueError(f"alive: need a contiguous bool [{n}] tensor on "
                         f"{a.device}, got {alive.dtype} {tuple(alive.shape)}")
    k = torch.as_tensor(k, dtype=torch.int32, device=a.device).reshape(())
    sup = torch.empty((n,), dtype=torch.int32, device=a.device)
    kill = torch.empty((n,), dtype=torch.bool, device=a.device)
    if n == 0:
        return sup, kill
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = _build.library().peel_wave_launch(
            a_p, b_p, stride, ia_p, ib_p, n, nw, alive.data_ptr(),
            k.data_ptr(), sup.data_ptr(), kill.data_ptr(), stream)
    _build.check(status, "peel_wave")
    LAUNCHES += 1
    return sup, kill
