"""Hopper kernel K5: one xDeepFM CIN layer, fused.

Replaces ``repro/kernels/cin.py::cin_layer_kernel``.  The CUDA body is
``csrc/cin.cu``; its note says what bounds it on an H100 (operations) and
what the design does about it.  The layer is the dense product of the
``[B·D, H·M]`` outer product of ``xk`` and ``x0`` with ``w`` flattened to
``[O, H·M]``; the kernel builds each tile of the outer product in shared
memory, so it never reaches device memory, and writes
``relu(·)`` in the ``[B, O, D]`` layout.  fp32 on the CUDA cores, in the
reference's 2e-5 tolerance.  Plain version: ``ref.cin_layer_ref``.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of this kernel since import (reset by callers that count a run)
LAUNCHES = 0

_B_TILE, _O_TILE = 128, 64      # the kernel's block tile (cin.cu)
_MAX_GRID_Y = 65_535
_MAX_INT = 2**31 - 1


def cin_layer_cuda(xk: torch.Tensor, x0: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Launch K5: ``relu(einsum('bhd,bmd,ohm->bod', xk, x0, w))`` for
    float32 xk ``[B, H, D]``, x0 ``[B, M, D]``, w ``[O, H, M]`` on the
    card.  Raises on what the kernel does not take; never falls back to the
    plain version."""
    global LAUNCHES
    for name, t in (("xk", xk), ("x0", x0), ("w", w)):
        if (t.device.type != "cuda" or t.dim() != 3
                or t.dtype != torch.float32):
            raise ValueError(f"{name}: need a float32 3-d CUDA tensor, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor")
        if t.device != xk.device:
            raise ValueError(f"{name} on {t.device}, xk on {xk.device}")
    b, h, d = xk.shape
    m = x0.shape[1]
    o = w.shape[0]
    if x0.shape[0] != b or x0.shape[2] != d or tuple(w.shape[1:]) != (h, m):
        raise ValueError(f"shapes do not contract: xk {tuple(xk.shape)}, x0 "
                         f"{tuple(x0.shape)}, w {tuple(w.shape)}")
    if (-(-o // _O_TILE) > _MAX_GRID_Y or -(-(b * d) // _B_TILE) > _MAX_INT
            or h * m > _MAX_INT):
        raise ValueError(f"shapes outside the kernel's grid: xk "
                         f"{tuple(xk.shape)}, w {tuple(w.shape)}")
    out = torch.empty((b, o, d), dtype=torch.float32, device=xk.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream(xk.device).cuda_stream
        status = _build.library("cin").cin_layer_launch(
            xk.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, h, m, d, o, stream)
    _build.check(status, "cin_layer")
    LAUNCHES += 1
    return out
