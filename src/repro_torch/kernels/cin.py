"""Hopper kernel K5: one xDeepFM CIN layer, fused, as a tuned fp32 SIMT GEMM.

Replaces ``repro/kernels/cin.py::cin_layer_kernel``.  The CUDA body is
``csrc/cin.cu``.  The layer is the dense product of the ``[B·D, H·M]``
outer product P of ``xk`` and ``x0`` with ``w`` flattened to ``[O, H·M]``;
the kernel builds each tile of P in shared memory, so P never reaches
device memory, and writes ``relu(·)`` in the ``[B, O, D]`` layout.

What bounds it on an H100: operations (``2·B·D·O·H·M`` flops on a few
bytes a row), against the fp32 CUDA-core peak of 67 TFLOP/s.  The design,
point by point (the source's note has the details):

1. a wide register tile: 256 threads of 8 rows x 13 outputs (104
   accumulators, within the 255 registers a thread of 8 warps may hold),
   104 FMAs per 21 floats used per k, shared-memory reads free of bank
   conflicts (P by broadcast, W on consecutive outputs);
2. a block tile of 128 rows x 208 outputs (``ROW_TILE``, ``OUT_TILE``), so
   3.8% of the outputs computed at O = 200 are padding;
3. a two-stage pipeline with one barrier per 20-deep k tile: W by
   ``cp.async``, P loaded into registers before the FMAs and stored after
   them, the ``(h, m)`` of each k column computed once per tile;
4. a whole-wave plan (``plan``): where the row tiles fill less than a wave
   of SMs, the grid splits k into S slices over whole ranges of h
   (``h_ranges``), each writing partial sums to a workspace that a second
   kernel adds in slice order before the relu;
5. a coalesced epilogue: the output tile goes through shared memory and
   out in 16-byte stores.

Tolerance: every product ``xk·x0`` is rounded to fp32 once and accumulated
with fp32 FMAs, as in the Pallas body; only the order of the fp32 sums
changes, and split-K partials are added in a fixed order, so the reference's
2e-5 holds and two calls on the same inputs give the same bits (no TF32, no
atomics).  Plain version: ``ref.cin_layer_ref``.
"""
from __future__ import annotations

import functools

import torch

from . import _build

#: calls of ``cin_layer_cuda`` that launched the kernel since import (one a
#: call, whatever its number of k slices; reset by callers that count a run)
LAUNCHES = 0

ROW_TILE, OUT_TILE = 128, 208   # the kernel's block tile (cin.cu kBM, kBN)
H100_SMS = 132
MAX_SLICES = 16
_MAX_GRID_Y = 65_535
_MAX_INT = 2**31 - 1


def plan(b: int, h: int, m: int, d: int, o: int,
         n_sms: int = H100_SMS) -> tuple[int, int, int]:
    """K5's launch grid for xk ``[b, h, d]``, x0 ``[b, m, d]``, w ``[o, h,
    m]`` on ``n_sms`` SMs (one block each): ``(row tiles, output tiles,
    S)``.  S = 1 where the tiles fill a wave; otherwise S is the most k
    slices (at most h and ``MAX_SLICES``) that keep all blocks in one wave.
    ``m`` does not change the plan."""
    row_tiles = -(-(b * d) // ROW_TILE)
    out_tiles = -(-o // OUT_TILE)
    tiles = row_tiles * out_tiles
    slices = 1
    if 0 < tiles < n_sms:
        slices = max(1, min(n_sms // tiles, h, MAX_SLICES))
    return row_tiles, out_tiles, slices


def h_ranges(h: int, slices: int) -> list[tuple[int, int]]:
    """The ranges ``[lo, hi)`` of h that the kernel's k slices cover, in
    slice order (each with all of m)."""
    return [(s * h // slices, (s + 1) * h // slices) for s in range(slices)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cin_layer_cuda(xk: torch.Tensor, x0: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Launch K5: ``relu(einsum('bhd,bmd,ohm->bod', xk, x0, w))`` for
    float32 xk ``[B, H, D]``, x0 ``[B, M, D]``, w ``[O, H, M]`` on the
    card, split over k as ``plan`` says.  Raises on what the kernel does not
    take; never falls back to the plain version."""
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
    # the epilogue indexes a tile's outputs, up to OUT_TILE (ROW_TILE + 2 d)
    # of them, in 32 bits, as it does the k columns and offsets h d, m d
    if (-(-o // OUT_TILE) > _MAX_GRID_Y or -(-(b * d) // ROW_TILE) > _MAX_INT
            or max(h * m, h * d, m * d, OUT_TILE * (ROW_TILE + 2 * d))
            > _MAX_INT):
        raise ValueError(f"shapes outside the kernel's grid or 32-bit "
                         f"offsets: xk {tuple(xk.shape)}, x0 "
                         f"{tuple(x0.shape)}, w {tuple(w.shape)}")
    out = torch.empty((b, o, d), dtype=torch.float32, device=xk.device)
    if out.numel() == 0:
        return out
    slices = plan(b, h, m, d, o, _sm_count(xk.device.index))[2]
    ws = (torch.empty((slices, b, o, d), dtype=torch.float32,
                      device=xk.device) if slices > 1 else None)
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream(xk.device).cuda_stream
        status = _build.library("cin").cin_layer_launch(
            xk.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), b, h, m, d, o, slices,
            stream)
    _build.check(status, "cin_layer")
    LAUNCHES += 1
    return out
