"""Hopper kernel K3: blocked online-softmax attention (prefill).

Replaces ``repro/kernels/flash_attention.py::flash_attention_kernel``.  The
CUDA body is ``csrc/flash_attention.cu``; its note says what bounds it on an
H100 (operations) and what the design does about it.  The kernel takes the
model's layout, q ``[B, S, Hq, Dh]`` and k/v ``[B, S, Hkv, Dh]`` with
``Hq % Hkv == 0``: query head ``h`` reads KV head ``h // (Hq // Hkv)`` in
place, so the reference's ``jnp.repeat`` of K/V never exists, and the output
``[B, S, Hq, Dh]`` reshapes to ``[B, S, Hq * Dh]`` without a copy.  The
reference's ``[BH, S, Dh]`` layout is the same call with one head
(``ops.flash_attention``).  Plain version: ``ref.attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of this kernel since import (reset by callers that count a run)
LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
_MAX_GRID_Y = 65_535


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """Launch K3: ``softmax(q k^T * Dh**-0.5 + mask) v`` per (batch, head),
    masked by ``causal`` and ``window`` (keys with ``q_pos - k_pos <
    window``), output in ``q.dtype``.  Raises on what the kernel does not
    take; never falls back to the plain version."""
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dim() != 4:
            raise ValueError(f"{name}: need a [B, S, H, Dh] CUDA tensor, got "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(f"{name}: need float32 or bfloat16 like q, got "
                             f"{t.dtype} (q {q.dtype})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: need a contiguous, 16-byte aligned "
                             f"tensor")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    b, s, hq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] != s:
        raise ValueError(f"the kernel assumes Sq == Skv (prefill), got "
                         f"{s} and {k.shape[1]}")
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if b * hq > _MAX_GRID_Y:
        raise ValueError(f"batch * heads = {b * hq} > {_MAX_GRID_Y}")
    if window is not None and window < 0:
        raise ValueError(f"window {window} < 0")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    # (batch, head, seq) element strides of q, of k and v, of o
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, o)
                                        for i in (0, 2, 1)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _build.library("flash_attention").flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            b, hq, hq // hkv, s, dh, int(q.dtype == torch.bfloat16),
            int(causal), -1 if window is None else int(window), dh ** -0.5,
            stream)
    _build.check(status, "flash_attention")
    LAUNCHES += 1
    return o
