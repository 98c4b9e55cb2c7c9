"""Hopper kernel K3: blocked online-softmax attention (prefill).

Replaces ``repro/kernels/flash_attention.py::flash_attention_kernel``.  The
CUDA source is ``csrc/flash_attention.cu``, with two bodies; its note says
what bounds K3 on an H100 (operations), what each body does, and why the
bf16 tolerances hold for the tensor-core body.  ``body_for`` picks the body
from the dtype and head dim before the launch: ``"wgmma"`` (bf16 tensor
cores, TMA loads, a K/V ring) for bf16 at head dims 64, 128 and 256, the
models' prefill paths (qwen3-0.6b at 128, gemma-2b at 256); ``"simt"``
(fp32 on CUDA cores) for fp32 at any head dim and bf16 at 16 and 32.

The kernel takes the model's layout, q ``[B, S, Hq, Dh]`` and k/v ``[B, S,
Hkv, Dh]`` with ``Hq % Hkv == 0``: query head ``h`` reads KV head ``h //
(Hq // Hkv)`` in place, so the reference's ``jnp.repeat`` of K/V never
exists, and the output ``[B, S, Hq, Dh]`` reshapes to ``[B, S, Hq * Dh]``
without a copy.  The reference's ``[BH, S, Dh]`` layout is the same call
with one head (``ops.flash_attention``).  Plain version:
``ref.attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of this kernel since import, both bodies (reset by callers that
#: count a run)
LAUNCHES = 0
#: the same launches by body
LAUNCHES_BY_BODY = {"wgmma": 0, "simt": 0}

HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
_MAX_GRID_Y = 65_535
_TMA_MAX_STRIDE_BYTES = 1 << 40   # a tensor map's strides lie below 2^40 B
_TMA_MAX_COORD = (1 << 31) - 1    # its box coordinates are signed 32-bit


def body_for(dtype: torch.dtype, head_dim: int) -> str:
    """The body K3 runs for ``dtype`` and ``head_dim``: ``"wgmma"`` for
    bf16 at head dims 64, 128 and 256, else ``"simt"``."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _dense_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, seq) element strides of a contiguous ``[B, S, H, D]``
    tensor, from its shape (an axis of size 1 may report any stride)."""
    _, s, h, d = t.shape
    return s * h * d, d, h * d


def _tma_refusal(name: str, t: torch.Tensor) -> str | None:
    """Why the wgmma body's 4-D tensor map (D, H, S, B) cannot describe
    ``t``, or None: TMA needs a 16-byte aligned base, strides that are
    multiples of 16 bytes below 2^40, and every coordinate in 32 bits."""
    if t.data_ptr() % 16:
        return f"{name}: base address not 16-byte aligned"
    for axis, st in zip(("batch", "head", "seq"), _dense_strides(t)):
        nbytes = st * t.element_size()
        if nbytes % 16 or nbytes >= _TMA_MAX_STRIDE_BYTES:
            return (f"{name}: {axis} stride of {nbytes} bytes is no multiple "
                    f"of 16 below 2^40")
    if max(t.shape) > _TMA_MAX_COORD:
        return f"{name}: shape {tuple(t.shape)} exceeds 32-bit coordinates"
    return None


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         body: str | None = None) -> torch.Tensor:
    """Launch K3: ``softmax(q k^T * Dh**-0.5 + mask) v`` per (batch, head),
    masked by ``causal`` and ``window`` (keys with ``q_pos - k_pos <
    window``), output in ``q.dtype``.  ``body`` is ``body_for(q.dtype,
    Dh)`` unless given; ``"simt"`` may be asked for any input, ``"wgmma"``
    only where ``body_for`` picks it.  Raises on what the body does not
    take; never switches body and never falls back to the plain version."""
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
    picked = body_for(q.dtype, dh)
    body = picked if body is None else body
    if body not in LAUNCHES_BY_BODY or (body == "wgmma" and picked != "wgmma"):
        raise ValueError(f"body {body!r} does not take {q.dtype} at head_dim "
                         f"{dh} (body_for picks {picked!r})")
    o = torch.empty_like(q)
    if body == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
            why = _tma_refusal(name, t)
            if why is not None:
                raise ValueError(f"the wgmma body cannot map {why}")
    if o.numel() == 0:
        return o
    # (batch, head, seq) element strides of q, of k and v, of o
    strides = (ctypes.c_longlong * 9)(*(x for t in (q, k, o)
                                        for x in _dense_strides(t)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _build.library("flash_attention").flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            b, hq, hq // hkv, s, dh, int(q.dtype == torch.bfloat16),
            int(causal), -1 if window is None else int(window), dh ** -0.5,
            int(body == "wgmma"), stream)
    _build.check(status, f"flash_attention ({body})")
    LAUNCHES += 1
    LAUNCHES_BY_BODY[body] += 1
    return o
