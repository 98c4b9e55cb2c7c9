"""int8 KV-cache quantization (port of ``repro/serving/kv_quant.py``).

Decode reads the whole KV cache every wave.  Per-(position, head)
symmetric int8 quantization stores each cache row as int8 values and one
fp32 scale, about half the bytes of a bf16 cache (a quarter of fp32), at
under 1e-2 attention-output error.  ``torch.round`` rounds half to even,
as ``jnp.round`` does, so values and scales equal the reference's
bitwise.  As in the reference, the decode engine does not use it.

Layout: values int8 ``[B, C, Hkv, Dh]`` + scales fp32 ``[B, C, Hkv, 1]``.
"""
from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [..., Dh] -> (int8 values, fp32 scale per leading index)."""
    xf = x.float()
    # divided by a 0-dim tensor on the device: a CUDA tensor divided by a
    # Python scalar is multiplied by its reciprocal, which rounds otherwise
    scale = xf.abs().amax(dim=-1, keepdim=True) / torch.full(
        (), 127.0, device=xf.device)
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_quant_cache(n_layers: int, batch: int, cache_len: int, n_kv: int,
                     head_dim: int, device="cuda") -> dict:
    shape = (n_layers, batch, cache_len, n_kv, head_dim)
    sshape = (n_layers, batch, cache_len, n_kv, 1)
    return {"kq": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
            "vq": torch.zeros(shape, dtype=torch.int8, device=device),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=device)}


def update_quant_cache(cache: dict, layer_slice, k_new: torch.Tensor,
                       v_new: torch.Tensor, slot: int) -> dict:
    """Write one token's K/V (quantized) at ring ``slot``, in place, for
    all layers at once when ``layer_slice`` is None, else for one layer
    index; returns ``cache``."""
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    idx = ((slice(None), slice(None), slot) if layer_slice is None
           else (layer_slice, slice(None), slot))
    cache["kq"][idx] = kq
    cache["ks"][idx] = ks
    cache["vq"][idx] = vq
    cache["vs"][idx] = vs
    return cache


def attend_quant(q: torch.Tensor, cache_layer: dict, valid: torch.Tensor,
                 n_kv: int, head_dim: int) -> torch.Tensor:
    """q: [B, Hq, Dh]; cache_layer: one layer's quantized K/V [B, C, Hkv, *];
    valid: [C] or [B, C] -> [B, Hq, Dh] fp32, the decode attention's fp32
    math over the dequantized cache."""
    b, hq, dh = q.shape
    group = hq // n_kv
    qg = q.reshape(b, n_kv, group, dh).float()
    k = dequantize_kv(cache_layer["kq"], cache_layer["ks"], torch.float32)
    v = dequantize_kv(cache_layer["vq"], cache_layer["vs"], torch.float32)
    scores = torch.einsum("bkgd,bckd->bkgc", qg, k) * dh ** -0.5
    mask = valid[:, None, None, :] if valid.dim() == 2 else valid
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", w, v)
    return out.reshape(b, hq, dh)
