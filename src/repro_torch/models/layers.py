"""Shared neural-net substrate of the LM family (port of
``repro/models/layers.py``): initializers, norms, RoPE, GQA attention
(causal / sliding window / qk-norm, prefill and ring-buffer decode), GLU
MLPs, and GShard-style MoE with top-k routing and per-row capacity.

All modules are (init, apply) pairs over plain dicts of tensors.  Compute
dtype is bf16 with fp32 params and fp32 softmax/normaliser math, and the
casts sit where the reference puts them, so bf16 rounds at the same places.
Prefill and training attention on a CUDA tensor at ``s >= 512`` launches
the hand-written kernel K3 (``kernels.ops.flash_attention_heads``);
everywhere else it takes ``_chunked_attention``, exactly as the reference
does off the TPU.  Both go through that one differentiable entry, whose
backward is plain (``kernels.ref.attention_vjp_ref``).  Decode
attention is plain fp32 tensor math, as in the reference, and updates the KV
cache in place (the reference donates it).

Initializers draw from an explicit ``torch.Generator`` on the device the
parameters live on; its numbers are not ``jax.random``'s, so the tests carry
the reference's parameters across with ``transformer.params_from_numpy``.
The MoE layer routes on the device with no host sync (``moe_route``) and
runs its experts as bf16 einsums over ``[B, E, cap, ·]``, as the reference
does outside any kernel, through the single-device branch of the
reference's ``_expert_block_dispatch``.  The mesh hints (``shard_hint``,
sequence-parallel attention, the expert block's ``shard_map``) wait for
the port's LM mesh.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..kernels.ref import chunked_attention_ref as _chunked_attention  # noqa: F401

Params = dict[str, Any]
COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device,
                       dtype=torch.float32) * 0.02


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """A reference parameter pytree of dicts and lists, as numpy arrays,
    as the port's parameters (float32) on ``device`` (the recsys and GNN
    families; the LM family stacks its layers, ``transformer``'s own)."""
    return _map(tree, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device))


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_numpy``: every tensor as a float32 numpy
    array, under the same keys and lists."""
    return _map(params, lambda t: t.detach().cpu().numpy())


def batch_to_torch(batch: dict, device="cuda") -> dict:
    """A batch of numpy arrays (a ``ClickStream`` or sampler batch) as
    tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str, device="cuda") -> Params:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e6) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (broadcastable)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                           # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, qk_norm: bool = False) -> Params:
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim),
        "wk": dense_init(gen, d_model, n_kv * head_dim),
        "wv": dense_init(gen, d_model, n_kv * head_dim),
        "wo": dense_init(gen, n_heads * head_dim, d_model,
                         scale=1.0 / math.sqrt(n_heads * head_dim)),
    }
    if qk_norm:
        p["q_norm"] = norm_init(head_dim, "rmsnorm", gen.device)
        p["k_norm"] = norm_init(head_dim, "rmsnorm", gen.device)
    return p


def attention_apply(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                    n_heads: int, n_kv: int, head_dim: int,
                    causal: bool = True, window: int | None = None,
                    qk_norm: bool = False, rope_theta: float = 1e6,
                    cache: tuple | None = None,
                    cache_pos: int | None = None) -> tuple:
    """x: [B, S, D].  If ``cache`` is given (decode), it is updated in place
    and returned.

    cache = (k_cache, v_cache): [B, C, n_kv, Dh]; cache_pos: int — absolute
    position of the incoming token; ring-buffered when C < pos.
    """
    b, s, _ = x.shape
    xc = x.to(COMPUTE_DTYPE)
    q = (xc @ p["wq"].to(COMPUTE_DTYPE)).reshape(b, s, n_heads, head_dim)
    k = (xc @ p["wk"].to(COMPUTE_DTYPE)).reshape(b, s, n_kv, head_dim)
    v = (xc @ p["wv"].to(COMPUTE_DTYPE)).reshape(b, s, n_kv, head_dim)
    if qk_norm:
        q = norm_apply(p["q_norm"], q, "rmsnorm")
        k = norm_apply(p["k_norm"], k, "rmsnorm")
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)

    if cache is None:
        # K3 on the card at s >= 512, the chunked plain version elsewhere;
        # one differentiable entry either way (backward: attention_vjp_ref)
        out = kernel_ops.flash_attention_heads(
            q, k, v, causal=causal, window=window,
            kernel=x.device.type == "cuda" and s >= 512)  # [B, S, Hq, Dh]
        out = out.reshape(b, s, n_heads * head_dim)
        new_cache = None
    else:
        k_cache, v_cache = cache
        c = k_cache.shape[1]
        slot = cache_pos % c  # ring buffer (SWA windows)
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        # decode attention (q_len == 1): bandwidth-bound gather math in fp32
        ring = torch.arange(c, device=x.device)
        kv_pos_abs = cache_pos - ((slot - ring) % c)  # abs position per slot
        valid = (kv_pos_abs >= 0) & (kv_pos_abs <= cache_pos)
        if window is not None:
            valid &= (cache_pos - kv_pos_abs) < window
        group = n_heads // n_kv
        qg = q.reshape(b, n_kv, group, head_dim)
        scores = torch.einsum("bkgd,bckd->bkgc", qg.float(),
                              k_cache.float()) * head_dim ** -0.5
        scores = torch.where(valid, scores, -1e30)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgc,bckd->bkgd", w, v_cache.float())
        out = out.reshape(b, 1, n_heads * head_dim).to(COMPUTE_DTYPE)
        new_cache = (k_cache, v_cache)

    out = out.to(COMPUTE_DTYPE) @ p["wo"].to(COMPUTE_DTYPE)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: str) -> Params:
    if kind in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d_model, d_ff),
                "w_up": dense_init(gen, d_model, d_ff),
                "w_down": dense_init(gen, d_ff, d_model,
                                     scale=1.0 / math.sqrt(d_ff))}
    return {"w_up": dense_init(gen, d_model, d_ff),
            "w_down": dense_init(gen, d_ff, d_model, scale=1.0 / math.sqrt(d_ff))}


def mlp_apply(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    xc = x.to(COMPUTE_DTYPE)
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        g = act(xc @ p["w_gate"].to(COMPUTE_DTYPE))
        u = xc @ p["w_up"].to(COMPUTE_DTYPE)
        return (g * u) @ p["w_down"].to(COMPUTE_DTYPE)
    h = _gelu(xc @ p["w_up"].to(COMPUTE_DTYPE))
    return h @ p["w_down"].to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style scatter/gather dispatch)
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             kind: str) -> Params:
    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(d_ff)

    def stack(din, dout, scale):
        return torch.randn((n_experts, din, dout), generator=gen,
                           device=gen.device, dtype=torch.float32) * scale

    p = {"router": dense_init(gen, d_model, n_experts, scale=0.02)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = stack(d_model, d_ff, scale_in)
        p["w_up"] = stack(d_model, d_ff, scale_in)
        p["w_down"] = stack(d_ff, d_model, scale_out)
    else:
        p["w_up"] = stack(d_model, d_ff, scale_in)
        p["w_down"] = stack(d_ff, d_model, scale_out)
    return p


class Routing(NamedTuple):
    """One MoE layer's routing of ``x [B, S, D]`` (TK = S · top_k slots a
    row, token-major): the router's fp32 softmax ``probs [B, S, E]``, the
    chosen experts ``gate_idx [B, S, K]``, the renormalised gates ``[B,
    TK]`` in ``COMPUTE_DTYPE`` (0 where dropped), ``keep [B, TK]``, the
    dispatch slot ``dest [B, TK]`` (``n_experts · cap`` where dropped) and
    the per-row capacity ``cap``."""
    probs: torch.Tensor
    gate_idx: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    cap: int


def moe_capacity(s: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    """Slots per expert and batch row: ``max(1, ceil(cf · s · k / E))``
    written as the reference writes it (a host int from shapes)."""
    return max(1, -(-int(capacity_factor * s * top_k) // n_experts))


def moe_route(router: torch.Tensor, x: torch.Tensor, *, n_experts: int,
              top_k: int, capacity_factor: float = 1.25,
              gate_idx: torch.Tensor | None = None) -> Routing:
    """The reference's routing (``repro/models/layers.py:383-403``), on the
    device of ``x`` with no host sync.  Top-k is a stable descending sort,
    so exact ties keep the lower expert first as ``lax.top_k`` does.  A
    given ``gate_idx`` replaces the top-k choice (the gates are then this
    call's probabilities at those experts); the queue positions, ``keep``
    and ``dest`` follow from the choice alone."""
    b, s, _ = x.shape
    tk = s * top_k
    logits = torch.einsum("bsd,de->bse", x.to(COMPUTE_DTYPE),
                          router.to(COMPUTE_DTYPE)).float()
    probs = torch.softmax(logits, dim=-1)
    if gate_idx is None:
        gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                         stable=True)
        gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]
    else:
        gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # per-row capacity and queue positions (GShard groups): an exclusive
    # cumsum of the one-hot over each row's token-major slots
    cap = moe_capacity(s, n_experts, top_k, capacity_factor)
    idx_flat = gate_idx.reshape(b, tk)
    flat = (idx_flat[..., None] == torch.arange(
        n_experts, device=x.device)).to(torch.int32)            # [B, TK, E]
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1)    # [B, TK]
    keep = pos < cap
    dest = torch.where(keep, idx_flat * cap + pos,
                       torch.full_like(idx_flat, n_experts * cap))
    gates = gate_vals.reshape(b, tk).to(COMPUTE_DTYPE)
    gates = torch.where(keep, gates, torch.zeros_like(gates))
    return Routing(probs, gate_idx, gates, keep, dest, cap)


def _expert_block(r: Routing, xc: torch.Tensor, w: Params, *, n_experts: int,
                  top_k: int, kind: str) -> torch.Tensor:
    """Scatter-dispatch -> expert einsums -> gather-combine, ``[B, S, D]``
    in and out: the reference's ``expert_block`` as its
    ``_expert_block_dispatch`` runs it without a model axis.  The dropped
    slots scatter into one extra row that is cut away, as ``mode="drop"``
    drops them."""
    b, s, d = xc.shape
    tk, n_slots = s * top_k, n_experts * r.cap
    src = torch.arange(tk, device=xc.device) // top_k
    updates = xc[:, src, :]                                      # [B, TK, D]
    buf = torch.zeros((b, n_slots + 1, d), dtype=xc.dtype, device=xc.device)
    buf = buf.scatter_add(1, r.dest[..., None].expand(b, tk, d), updates)
    xe = buf[:, :n_slots].reshape(b, n_experts, r.cap, d)
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        g = act(torch.einsum("becd,edf->becf", xe,
                             w["w_gate"].to(COMPUTE_DTYPE)))
        u = torch.einsum("becd,edf->becf", xe, w["w_up"].to(COMPUTE_DTYPE))
        ye = torch.einsum("becf,efd->becd", g * u,
                          w["w_down"].to(COMPUTE_DTYPE))
    else:
        h = _gelu(torch.einsum("becd,edf->becf", xe,
                               w["w_up"].to(COMPUTE_DTYPE)))
        ye = torch.einsum("becf,efd->becd", h, w["w_down"].to(COMPUTE_DTYPE))
    got = torch.gather(ye.reshape(b, n_slots, d), 1,
                       r.dest.clamp(max=n_slots - 1)[..., None].expand(b, tk, d))
    got = got * r.gates[..., None]
    return got.reshape(b, s, top_k, d).sum(2)


def moe_apply(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
              kind: str, capacity_factor: float = 1.25,
              gate_idx: torch.Tensor | None = None) -> tuple:
    """x: [B, S, D] -> (out [B, S, D] in ``COMPUTE_DTYPE``, aux fp32).

    ``moe_route`` picks each token's experts (or takes ``gate_idx``, to
    replay another run's choices), ``_expert_block`` runs them, and the
    Switch load-balance loss is ``E · Σ_e frac_tokens_e · frac_probs_e``
    over the first choice."""
    r = moe_route(p["router"], x, n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor, gate_idx=gate_idx)
    w = {k: v for k, v in p.items() if k.startswith("w_")}
    out = _expert_block(r, x.to(COMPUTE_DTYPE), w, n_experts=n_experts,
                        top_k=top_k, kind=kind)
    first = (r.gate_idx[..., 0, None] == torch.arange(
        n_experts, device=x.device)).float()
    frac_tokens = first.mean(dim=(0, 1))
    frac_probs = r.probs.mean(dim=(0, 1))
    aux = n_experts * torch.sum(frac_tokens * frac_probs)
    return out, aux
