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
does outside any kernel.  ``_expert_block_dispatch`` keeps the reference's
three branches: no mesh and expert parallelism (the experts divide the
``model`` axis) run the block as one call; otherwise each mesh position
runs it on its batch slice and its ``d_ff`` slice of the expert weights,
and the combined bf16 partials are summed over ``model`` (the reference's
``shard_map``).  ``shard_hint`` returns its input: the reference's is a
GSPMD constraint, and the port has no partitioner for it to steer.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.distributed import psum
from ..kernels import ops as kernel_ops
from ..kernels.ref import chunked_attention_ref as _chunked_attention  # noqa: F401

Params = dict[str, Any]
COMPUTE_DTYPE = torch.bfloat16


def shard_hint(x: torch.Tensor, *dims) -> torch.Tensor:
    """``x`` itself.  Kept for parity with the reference; nothing calls it.

    The reference's ``shard_hint`` is ``with_sharding_constraint`` against
    the ambient mesh (``dims``: ``"dp"``, ``"model"`` or None per axis) and
    a no-op off a mesh.  On a mesh it steers XLA's GSPMD partitioner; the
    port has none (a mesh program here places each position's work itself,
    as ``_expert_block_dispatch`` does), so there is nothing to steer."""
    return x


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

_ROPE_FREQS: dict = {}


def rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    """RoPE's frequency table ``theta ** (-i / half)``, ``i < half``, in
    fp32: computed in float64 on the host and rounded once, which gives the
    reference's fp32 ``pow`` in every entry (torch's fp32 ``pow`` misses it
    by one ulp in a few entries at head dims 128 and 256, and the angle's
    error grows with the position).  Cached per ``(half, theta, device)``,
    so a decode wave makes no copy to the device."""
    device = torch.device(device)
    key = (half, float(theta), device)
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        exps = -torch.arange(0, half, dtype=torch.float64) / half
        freqs = (float(theta) ** exps).float().to(device)
        _ROPE_FREQS[key] = freqs
    return freqs


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e6) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (broadcastable)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = rope_freqs(half, theta, x.device)
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
                    cache_pos=None) -> tuple:
    """x: [B, S, D].  If ``cache`` is given (decode), it is updated in place
    and returned.

    cache = (k_cache, v_cache): [B, C, n_kv, Dh]; cache_pos: int or 0-d
    integer tensor (read on the device, never on the host) — absolute
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
            kernel=x.device.type in ("cuda", "meta") and s >= 512)
        out = out.reshape(b, s, n_heads * head_dim)
        new_cache = None
    else:
        k_cache, v_cache = cache
        c = k_cache.shape[1]
        if not isinstance(cache_pos, torch.Tensor):   # a fill, no copy
            cache_pos = torch.full((), cache_pos, device=x.device)
        slot = cache_pos % c  # ring buffer (SWA windows)
        k_cache.index_copy_(1, slot.reshape(1).long(), k.to(k_cache.dtype))
        v_cache.index_copy_(1, slot.reshape(1).long(), v.to(v_cache.dtype))
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
                  top_k: int, kind: str, slices: int = 0) -> torch.Tensor:
    """Scatter-dispatch -> expert einsums -> gather-combine, ``[B, S, D]``
    in and out: the reference's ``expert_block``.  It reads ``r.dest``,
    ``r.gates`` and ``r.cap`` only.  The dropped slots scatter into one
    extra row that is cut away, as ``mode="drop"`` drops them.

    ``slices=m`` runs ``m`` ``d_ff`` slices of the experts at once: the
    weights come as views ``w_gate`` / ``w_up`` ``[E, D, m, f]`` and
    ``w_down`` ``[E, m, f, D]``, and the result is each slice's combined
    partial, ``[m, B, S, D]``."""
    b, s, d = xc.shape
    tk, n_slots = s * top_k, n_experts * r.cap
    src = torch.arange(tk, device=xc.device) // top_k
    updates = xc[:, src, :]                                      # [B, TK, D]
    buf = torch.zeros((b, n_slots + 1, d), dtype=xc.dtype, device=xc.device)
    buf = buf.scatter_add(1, r.dest[..., None].expand(b, tk, d), updates)
    xe = buf[:, :n_slots].reshape(b, n_experts, r.cap, d)
    up, down = (("becd,edmf->mbecf", "mbecf,emfd->mbecd") if slices
                else ("becd,edf->becf", "becf,efd->becd"))
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        g = act(torch.einsum(up, xe, w["w_gate"].to(COMPUTE_DTYPE)))
        u = torch.einsum(up, xe, w["w_up"].to(COMPUTE_DTYPE))
        ye = torch.einsum(down, g * u, w["w_down"].to(COMPUTE_DTYPE))
    else:
        h = _gelu(torch.einsum(up, xe, w["w_up"].to(COMPUTE_DTYPE)))
        ye = torch.einsum(down, h, w["w_down"].to(COMPUTE_DTYPE))
    lead = ye.shape[:-4]                                         # (m,) or ()
    idx = r.dest.clamp(max=n_slots - 1)[..., None].expand(*lead, b, tk, d)
    got = torch.gather(ye.reshape(*lead, b, n_slots, d), -2, idx)
    got = got * r.gates[..., None]
    return got.reshape(*lead, b, s, top_k, d).sum(-2)


def _position_grid(mesh) -> np.ndarray:
    """The mesh's devices as a ``[dp, model]`` grid: the ``model`` axis
    last, the data-parallel axes (``pod``, ``data``) flattened in mesh
    order."""
    grid = np.empty(len(mesh.devices), dtype=object)
    grid[:] = mesh.devices
    grid = grid.reshape(tuple(mesh.shape.values()))
    grid = np.moveaxis(grid, mesh.axis_names.index("model"), -1)
    return grid.reshape(-1, mesh.shape["model"])


def _row_runs(grid: np.ndarray, b: int) -> list:
    """``(lo, hi, devices)``: the batch rows of each run of data-parallel
    grid rows whose positions sit on the same devices, in order; one run
    of the whole batch where the rows cannot split it (every row then
    holds the same result)."""
    if b % len(grid):
        return [(0, b, tuple(grid[0]))]
    step, runs = b // len(grid), []
    for i, row in enumerate(grid):
        if runs and runs[-1][2] == tuple(row):
            runs[-1] = (runs[-1][0], (i + 1) * step, runs[-1][2])
        else:
            runs.append((i * step, (i + 1) * step, tuple(row)))
    return runs


def _expert_block_dispatch(r: Routing, xc: torch.Tensor, w: Params, *,
                           n_experts: int, top_k: int, kind: str,
                           mesh=None) -> torch.Tensor:
    """The reference's ``_expert_block_dispatch``: with no ``model`` axis,
    or when the experts divide it (expert parallelism), the block is one
    call.  Otherwise the expert weights are sharded on ``d_ff``: position
    ``(i, j)`` takes batch slice ``i`` (the whole batch when the
    data-parallel size does not divide it), ``w_gate`` / ``w_up`` sliced
    on their last dim and ``w_down`` on its middle one at ``j``, and runs
    the block in bf16 on its device; the combined bf16 partials are summed
    over ``model`` in position order (``psum``), after the combine as the
    reference sums them, and the batch slices joined on the first
    position's device.  Positions that share a device run as one call:
    its batch slices together, its ``d_ff`` slices batched in the einsums
    (``_expert_block(slices=...)``), so on one card or on ``meta`` a layer
    is one call whatever the mesh's size."""
    msize = mesh.shape.get("model", 0) if mesh is not None else 0
    if msize == 0 or n_experts % msize == 0:
        return _expert_block(r, xc, w, n_experts=n_experts, top_k=top_k,
                             kind=kind)
    grid = _position_grid(mesh)
    e, d_ff = n_experts, w["w_up"].shape[-1]
    if d_ff % msize:
        raise ValueError(f"d_ff {d_ff} does not split over model={msize}")
    f = d_ff // msize
    views = {k: (v.reshape(e, msize, f, v.shape[-1]) if k == "w_down"
                 else v.reshape(e, v.shape[1], msize, f))
             for k, v in w.items()}                  # the d_ff slice axis
    outs = []
    for lo, hi, devs in _row_runs(grid, xc.shape[0]):
        parts = [None] * msize
        for dev in dict.fromkeys(devs):
            cols = [j for j, d in enumerate(devs) if d == dev]
            if len(cols) < msize:
                idx = torch.tensor(cols, device=w["w_up"].device)
                wd = {k: v.index_select(1 if k == "w_down" else 2, idx).to(dev)
                      for k, v in views.items()}
            else:
                wd = {k: v.to(dev) for k, v in views.items()}
            rd = r._replace(dest=r.dest[lo:hi].to(dev),
                            gates=r.gates[lo:hi].to(dev))
            got = _expert_block(rd, xc[lo:hi].to(dev), wd, n_experts=e,
                                top_k=top_k, kind=kind, slices=len(cols))
            for j, part in zip(cols, got.unbind(0)):
                parts[j] = part
        outs.append(psum(parts)[0].to(grid[0, 0]))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def moe_apply(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
              kind: str, capacity_factor: float = 1.25,
              gate_idx: torch.Tensor | None = None, mesh=None) -> tuple:
    """x: [B, S, D] -> (out [B, S, D] in ``COMPUTE_DTYPE``, aux fp32).

    ``moe_route`` picks each token's experts (or takes ``gate_idx``, to
    replay another run's choices), ``_expert_block_dispatch`` runs them
    (over ``mesh``'s positions where the experts do not divide its
    ``model`` axis), and the Switch load-balance loss is ``E · Σ_e
    frac_tokens_e · frac_probs_e`` over the first choice."""
    r = moe_route(p["router"], x, n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor, gate_idx=gate_idx)
    w = {k: v for k, v in p.items() if k.startswith("w_")}
    out = _expert_block_dispatch(r, x.to(COMPUTE_DTYPE), w,
                                 n_experts=n_experts, top_k=top_k, kind=kind,
                                 mesh=mesh)
    first = (r.gate_idx[..., 0, None] == torch.arange(
        n_experts, device=x.device)).float()
    frac_tokens = first.mean(dim=(0, 1))
    frac_probs = r.probs.mean(dim=(0, 1))
    aux = n_experts * torch.sum(frac_tokens * frac_probs)
    return out, aux
