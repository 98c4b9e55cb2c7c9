"""LM family (port of ``repro/models/transformer.py``): a decoder-only
transformer covering the seven LM archs (dense GQA, qk-norm, MQA/GeGLU,
SWA, LayerNorm/GELU, and the MoE variants) with its training loss, prefill
and ring-buffer decode paths.

Parameters are a plain dict under the reference's key names, with the
reference's ``[L, ...]``-stacked ``layers`` held as a list of per-layer
dicts, so a layer loop replaces ``lax.scan``.  ``params_from_numpy`` /
``params_to_numpy`` carry a reference pytree (as numpy) across, the MoE
layers' router and ``[E, d_in, d_out]`` expert stacks included.

``loss_fn`` is differentiable: each layer runs under
``torch.utils.checkpoint`` (the reference's per-layer remat), so its
forward, K3 included, runs again in the backward; the cross-entropy runs
one sequence chunk at a time, each chunk checkpointed, so the ``[B, S, V]``
logits never exist.  It adds ``0.01 ·`` the layers' summed MoE aux loss,
as the reference does.  ``backbone``, ``prefill`` and ``decode_step`` run
under ``torch.no_grad``; the KV cache of ``decode_step`` is updated in
place, and its position may be a 0-d device tensor (no host read).  Each
forward takes ``mesh=`` (a ``ShardMesh`` with a ``model`` axis, or None)
for the MoE layers' expert block (``layers._expert_block_dispatch``);
nothing else reads it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from . import layers
from .layers import COMPUTE_DTYPE


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(cfg: LMConfig, gen: torch.Generator) -> dict:
    p = {
        "attn_norm": layers.norm_init(cfg.d_model, cfg.norm, gen.device),
        "attn": layers.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                      cfg.head_dim, cfg.qk_norm),
        "mlp_norm": layers.norm_init(cfg.d_model, cfg.norm, gen.device),
    }
    if cfg.moe_experts:
        p["moe"] = layers.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe_experts,
                                   cfg.mlp)
    else:
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp)
    return p


def init_params(cfg: LMConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen``, on ``gen.device``."""
    p = {
        "embed": layers.embed_init(gen, cfg.vocab, cfg.d_model),
        "layers": [init_layer(cfg, gen) for _ in range(cfg.n_layers)],
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, gen.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                         scale=1.0 / math.sqrt(cfg.d_model))
    return p


def param_count(cfg: LMConfig) -> int:
    """The reference's count: matrices, embeddings and the two per-layer
    norms (qk-norm scales and the final norm are not counted)."""
    attn = cfg.d_model * cfg.head_dim * (cfg.n_heads * 2 + cfg.n_kv * 2)
    n_mat = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    if cfg.moe_experts:
        ffn = cfg.moe_experts * n_mat * cfg.d_model * cfg.d_ff + cfg.d_model * cfg.moe_experts
    else:
        ffn = n_mat * cfg.d_model * cfg.d_ff
    per_layer = attn + ffn + 2 * cfg.d_model
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return cfg.n_layers * per_layer + emb


def active_param_count(cfg: LMConfig) -> int:
    """Active parameters a token (MoE: only its top-k experts count): the
    reference's count less each layer's ``E - k`` idle experts."""
    if not cfg.moe_experts:
        return param_count(cfg)
    n_mat = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    idle = (cfg.moe_experts - cfg.moe_top_k) * n_mat * cfg.d_model * cfg.d_ff
    return param_count(cfg) - cfg.n_layers * idle


# ---------------------------------------------------------------------------
# carrying parameters across from the reference
# ---------------------------------------------------------------------------

def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(cfg: LMConfig, tree: dict, device="cuda") -> dict:
    """The reference's parameter pytree, as numpy arrays, as the port's
    parameters on ``device``: ``layers`` (arrays stacked on a leading
    ``[L]`` axis) split into ``cfg.n_layers`` per-layer dicts."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    out = {k: _map(v, t) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(tree["layers"], lambda a, i=i: t(np.asarray(a)[i]))
                     for i in range(cfg.n_layers)]
    return out


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_numpy``: per-layer dicts stacked back on a
    leading ``[L]`` axis, every tensor as a float32 numpy array."""
    def a(x):
        return x.detach().cpu().numpy()

    out = {k: _map(v, a) for k, v in params.items() if k != "layers"}

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return np.stack([a(x) for x in leaves])

    out["layers"] = stack(*params["layers"])
    return out


def stack_layers(params: dict) -> dict:
    """The reference's layout of the port's parameters: ``layers`` as one
    dict of ``[L, ...]`` tensors (``torch.stack`` of the per-layer leaves,
    on their device; on ``meta``, shapes only), the rest as it is."""
    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return torch.stack(leaves)

    return {k: (stack(*v) if k == "layers" else v) for k, v in params.items()}


def unstack_layers(params: dict) -> dict:
    """Inverse of ``stack_layers`` with views: each layer's leaves are
    ``unbind(0)`` slices of the stacked ones, so a gradient through them
    lands on the stacked leaves."""
    def split(tree):
        if isinstance(tree, dict):
            per = {k: split(v) for k, v in tree.items()}
            n = len(next(iter(per.values())))
            return [{k: v[i] for k, v in per.items()} for i in range(n)]
        return tree.unbind(0)

    return {k: (split(v) if k == "layers" else v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """bf16 embedding rows times sqrt(d_model), the scalar rounded to bf16
    first as the reference's weak-typed multiply rounds it (a host float:
    no copy to the device, so no sync)."""
    scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=COMPUTE_DTYPE))
    return params["embed"][tokens].to(COMPUTE_DTYPE) * scale


def _layer_fwd(cfg: LMConfig, lp: dict, x: torch.Tensor,
               positions: torch.Tensor, cache=None, cache_pos=None,
               mesh=None):
    """One layer -> (x, aux): the MoE layer's aux loss (fp32), 0.0 for a
    dense layer."""
    h, _ = layers.attention_apply(
        lp["attn"], layers.norm_apply(lp["attn_norm"], x, cfg.norm), positions,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
        causal=True, window=cfg.window, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, cache=cache, cache_pos=cache_pos)
    x = x + h
    z = layers.norm_apply(lp["mlp_norm"], x, cfg.norm)
    if cfg.moe_experts:
        m, aux = layers.moe_apply(lp["moe"], z, n_experts=cfg.moe_experts,
                                  top_k=cfg.moe_top_k, kind=cfg.mlp,
                                  capacity_factor=cfg.moe_capacity,
                                  mesh=mesh)
    else:
        m, aux = layers.mlp_apply(lp["mlp"], z, cfg.mlp), 0.0
    return x + m, aux


def _backbone(cfg: LMConfig, params: dict, tokens: torch.Tensor,
              mesh=None) -> tuple:
    """tokens [B, S] -> (hidden [B, S, D] bf16, the layers' summed aux
    loss; 0.0 for a dense model), with a gradient: each layer is
    checkpointed (recomputed in the backward), as the reference remats each
    layer; under ``torch.no_grad`` that saves nothing and recomputes
    nothing."""
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    aux = 0.0
    for lp in params["layers"]:
        x, a = checkpoint(_layer_fwd, cfg, lp, x, positions, mesh=mesh,
                          use_reentrant=False, preserve_rng_state=False)
        aux = aux + a
    return layers.norm_apply(params["final_norm"], x, cfg.norm), aux


@torch.no_grad()
def backbone(cfg: LMConfig, params: dict, tokens: torch.Tensor, *,
             mesh=None) -> tuple:
    """tokens [B, S] -> (hidden [B, S, D] bf16, aux loss)."""
    return _backbone(cfg, params, tokens, mesh)


def _unembed(cfg: LMConfig, params: dict) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return w.to(COMPUTE_DTYPE)


def _chunk_loss(h: torch.Tensor, t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Summed ``logsumexp - gold`` of one sequence chunk: logits ``(h @
    w)`` in bf16, then fp32, as the reference's ``chunk_loss``."""
    logits = (h @ w).float()                                     # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def loss_fn(cfg: LMConfig, params: dict, batch: dict, *,
            xent_chunk: int = 512, mesh=None) -> torch.Tensor:
    """Causal LM loss, differentiable: the mean next-token cross-entropy
    plus ``0.01 ·`` the MoE aux loss (0 for a dense model).  The logits are
    computed one ``xent_chunk``-long sequence chunk at a time under
    ``checkpoint`` (recomputed in the backward), so ``[B, S, V]`` never
    exists.  As in the reference, ``S // chunk`` chunks are summed and the
    sum is divided by ``B·S``."""
    tokens, targets = batch["tokens"], batch["targets"]
    hidden, aux = _backbone(cfg, params, tokens, mesh)
    w = _unembed(cfg, params)
    b, s, _ = hidden.shape
    c = min(xent_chunk, s)
    losses = [checkpoint(_chunk_loss, hidden[:, i * c:(i + 1) * c],
                         targets[:, i * c:(i + 1) * c], w, use_reentrant=False,
                         preserve_rng_state=False) for i in range(s // c)]
    nll = torch.stack(losses).sum() / (b * s)
    return nll + 0.01 * aux


@torch.no_grad()
def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor, *,
            mesh=None) -> torch.Tensor:
    """Prefill forward returning last-position logits [B, V] fp32 (the aux
    loss discarded, as the reference does)."""
    hidden, _ = backbone(cfg, params, tokens, mesh=mesh)
    return (hidden[:, -1] @ _unembed(cfg, params)).float()


# ---------------------------------------------------------------------------
# decode (serve_step): one token against a KV cache
# ---------------------------------------------------------------------------

def cache_len(cfg: LMConfig, seq: int) -> int:
    return min(seq, cfg.window) if cfg.window else seq


def init_cache(cfg: LMConfig, batch: int, seq: int, dtype=COMPUTE_DTYPE,
               device="cuda") -> dict:
    c = cache_len(cfg, seq)
    shape = (cfg.n_layers, batch, c, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def decode_step(cfg: LMConfig, params: dict, cache: dict, token: torch.Tensor,
                pos, *, mesh=None) -> tuple[torch.Tensor, dict]:
    """token [B] int, pos (int or 0-d integer tensor) -> (logits [B, V]
    fp32, cache); the cache is written in place at ring slot ``pos % C`` of
    every layer."""
    b = token.shape[0]
    x = _embed(cfg, params, token)[:, None, :]
    if not isinstance(pos, torch.Tensor):   # a fill, no host-to-device copy
        pos = torch.full((), pos, device=token.device)
    positions = pos.to(torch.int32).reshape(1, 1).expand(b, 1)
    for i, lp in enumerate(params["layers"]):
        x, _ = _layer_fwd(cfg, lp, x, positions,
                          cache=(cache["k"][i], cache["v"][i]), cache_pos=pos,
                          mesh=mesh)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    logits = (x[:, 0] @ _unembed(cfg, params)).float()
    return logits, cache
