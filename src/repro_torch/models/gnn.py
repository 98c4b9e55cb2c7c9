"""GNN family: GCN, GIN, MeshGraphNet, DimeNet on a shared padded batch
format (PyTorch port of ``repro/models/gnn.py``).

Message passing is built on ``_segment_sum`` over directed edge index
arrays, centralised as in the reference: it is ``kernels.ops.segment_sum``,
K4's rows entry forward on a CUDA tensor (the plain version on a CPU
tensor) and a row gather as its backward.  1-D data (the GCN degree count,
DimeNet's per-graph energy) goes through it as ``[E, 1]``.  DimeNet's
fixed-fanout triplet aggregation stays a reshape-reduce, as in the
reference: it is no segment sum.

Batch format (tensors padded to static shapes, masks carry validity):
    node_feat [N, F]      pos [N, 3] (geometric models)
    edge_src/edge_dst [E] int32 (directed, both directions present)
    edge_mask [E] bool    node_mask [N] bool
    graph_id [N] int32    (batched small graphs; readout segment)
    labels                [N] (node classification) or [B] (graph tasks)
    triplet_kj/ji [T]     (DimeNet: indices into the edge array)

Parameters are plain dicts and lists under the reference's key names;
``params_from_numpy`` / ``params_to_numpy`` carry a reference pytree (as
numpy) across.  Initializers draw from an explicit ``torch.Generator`` on
the device the parameters live on; its numbers are not ``jax.random``'s.
Where the reference's ``jnp.maximum`` / ``jnp.clip`` can tie, this module
uses ``torch.maximum`` / ``torch.minimum``, which split a tie's gradient
evenly as they do (``torch.clamp`` would give it all to the input).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import GNNConfig
from ..kernels import ops as kernel_ops
from .layers import (batch_to_torch, dense_init, params_from_numpy,  # noqa: F401
                     params_to_numpy)

F32 = torch.float32


def _segment_sum(data, seg, num):  # centralized so the kernel swap is one line
    seg = seg.to(torch.int32)
    if data.dim() == 1:
        return kernel_ops.segment_sum(data[:, None], seg, num)[:, 0]
    return kernel_ops.segment_sum(data, seg, num)


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def _maximum(x, value: float):
    """``jnp.maximum(x, value)``: a tie's gradient split evenly."""
    return torch.maximum(x, _const(x, value))


def _clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)`` (minimum of maximum): ties split evenly."""
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


def _norm(x, keepdim: bool = False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _mlp_init(gen, dims):
    return {"w": [dense_init(gen, dims[i], dims[i + 1]) for i in range(len(dims) - 1)],
            "b": [torch.zeros((dims[i + 1],), dtype=F32, device=gen.device)
                  for i in range(len(dims) - 1)]}


def _mlp_apply(p, x, act=torch.relu, final_act=False):
    n = len(p["w"])
    for i in range(n):
        x = x @ p["w"][i] + p["b"][i]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def _ln_init(d, device):
    return {"g": torch.ones((d,), dtype=F32, device=device),
            "b": torch.zeros((d,), dtype=F32, device=device)}


def _ln(p, x, eps=1e-6):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, correction=0)   # biased, as jnp.var
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


# ---------------------------------------------------------------------------
# GCN (Kipf & Welling) — SpMM regime
# ---------------------------------------------------------------------------

def gcn_init(cfg: GNNConfig, gen: torch.Generator, d_in: int) -> dict:
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"w": [dense_init(gen, dims[i], dims[i + 1]) for i in range(cfg.n_layers)]}


def gcn_forward(cfg: GNNConfig, params: dict, batch: dict) -> torch.Tensor:
    x = batch["node_feat"].to(F32)
    src, dst = batch["edge_src"].long(), batch["edge_dst"]
    emask = batch["edge_mask"]
    n = x.shape[0]
    deg = _segment_sum(emask.to(F32), dst, n) + 1.0  # +1: self loop
    dst_l = dst.long()
    if cfg.norm_sym:
        norm = torch.rsqrt(deg[src]) * torch.rsqrt(deg[dst_l])
    else:
        norm = 1.0 / deg[dst_l]
    norm = torch.where(emask, norm, 0.0)
    self_norm = 1.0 / deg

    for i, w in enumerate(params["w"]):
        h = x @ w
        agg = _segment_sum(h[src] * norm[:, None], dst, n)
        x = agg + h * self_norm[:, None]
        if i < len(params["w"]) - 1:
            x = torch.relu(x)
    return x  # node logits


# ---------------------------------------------------------------------------
# GIN (Xu et al.) — sum aggregation + eps
# ---------------------------------------------------------------------------

def gin_init(cfg: GNNConfig, gen: torch.Generator, d_in: int) -> dict:
    mlps, dims = [], d_in
    for _ in range(cfg.n_layers):
        mlps.append(_mlp_init(gen, [dims, cfg.d_hidden, cfg.d_hidden]))
        dims = cfg.d_hidden
    return {"mlps": mlps,
            "eps": torch.zeros((cfg.n_layers,), dtype=F32, device=gen.device),
            "head": dense_init(gen, cfg.d_hidden, cfg.n_classes)}


def gin_forward(cfg: GNNConfig, params: dict, batch: dict) -> torch.Tensor:
    x = batch["node_feat"].to(F32)
    src, dst = batch["edge_src"].long(), batch["edge_dst"]
    w = batch["edge_mask"].to(F32)[:, None]
    n = x.shape[0]
    for i, mlp in enumerate(params["mlps"]):
        agg = _segment_sum(x[src] * w, dst, n)
        eps = params["eps"][i] if cfg.eps_learnable else 0.0
        x = _mlp_apply(mlp, (1.0 + eps) * x + agg, final_act=True)
    return x  # node embeddings; heads applied by loss fns


def gin_graph_logits(cfg: GNNConfig, params: dict, batch: dict,
                     n_graphs: int) -> torch.Tensor:
    h = gin_forward(cfg, params, batch)
    pooled = _segment_sum(h * batch["node_mask"].to(F32)[:, None],
                          batch["graph_id"], n_graphs)
    return pooled @ params["head"]


def gin_node_logits(cfg: GNNConfig, params: dict, batch: dict) -> torch.Tensor:
    return gin_forward(cfg, params, batch) @ params["head"]


# ---------------------------------------------------------------------------
# MeshGraphNet (Pfaff et al.) — encode-process-decode, edge+node MLPs
# ---------------------------------------------------------------------------

def mgn_init(cfg: GNNConfig, gen: torch.Generator, d_in: int,
             d_edge_in: int = 4, d_out: int = 3) -> dict:
    h = cfg.d_hidden
    mlp_dims = [h] * cfg.mlp_layers + [h]
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            "edge": _mlp_init(gen, [3 * h] + mlp_dims),
            "edge_ln": _ln_init(h, gen.device),
            "node": _mlp_init(gen, [2 * h] + mlp_dims),
            "node_ln": _ln_init(h, gen.device),
        })
    return {
        "node_enc": _mlp_init(gen, [d_in] + mlp_dims),
        "edge_enc": _mlp_init(gen, [d_edge_in] + mlp_dims),
        "decoder": _mlp_init(gen, [h] * cfg.mlp_layers + [d_out]),
        "blocks": blocks,
    }


def mgn_forward(cfg: GNNConfig, params: dict, batch: dict) -> torch.Tensor:
    src, dst = batch["edge_src"].long(), batch["edge_dst"]
    emask = batch["edge_mask"].to(F32)[:, None]
    n = batch["node_feat"].shape[0]
    pos = batch["pos"].to(F32)
    rel = pos[src] - pos[dst.long()]
    dist = _norm(rel + 1e-9, keepdim=True)
    e = _mlp_apply(params["edge_enc"], torch.cat([rel, dist], -1))
    h = _mlp_apply(params["node_enc"], batch["node_feat"].to(F32))
    for blk in params["blocks"]:
        e = e + _ln(blk["edge_ln"],
                    _mlp_apply(blk["edge"], torch.cat([e, h[src], h[dst.long()]], -1)))
        agg = _segment_sum(e * emask, dst, n)
        h = h + _ln(blk["node_ln"],
                    _mlp_apply(blk["node"], torch.cat([h, agg], -1)))
    return _mlp_apply(params["decoder"], h)  # per-node regression


# ---------------------------------------------------------------------------
# DimeNet (Gasteiger et al.) — directional MP via triplet gather
# ---------------------------------------------------------------------------

def _rbf(d, n_radial: int, cutoff: float = 5.0):
    """sin(n·pi·d/c)/d radial basis with smooth envelope."""
    d = _maximum(d, 1e-6)
    n = torch.arange(1, n_radial + 1, dtype=F32, device=d.device)
    u = _clip(d / cutoff, 0.0, 1.0)
    env = 1.0 - 3.0 * u**2 + 2.0 * u**3
    return (math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * u[..., None])
            / d[..., None] * env[..., None])


def _sbf(d, angle, n_spherical: int, n_radial: int, cutoff: float = 5.0):
    """Angular x radial product basis (the reference's structural stand-in
    for Bessel/Legendre products; same triplet-gather dataflow)."""
    rad = _rbf(d, n_radial, cutoff)                          # [T, R]
    l = torch.arange(n_spherical, dtype=F32, device=d.device)
    ang = torch.cos(l * angle[..., None])                    # [T, S]
    return (ang[..., :, None] * rad[..., None, :]).reshape(d.shape[0], -1)  # [T, S*R]


def dimenet_init(cfg: GNNConfig, gen: torch.Generator, d_in: int) -> dict:
    h = cfg.d_hidden
    sr = cfg.n_spherical * cfg.n_radial
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            "msg": _mlp_init(gen, [h, h, h]),
            "down": dense_init(gen, h, cfg.n_bilinear),
            "bilinear": torch.randn((sr, cfg.n_bilinear, h), generator=gen,
                                    device=gen.device, dtype=F32) * 0.05,
            "out": _mlp_init(gen, [h, h, h]),
        })
    return {
        "node_emb": dense_init(gen, d_in, h),
        "edge_emb": _mlp_init(gen, [2 * h + cfg.n_radial, h, h]),
        "out_node": _mlp_init(gen, [h, h, 1]),
        "rbf_proj": dense_init(gen, cfg.n_radial, h),
        "blocks": blocks,
    }


def dimenet_forward(cfg: GNNConfig, params: dict, batch: dict) -> torch.Tensor:
    """Returns per-node scalar contributions [N] (energy model)."""
    src, dst = batch["edge_src"].long(), batch["edge_dst"]
    dst_l = dst.long()
    emask = batch["edge_mask"].to(F32)
    n = batch["node_feat"].shape[0]
    n_edges = src.shape[0]
    pos = batch["pos"].to(F32)

    d = _norm(pos[src] - pos[dst_l] + 1e-9)
    rbf = _rbf(d, cfg.n_radial) * emask[:, None]

    hn = batch["node_feat"].to(F32) @ params["node_emb"]
    m = _mlp_apply(params["edge_emb"],
                   torch.cat([hn[src], hn[dst_l], rbf], -1))        # [E, H]

    # triplets: edge kj feeds edge ji through the angle at node j
    t_kj, t_ji = batch["triplet_kj"].long(), batch["triplet_ji"]
    tmask = batch["triplet_mask"].to(F32)
    n_trip = t_kj.shape[0]
    # Fixed-fanout layout (the sampler pads to exactly F slots per target
    # edge, t_ji[i] == i // F): the triplet->edge aggregation is a static
    # reshape-reduce, not a scatter, as in the reference.
    fixed_fanout = n_trip % n_edges == 0
    fan = n_trip // n_edges if fixed_fanout else 0
    t_ji_l = t_ji.long()
    v1 = pos[src[t_kj]] - pos[dst_l[t_kj]]
    v2 = pos[dst_l[t_ji_l]] - pos[src[t_ji_l]]
    cosang = torch.sum(v1 * v2, -1) / (_norm(v1 + 1e-9) * _norm(v2 + 1e-9))
    angle = torch.arccos(_clip(cosang, -1.0 + 1e-6, 1.0 - 1e-6))
    sbf = _sbf(d[t_kj], angle, cfg.n_spherical, cfg.n_radial) * tmask[:, None]

    rbf_h = rbf @ params["rbf_proj"]
    node_out = torch.zeros((n,), dtype=F32, device=pos.device)
    for blk in params["blocks"]:
        # project THEN gather: the triplet gather (and its backward) moves
        # n_bilinear columns instead of d_hidden, as in the reference
        mk = (m @ blk["down"])[t_kj]                                   # [T, B]
        mixed = torch.einsum("ts,tb,sbh->th", sbf, mk, blk["bilinear"])  # [T, H]
        mixed = mixed * tmask[:, None]
        if fixed_fanout:
            agg = torch.sum(mixed.reshape(n_edges, fan, -1), dim=1)
        else:
            agg = _segment_sum(mixed, t_ji, n_edges)
        m = m + _mlp_apply(blk["msg"], m * rbf_h + agg)
        per_edge = _mlp_apply(blk["out"], m) * emask[:, None]
        node_out = node_out + _mlp_apply(params["out_node"],
                                         _segment_sum(per_edge, dst, n))[:, 0]
    return node_out


# ---------------------------------------------------------------------------
# dispatch table + losses
# ---------------------------------------------------------------------------

def init_params(cfg: GNNConfig, gen: torch.Generator, d_in: int) -> dict:
    """Random parameters drawn from ``gen``, on ``gen.device``."""
    if cfg.model == "gcn":
        return gcn_init(cfg, gen, d_in)
    if cfg.model == "gin":
        return gin_init(cfg, gen, d_in)
    if cfg.model == "meshgraphnet":
        return mgn_init(cfg, gen, d_in)
    if cfg.model == "dimenet":
        return dimenet_init(cfg, gen, d_in)
    raise ValueError(cfg.model)


def loss_fn(cfg: GNNConfig, params: dict, batch: dict, *,
            n_graphs: int = 0) -> torch.Tensor:
    nmask = batch["node_mask"].to(F32)
    if cfg.model == "gcn":
        logits = gcn_forward(cfg, params, batch)
        return _masked_xent(logits, batch["labels"], nmask)
    if cfg.model == "gin":
        if n_graphs:
            logits = gin_graph_logits(cfg, params, batch, n_graphs)
            return _xent(logits, batch["graph_labels"])
        logits = gin_node_logits(cfg, params, batch)
        return _masked_xent(logits, batch["labels"], nmask)
    if cfg.model == "meshgraphnet":
        pred = mgn_forward(cfg, params, batch)
        err = torch.sum(torch.square(pred - batch["targets"]), -1)
        return torch.sum(err * nmask) / _maximum(torch.sum(nmask), 1.0)
    if cfg.model == "dimenet":
        node_e = dimenet_forward(cfg, params, batch) * nmask
        if n_graphs:
            energy = _segment_sum(node_e, batch["graph_id"], n_graphs)
            return torch.mean(torch.square(energy - batch["graph_targets"]))
        return torch.mean(torch.square(torch.sum(node_e) - batch["energy_target"]))
    raise ValueError(cfg.model)


def _gold(logits, labels):
    """``jnp.take_along_axis(logits, labels[:, None], -1)[:, 0]``: a
    negative label counts from the end; a label outside ``[-C, C)`` reads
    NaN (jax's fill mode) and passes no gradient, where ``torch.gather``
    would raise on the CPU and fault on the card."""
    c = logits.shape[-1]
    idx = labels.long()
    idx = torch.where(idx < 0, idx + c, idx)
    ok = (idx >= 0) & (idx < c)
    gold = torch.gather(logits, -1, torch.where(ok, idx, 0)[:, None])[:, 0]
    return torch.where(ok, gold, _const(gold, math.nan))


def _xent(logits, labels):
    lse = torch.logsumexp(logits, -1)
    return torch.mean(lse - _gold(logits, labels))


def _masked_xent(logits, labels, mask):
    lse = torch.logsumexp(logits, -1)
    return (torch.sum((lse - _gold(logits, labels)) * mask)
            / _maximum(torch.sum(mask), 1.0))
