"""xDeepFM (Lian et al., KDD'18), port of ``repro/models/recsys.py``: sparse
embedding tables + CIN + deep MLP, for serving and training.

Tables are one fused ``[n_sparse · vocab, D]`` matrix, as in the reference.
``embedding_bag`` is the gathered segment sum K4
(``kernels.ops.segment_matmul_gathered``: the ``[NNZ, D]`` row gather never
exists on the card), its mean fused into the same launch; the multi-hot bag
ids are sorted by construction, and ``_field_embeddings`` says so, so
nothing sorts them.  Each CIN layer is K5 (``kernels.ops.cin_layer``).  On
CPU tensors both take their plain versions.  Single-hot fields, the wide
term and the retrieval candidates stay plain gathers (``jnp.take`` in the
reference).

``_field_embeddings``, ``_cin``, ``forward`` and ``loss_fn`` are
differentiable: K4's and K5's entries are ``torch.autograd.Function``s
whose backwards are plain PyTorch (``kernels.ref.segment_gathered_vjp_ref``,
a dense table gradient; ``kernels.ref.cin_layer_vjp_ref``, chunked over the
batch), and the plain gathers take autograd's indexing backward, which
sorts its indices on the card, so a step's gradient is the same bits each
time.  ``serve`` and ``retrieval_score`` run under ``torch.no_grad``.

Parameters are a plain dict under the reference's key names (``cin`` and
``mlp`` lists); ``params_from_numpy`` / ``params_to_numpy`` carry a
reference pytree (as numpy) across.  Batches are dicts of tensors under
``ClickStream``'s keys.  Initializers draw from an explicit
``torch.Generator`` on the device the parameters live on; its numbers are
not ``jax.random``'s.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import RecsysConfig
from ..kernels import ops as kernel_ops
from .layers import (batch_to_torch, dense_init, params_from_numpy,  # noqa: F401
                     params_to_numpy)

F32 = torch.float32


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets: torch.Tensor, total_bags: int,
                  mode: str = "sum", ids_sorted: bool = False) -> torch.Tensor:
    """torch.nn.EmbeddingBag semantics from a gathered segment sum: one K4
    call, the mean's divide included.

    indices: int32 ``[NNZ]`` rows into table; offsets: int32 ``[NNZ]`` bag
    id per index -> ``[total_bags, D]``.  ``ids_sorted`` declares the bag
    ids ascending (nothing sorts them)."""
    return kernel_ops.segment_matmul_gathered(
        table, indices, offsets, total_bags, ids_sorted=ids_sorted,
        mean=mode == "mean")


def init_params(cfg: RecsysConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen``, on ``gen.device``."""
    dev = gen.device
    total_rows = cfg.n_sparse * cfg.vocab_per_field
    d = cfg.embed_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=F32)

    p = {
        "table": normal(total_rows, d) * 0.01,
        "linear_w": normal(total_rows) * 0.01,
        "dense_w": dense_init(gen, cfg.n_dense, d),
        "dense_linear": dense_init(gen, cfg.n_dense, 1),
        "bias": torch.zeros((), dtype=F32, device=dev),
    }
    h_prev = m = cfg.n_sparse + 1     # +1: the dense-projected field
    cin = []
    for h in cfg.cin_layers:
        cin.append(normal(h, h_prev, m) * (1.0 / math.sqrt(h_prev * m)))
        h_prev = h
    p["cin"] = cin
    p["cin_out"] = dense_init(gen, sum(cfg.cin_layers), 1)
    dims = [(cfg.n_sparse + 1) * d] + list(cfg.mlp_dims) + [1]
    p["mlp"] = [{"w": dense_init(gen, dims[i], dims[i + 1]),
                 "b": torch.zeros((dims[i + 1],), dtype=F32, device=dev)}
                for i in range(len(dims) - 1)]
    return p


def _field_rows(cfg: RecsysConfig, ids: torch.Tensor,
                first_field: int) -> torch.Tensor:
    """Fused-table rows of per-field ids ``[B, n_fields, ...]`` whose
    fields start at ``first_field`` (int32, as the reference)."""
    n = ids.shape[1]
    off = (torch.arange(first_field, first_field + n, dtype=torch.int32,
                        device=ids.device) * cfg.vocab_per_field)
    return ids + off.reshape((1, n) + (1,) * (ids.dim() - 2))


def multihot_bags(cfg: RecsysConfig, mh: torch.Tensor):
    """The multi-hot embedding bags of ``mh [B, n_multihot, bag]``: fused
    table rows (int32 ``[n_multihot · B · bag]``) and their bag ids, sorted
    by construction.  Bags are field-major (bag ``f · B + b``), so
    consecutive bags read one field's slice of the table (40 MB at
    xdeepfm's 1M rows of 10), which stays in the card's L2 while they run;
    each bag sums the same rows in the same order as batch-major bags."""
    b, n, bag = mh.shape
    rows = _field_rows(cfg, mh, cfg.n_sparse - cfg.n_multihot)
    bag_ids = torch.arange(n * b, dtype=torch.int32,
                           device=mh.device).repeat_interleave(bag)
    return rows.transpose(0, 1).reshape(-1), bag_ids


def _field_embeddings(cfg: RecsysConfig, params: dict,
                      batch: dict) -> torch.Tensor:
    """``[B, n_sparse + 1, D]``: single-hot gathers + embedding-bag
    multi-hot fields (mean) + projected dense features."""
    b = batch["sparse_ids"].shape[0]
    d = cfg.embed_dim
    n_single = cfg.n_sparse - cfg.n_multihot
    single_rows = _field_rows(cfg, batch["sparse_ids"][:, :n_single], 0)
    single = params["table"][single_rows.reshape(-1)].reshape(b, n_single, d)

    mh_rows, bag_ids = multihot_bags(cfg, batch["multihot_ids"])
    multi = embedding_bag(params["table"], mh_rows, bag_ids,
                          b * cfg.n_multihot, mode="mean", ids_sorted=True)
    multi = multi.reshape(cfg.n_multihot, b, d).transpose(0, 1)

    dense = (batch["dense"].to(F32) @ params["dense_w"])[:, None, :]
    return torch.cat([single, multi, dense], dim=1)


def _cin(params: dict, x0: torch.Tensor) -> torch.Tensor:
    """Compressed Interaction Network.  x0: ``[B, M, D]`` -> ``[B,
    sum(H_k)]``; each layer is K5 (relu included)."""
    feats = []
    xk = x0 = x0.contiguous()
    for w in params["cin"]:
        xk = kernel_ops.cin_layer(xk, x0, w)
        feats.append(xk.sum(-1))                     # sum-pool over D
    return torch.cat(feats, dim=-1)


def forward(cfg: RecsysConfig, params: dict, batch: dict) -> torch.Tensor:
    """Click logit ``[B]``."""
    emb = _field_embeddings(cfg, params, batch)      # [B, M, D]
    b = emb.shape[0]

    n_single = cfg.n_sparse - cfg.n_multihot
    rows = _field_rows(cfg, batch["sparse_ids"][:, :n_single], 0)
    lin = params["linear_w"][rows.reshape(-1)].reshape(b, -1).sum(-1)
    lin = lin + (batch["dense"].to(F32) @ params["dense_linear"])[:, 0]

    cin_logit = (_cin(params, emb) @ params["cin_out"])[:, 0]

    h = emb.reshape(b, -1)
    for i, lp in enumerate(params["mlp"]):
        h = h @ lp["w"] + lp["b"]
        if i < len(params["mlp"]) - 1:
            h = torch.relu(h)
    return lin + cin_logit + h[:, 0] + params["bias"]


def loss_fn(cfg: RecsysConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean binary cross-entropy of the click logits."""
    logit = forward(cfg, params, batch)
    y = batch["labels"].to(F32)
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))


@torch.no_grad()
def serve(cfg: RecsysConfig, params: dict, batch: dict) -> torch.Tensor:
    """Click probabilities ``[B]``."""
    return torch.sigmoid(forward(cfg, params, batch))


@torch.no_grad()
def retrieval_score(cfg: RecsysConfig, params: dict, batch: dict,
                    top_k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """Score one query context against ``[n_cand]`` candidate ids of field
    0 — a batched dot against the embedding table slice, never a loop.
    Returns (scores, candidate positions) of the ``top_k``."""
    emb = _field_embeddings(cfg, params, batch)      # [1, M, D]
    u = emb.mean(dim=1)[0]                           # [D] query vector
    items = params["table"][batch["candidate_ids"]]  # [n_cand, D]
    return torch.topk(items @ u, top_k)
