"""Config schema: architecture + input-shape cells (a copy of
``repro/configs/base.py``, so the port imports nothing of ``repro``).

Every architecture gets one ``<id>.py`` exporting ``CONFIG``; ``smoke`` is
a reduced same-family config for the CPU tests.  ``family`` stays a field so
that ``launch/serve.py`` dispatches as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                 # train | prefill | decode | long_decode |
                              # full_graph | minibatch | batched_graphs |
                              # train_batch | serve | retrieval
    params: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __hash__(self):
        return hash((self.name, self.kind, tuple(sorted(self.params.items()))))

    def __eq__(self, other):
        return (self.name, self.kind, self.params) == (other.name, other.kind, other.params)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    norm: str = "rmsnorm"
    mlp: str = "swiglu"           # swiglu | geglu | gelu
    qk_norm: bool = False
    window: int | None = None     # sliding-window attention (Mixtral)
    moe_experts: int = 0          # 0 => dense
    moe_top_k: int = 2
    moe_capacity: float = 1.25    # GShard capacity factor
    rope_theta: float = 1e6
    tie_embeddings: bool = False

    @property
    def sub_quadratic(self) -> bool:
        return self.window is not None


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str                    # gcn | gin | meshgraphnet | dimenet
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"
    mlp_layers: int = 2
    eps_learnable: bool = False   # GIN
    norm_sym: bool = False        # GCN symmetric normalization
    n_bilinear: int = 8           # DimeNet
    n_spherical: int = 7
    n_radial: int = 6
    n_classes: int = 16
    d_in: int = 0                 # set per shape if 0


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int
    embed_dim: int
    cin_layers: tuple[int, ...]
    mlp_dims: tuple[int, ...]
    vocab_per_field: int = 100_000
    n_multihot: int = 4           # fields exercising the embedding-bag path
    bag_size: int = 8
    n_dense: int = 13


# The LM family's 4 assigned shape cells
LM_SHAPES = (
    ShapeCell("train_4k", "train", {"seq": 4096, "batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
    ShapeCell("decode_32k", "decode", {"seq": 32768, "batch": 128}),
    ShapeCell("long_500k", "long_decode", {"seq": 524288, "batch": 1}),
)

GNN_SHAPES = (
    ShapeCell("full_graph_sm", "full_graph",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeCell("minibatch_lg", "minibatch",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout": (15, 10), "d_feat": 602}),
    ShapeCell("ogb_products", "full_graph",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeCell("molecule", "batched_graphs",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16}),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train_batch", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                   # lm | gnn | recsys
    model: Any                    # LMConfig | GNNConfig | RecsysConfig
    shapes: tuple[ShapeCell, ...]
    smoke: Any                    # reduced same-family model config
    notes: str = ""

    def cells(self):
        for s in self.shapes:
            # long_500k requires sub-quadratic attention (assignment rule)
            if (s.kind == "long_decode" and self.family == "lm"
                    and not self.model.sub_quadratic):
                continue
            yield s

    def skipped_cells(self):
        for s in self.shapes:
            if (s.kind == "long_decode" and self.family == "lm"
                    and not self.model.sub_quadratic):
                yield s
