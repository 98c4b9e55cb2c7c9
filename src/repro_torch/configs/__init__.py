"""Workload configurations of the port (copies of ``repro.configs``).

``REGISTRY`` holds all ten architectures of the reference: the LM family,
the GNN family (``gcn-cora``, ``gin-tu``, ``meshgraphnet``, ``dimenet``)
and the recsys one (``xdeepfm``); ``--arch <id>`` resolves here.  The LM
family includes the two MoE archs (``mixtral-8x7b``,
``llama4-scout-17b-a16e``).
"""
from . import (dimenet, gcn_cora, gemma_2b, gin_tu, llama4_scout_17b_a16e,
               meshgraphnet, mixtral_8x7b, qwen3_0_6b, starcoder2_7b, xdeepfm)
from .base import (ArchConfig, GNNConfig, GNN_SHAPES, LMConfig, LM_SHAPES,
                   RECSYS_SHAPES, RecsysConfig, ShapeCell)

_MODULES = [mixtral_8x7b, llama4_scout_17b_a16e, starcoder2_7b, qwen3_0_6b,
            gemma_2b, meshgraphnet, gcn_cora, dimenet, gin_tu, xdeepfm]

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.arch_id: m.CONFIG for m in _MODULES}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells():
    """All (arch, cell) pairs, including skip bookkeeping."""
    out = []
    for cfg in REGISTRY.values():
        for cell in cfg.cells():
            out.append((cfg, cell))
    return out
