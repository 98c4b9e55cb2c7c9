"""Workload configurations of the port (copies of ``repro.configs``).

``REGISTRY`` holds the LM architectures and the recsys one (``xdeepfm``);
``--arch <id>`` resolves here.  The MoE LMs (``mixtral-8x7b``,
``llama4-scout-17b-a16e``) are registered but raise ``NotImplementedError``
when their model is built (MoE is a later slice of the port); the GNN
configs join with the port's training slice.
"""
from . import (gemma_2b, llama4_scout_17b_a16e, mixtral_8x7b, qwen3_0_6b,
               starcoder2_7b, xdeepfm)
from .base import (ArchConfig, LMConfig, LM_SHAPES, RECSYS_SHAPES,
                   RecsysConfig, ShapeCell)

_MODULES = [mixtral_8x7b, llama4_scout_17b_a16e, starcoder2_7b, qwen3_0_6b,
            gemma_2b, xdeepfm]

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.arch_id: m.CONFIG for m in _MODULES}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
