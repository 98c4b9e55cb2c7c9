"""mixtral-8x7b [arXiv:2401.04088]: 32L d4096 32H GQA(kv=8) ff14336 v32000,
MoE 8 experts top-2, sliding-window attention (window 4096) => runs long_500k."""
from .base import ArchConfig, LMConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="mixtral-8x7b",
    family="lm",
    model=LMConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32, n_kv=8,
        d_ff=14336, vocab=32000, head_dim=128, mlp="swiglu",
        moe_experts=8, moe_top_k=2, window=4096, rope_theta=1e6),
    shapes=LM_SHAPES,
    smoke=LMConfig(
        name="mixtral-smoke", n_layers=2, d_model=128, n_heads=4, n_kv=2,
        d_ff=256, vocab=512, head_dim=32, mlp="swiglu",
        moe_experts=4, moe_top_k=2, window=64),
    notes="SWA => sub-quadratic; ring-buffer KV cache for decode/long cells.",
)
