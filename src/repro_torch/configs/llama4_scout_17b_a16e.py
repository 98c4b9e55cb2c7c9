"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
48L d5120 40H GQA(kv=8) ff8192 v202048, MoE 16 experts top-1.
Modality early-fusion is out of scope for the assigned backbone (LM tokens
only, per the assignment's frontend-stub rule); attention is full/quadratic
as assigned => long_500k skipped (DESIGN.md §5)."""
from .base import ArchConfig, LMConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="llama4-scout-17b-a16e",
    family="lm",
    model=LMConfig(
        name="llama4-scout", n_layers=48, d_model=5120, n_heads=40, n_kv=8,
        d_ff=8192, vocab=202048, head_dim=128, mlp="swiglu",
        moe_experts=16, moe_top_k=1, rope_theta=5e5),
    shapes=LM_SHAPES,
    smoke=LMConfig(
        name="llama4-smoke", n_layers=2, d_model=128, n_heads=4, n_kv=2,
        d_ff=192, vocab=512, head_dim=32, mlp="swiglu",
        moe_experts=8, moe_top_k=1),
    notes="16 experts divide the 16-way model axis exactly => EP sharding.",
)
