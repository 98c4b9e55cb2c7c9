"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B family]: dense 28L d1024 16H GQA(kv=8)
ff3072 v151936, qk_norm. Full attention => long_500k skipped."""
from .base import ArchConfig, LMConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="qwen3-0.6b",
    family="lm",
    model=LMConfig(
        name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16, n_kv=8,
        d_ff=3072, vocab=151936, head_dim=128, mlp="swiglu", qk_norm=True,
        rope_theta=1e6, tie_embeddings=True),
    shapes=LM_SHAPES,
    smoke=LMConfig(
        name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=512, head_dim=16, mlp="swiglu", qk_norm=True,
        tie_embeddings=True),
)
