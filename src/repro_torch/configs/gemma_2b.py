"""gemma-2b [arXiv:2403.08295]: dense 18L d2048 8H MQA(kv=1) ff16384 v256000,
GeGLU, head_dim=256. Full attention => long_500k skipped."""
from .base import ArchConfig, LMConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="gemma-2b",
    family="lm",
    model=LMConfig(
        name="gemma-2b", n_layers=18, d_model=2048, n_heads=8, n_kv=1,
        d_ff=16384, vocab=256000, head_dim=256, mlp="geglu",
        rope_theta=1e4, tie_embeddings=True),
    shapes=LM_SHAPES,
    smoke=LMConfig(
        name="gemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=1,
        d_ff=256, vocab=512, head_dim=32, mlp="geglu", tie_embeddings=True),
)
