"""starcoder2-7b [arXiv:2402.19173]: dense 32L d4608 36H GQA(kv=4) ff18432
v49152, GQA + RoPE, LayerNorm + GELU MLP (per paper). Full attention as
assigned => long_500k skipped."""
from .base import ArchConfig, LMConfig, LM_SHAPES

CONFIG = ArchConfig(
    arch_id="starcoder2-7b",
    family="lm",
    model=LMConfig(
        name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36, n_kv=4,
        d_ff=18432, vocab=49152, head_dim=128, norm="layernorm", mlp="gelu",
        rope_theta=1e5),
    shapes=LM_SHAPES,
    smoke=LMConfig(
        name="starcoder2-smoke", n_layers=2, d_model=96, n_heads=6, n_kv=2,
        d_ff=384, vocab=512, head_dim=16, norm="layernorm", mlp="gelu"),
)
