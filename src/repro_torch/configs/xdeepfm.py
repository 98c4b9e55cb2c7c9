"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed 10, CIN 200-200-200,
MLP 400-400. Embedding tables are the hot path (row-sharded on "model")."""
from .base import ArchConfig, RecsysConfig, RECSYS_SHAPES

CONFIG = ArchConfig(
    arch_id="xdeepfm",
    family="recsys",
    model=RecsysConfig(name="xdeepfm", n_sparse=39, embed_dim=10,
                       cin_layers=(200, 200, 200), mlp_dims=(400, 400),
                       vocab_per_field=1_000_000, n_multihot=4, bag_size=8),
    shapes=RECSYS_SHAPES,
    smoke=RecsysConfig(name="xdeepfm-smoke", n_sparse=8, embed_dim=6,
                       cin_layers=(12, 12), mlp_dims=(32,),
                       vocab_per_field=1000, n_multihot=2, bag_size=4),
    notes="39M-row fused table; EmbeddingBag = take + segment_sum.",
)
