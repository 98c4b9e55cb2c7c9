"""dimenet [arXiv:2003.03123]: 6 interaction blocks, hidden 128, bilinear 8,
7 spherical x 6 radial basis; triplet-gather kernel regime."""
from .base import ArchConfig, GNNConfig, GNN_SHAPES

CONFIG = ArchConfig(
    arch_id="dimenet",
    family="gnn",
    model=GNNConfig(name="dimenet", model="dimenet", n_layers=6, d_hidden=128,
                    n_bilinear=8, n_spherical=7, n_radial=6),
    shapes=GNN_SHAPES,
    smoke=GNNConfig(name="dimenet-smoke", model="dimenet", n_layers=2,
                    d_hidden=32, n_bilinear=4, n_spherical=3, n_radial=4),
    notes="Triplets capped per edge on hub-heavy graphs (DESIGN.md).",
)
