"""gin-tu [arXiv:1810.00826]: 5 layers, hidden 64, sum aggregator,
learnable eps; graph classification on the molecule cell."""
from .base import ArchConfig, GNNConfig, GNN_SHAPES

CONFIG = ArchConfig(
    arch_id="gin-tu",
    family="gnn",
    model=GNNConfig(name="gin-tu", model="gin", n_layers=5, d_hidden=64,
                    aggregator="sum", eps_learnable=True),
    shapes=GNN_SHAPES,
    smoke=GNNConfig(name="gin-smoke", model="gin", n_layers=2, d_hidden=16,
                    aggregator="sum", eps_learnable=True),
)
