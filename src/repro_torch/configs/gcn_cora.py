"""gcn-cora [arXiv:1609.02907]: 2 layers, hidden 16, mean/symmetric norm."""
from .base import ArchConfig, GNNConfig, GNN_SHAPES

CONFIG = ArchConfig(
    arch_id="gcn-cora",
    family="gnn",
    model=GNNConfig(name="gcn-cora", model="gcn", n_layers=2, d_hidden=16,
                    aggregator="mean", norm_sym=True, n_classes=7),
    shapes=GNN_SHAPES,
    smoke=GNNConfig(name="gcn-smoke", model="gcn", n_layers=2, d_hidden=8,
                    aggregator="mean", norm_sym=True, n_classes=7),
)
