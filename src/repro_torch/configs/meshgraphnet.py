"""meshgraphnet [arXiv:2010.03409]: 15 MP blocks, hidden 128, sum aggregator,
2-layer MLPs. Truss maintenance applies (gnn family) — see DESIGN.md §5."""
from .base import ArchConfig, GNNConfig, GNN_SHAPES

CONFIG = ArchConfig(
    arch_id="meshgraphnet",
    family="gnn",
    model=GNNConfig(name="meshgraphnet", model="meshgraphnet",
                    n_layers=15, d_hidden=128, aggregator="sum", mlp_layers=2),
    shapes=GNN_SHAPES,
    smoke=GNNConfig(name="mgn-smoke", model="meshgraphnet",
                    n_layers=3, d_hidden=32, aggregator="sum", mlp_layers=2),
)
