"""Models of the port: the dense LM family (``layers``, ``transformer``),
the GNN family (``gnn``: GCN, GIN, MeshGraphNet, DimeNet) and the recsys
family (``recsys``: xDeepFM)."""
from . import gnn, layers, recsys, transformer

__all__ = ["gnn", "layers", "recsys", "transformer"]
