"""Core truss engine of the port: the paper's contribution on PyTorch."""
from .graph import (GraphSpec, GraphState, empty_state, from_edge_list,
                    lookup_edge, insert_edge_struct, delete_edge_struct,
                    apply_edge_batch_struct, triangle_partners, support,
                    support_all, build_bitmap, partial_bitmap,
                    support_all_bitmap, update_bitmap, state_from_numpy,
                    state_to_numpy, bitmap_from_numpy, bitmap_to_numpy,
                    with_mesh, pad_state, shard_state, bitmap_sharding,
                    build_bitmap_partitioned, update_bitmap_partitioned,
                    join_slabs)
from .decomposition import decompose, decompose_and_set, decompose_with_stats
from .distributed import ShardMesh
from .peel import (PeelStats, EMPTY_STATS, chunk_partners, delta_peel, peel,
                   recompute_peel, sharded_peel, stats_dict)
from .maintenance import (insert_edge_maintain, delete_edge_maintain,
                          apply_updates, OP_INSERT, OP_DELETE)
from .batch import batch_maintain
from .index import (TrussIndex, component_labels, representatives,
                    representatives_from_labels)
from .dynamic import DynamicGraph
from . import oracle

__all__ = [
    "GraphSpec", "GraphState", "empty_state", "from_edge_list", "lookup_edge",
    "insert_edge_struct", "delete_edge_struct", "apply_edge_batch_struct",
    "triangle_partners", "support", "support_all", "build_bitmap",
    "partial_bitmap", "support_all_bitmap", "update_bitmap",
    "state_from_numpy", "state_to_numpy", "bitmap_from_numpy",
    "bitmap_to_numpy", "with_mesh", "pad_state", "shard_state",
    "bitmap_sharding", "build_bitmap_partitioned",
    "update_bitmap_partitioned", "join_slabs", "decompose",
    "decompose_and_set", "decompose_with_stats", "ShardMesh", "PeelStats",
    "EMPTY_STATS", "chunk_partners", "delta_peel", "peel", "recompute_peel",
    "sharded_peel", "stats_dict",
    "insert_edge_maintain", "delete_edge_maintain", "apply_updates",
    "OP_INSERT", "OP_DELETE", "batch_maintain", "TrussIndex",
    "component_labels", "representatives", "representatives_from_labels",
    "DynamicGraph", "oracle",
]
