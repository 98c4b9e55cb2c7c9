"""Graph batching utilities: GNN batch construction, fanout neighbor
sampling (minibatch_lg), triplet lists (DimeNet), batched small graphs.

A copy of ``repro/data/sampler.py`` (numpy only), so the port imports
nothing of ``repro``; at the same seed every function gives the same arrays
as the reference.  All outputs are padded to static shapes with masks:
padding edges point at the last padded node (``pn - 1``) with a false
``edge_mask``.
"""
from __future__ import annotations

import numpy as np


class CSRGraph:
    """Host-side CSR used by the neighbor sampler."""

    def __init__(self, n_nodes: int, edges: np.ndarray):
        self.n = n_nodes
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.argsort(src, kind="stable")
        self.src_sorted = src[order]
        self.adj = dst[order]
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        counts = np.bincount(src, minlength=n_nodes)
        np.cumsum(counts, out=self.indptr[1:])

    def neighbors(self, v: int) -> np.ndarray:
        return self.adj[self.indptr[v]:self.indptr[v + 1]]


def fanout_sample(csr: CSRGraph, seeds: np.ndarray, fanout: tuple[int, ...],
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GraphSAGE-style layered sampling.  Returns (nodes, src, dst) where
    nodes[0:len(seeds)] are the seeds and src/dst are directed message edges
    (neighbor -> target) in *local* indices."""
    rng = np.random.default_rng(seed)
    node_index: dict[int, int] = {int(s): i for i, s in enumerate(seeds)}
    nodes = [int(s) for s in seeds]
    src_l, dst_l = [], []
    frontier = list(seeds)
    for f in fanout:
        nxt = []
        for v in frontier:
            nbrs = csr.neighbors(int(v))
            if len(nbrs) == 0:
                continue
            pick = nbrs if len(nbrs) <= f else rng.choice(nbrs, size=f, replace=False)
            for u in pick:
                u = int(u)
                if u not in node_index:
                    node_index[u] = len(nodes)
                    nodes.append(u)
                src_l.append(node_index[u])
                dst_l.append(node_index[int(v)])
                nxt.append(u)
        frontier = nxt
    return (np.asarray(nodes, np.int64),
            np.asarray(src_l, np.int64), np.asarray(dst_l, np.int64))


def build_triplets(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   max_per_edge: int = 8, seed: int = 0):
    """DimeNet triplet lists: pairs (edge kj, edge ji) sharing node j, capped
    per target edge (hub-node blowup control — DESIGN.md)."""
    rng = np.random.default_rng(seed)
    in_edges: list[list[int]] = [[] for _ in range(n_nodes)]
    for e, d in enumerate(dst):
        in_edges[int(d)].append(e)
    t_kj, t_ji = [], []
    for e_ji in range(len(src)):
        j = int(src[e_ji])
        cands = [e for e in in_edges[j] if int(src[e]) != int(dst[e_ji])]
        if len(cands) > max_per_edge:
            cands = list(rng.choice(cands, size=max_per_edge, replace=False))
        for e_kj in cands:
            t_kj.append(e_kj)
            t_ji.append(e_ji)
    return np.asarray(t_kj, np.int64), np.asarray(t_ji, np.int64)


def build_triplets_fixed(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                         fanout: int = 8, seed: int = 0):
    """Fixed-fanout triplet layout: exactly ``fanout`` slots per target edge,
    slot i targets edge i // fanout (t_ji is the implicit arange-repeat).

    This makes the triplet->edge aggregation a shard-aligned reshape-reduce
    instead of a data-dependent scatter (see models/gnn.dimenet_forward) —
    the distributed-memory win measured in EXPERIMENTS §Perf."""
    rng = np.random.default_rng(seed)
    in_edges: list[list[int]] = [[] for _ in range(n_nodes)]
    for e, d in enumerate(dst):
        in_edges[int(d)].append(e)
    e2 = len(src)
    t_kj = np.zeros((e2, fanout), np.int64)
    mask = np.zeros((e2, fanout), bool)
    for e_ji in range(e2):
        j = int(src[e_ji])
        cands = [e for e in in_edges[j] if int(src[e]) != int(dst[e_ji])]
        if len(cands) > fanout:
            cands = list(rng.choice(cands, size=fanout, replace=False))
        t_kj[e_ji, :len(cands)] = cands
        mask[e_ji, :len(cands)] = True
    t_ji = np.repeat(np.arange(e2, dtype=np.int64), fanout)
    return t_kj.reshape(-1), t_ji, mask.reshape(-1)


def pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    if len(x) >= n:
        return x[:n]
    pad = np.full((n - len(x),) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad])


def make_gnn_batch(edges: np.ndarray, n_nodes: int, d_feat: int, *,
                   n_classes: int = 16, with_pos: bool = False,
                   with_triplets: bool = False, max_triplets_per_edge: int = 8,
                   pad_nodes: int | None = None, pad_edges: int | None = None,
                   graph_id: np.ndarray | None = None, seed: int = 0) -> dict:
    """Full padded batch from an undirected edge list."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    pn = pad_nodes or n_nodes
    pe = pad_edges or len(src)
    batch = {
        "node_feat": pad_to(rng.normal(size=(n_nodes, d_feat)).astype(np.float32), pn),
        "edge_src": pad_to(src.astype(np.int32), pe, fill=pn - 1),
        "edge_dst": pad_to(dst.astype(np.int32), pe, fill=pn - 1),
        "edge_mask": pad_to(np.ones(len(src), bool), pe, fill=False),
        "node_mask": pad_to(np.ones(n_nodes, bool), pn, fill=False),
        "labels": pad_to(rng.integers(0, n_classes, size=n_nodes).astype(np.int32), pn),
        "targets": pad_to(rng.normal(size=(n_nodes, 3)).astype(np.float32), pn),
        "graph_id": pad_to((graph_id if graph_id is not None
                            else np.zeros(n_nodes)).astype(np.int32), pn),
    }
    if with_pos:
        batch["pos"] = pad_to(rng.normal(size=(n_nodes, 3)).astype(np.float32), pn)
    if with_triplets:
        t_kj, t_ji, tmask = build_triplets_fixed(
            src, dst, n_nodes, fanout=max_triplets_per_edge, seed=seed)
        # pad to the (padded) edge count so the fixed-fanout reshape holds
        pt = pe * max_triplets_per_edge
        batch["triplet_kj"] = pad_to(t_kj.astype(np.int32), pt, fill=0)
        batch["triplet_ji"] = pad_to(t_ji.astype(np.int32), pt, fill=0)
        batch["triplet_mask"] = pad_to(tmask, pt, fill=False)
        batch["energy_target"] = np.float32(0.0)
    return batch


def make_batched_graphs(n_graphs: int, nodes_per: int, edges_per: int,
                        d_feat: int, n_classes: int = 16, seed: int = 0) -> dict:
    """`molecule` cell: many small graphs flattened with graph_id readout."""
    rng = np.random.default_rng(seed)
    all_edges, gid = [], []
    for g in range(n_graphs):
        base = g * nodes_per
        seen = set()
        while len(seen) < edges_per:
            a, b = rng.integers(0, nodes_per, size=2)
            if a != b:
                seen.add((min(a, b) + base, max(a, b) + base))
        all_edges += sorted(seen)
        gid += [g] * nodes_per
    edges = np.asarray(all_edges, np.int64)
    n = n_graphs * nodes_per
    batch = make_gnn_batch(edges, n, d_feat, with_pos=True, with_triplets=True,
                           graph_id=np.asarray(gid), seed=seed)
    batch["graph_labels"] = rng.integers(0, n_classes, size=n_graphs).astype(np.int32)
    batch["graph_targets"] = rng.normal(size=(n_graphs,)).astype(np.float32)
    return batch
