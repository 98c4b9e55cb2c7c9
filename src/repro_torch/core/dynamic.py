"""DynamicGraph — the library's entry point: a host-side wrapper around the
truss engine (PyTorch port of ``repro.core.dynamic``).

Owns capacity management (the arrays are fixed-shape; capacities double and
the state is rebuilt when edge slots or degree headroom run out), strategy
selection (batchUpdate / progressiveUpdate / fused, paper Table 3), the
update-range bookkeeping the index needs, and — for the bitmap support
method — a structural adjacency-bitmap cache updated in place by every
update path instead of being rebuilt on each decompose / re-peel.

``device`` (default ``"cuda"``) is where the state, the bitmap and every
peel live; tests pass ``device="cpu"``.

``mesh=ShardMesh`` makes every peel this wrapper launches (the initial
decomposition, the fused batch re-peel, ``batch_update_then_decompose``)
run over ``mesh[shard_axis]`` — bitwise equal to ``mesh=None``; ``e_cap``
is rounded up so the row blocks stay uniform across regrowth, and the
state lives on the first shard's device (of ``device``'s kind).
``partition="nodes"`` keeps the bitmap cache as one word slab per shard.
The progressive single-update paths (Algorithms 1/2) run no peel and stay
on that device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..obs import metrics as obs_metrics, trace as obs_trace
from . import batch, decomposition, maintenance
from .distributed import lead_device
from .graph import (GraphSpec, GraphState, build_bitmap,
                    build_bitmap_partitioned, from_edge_list, lookup_edge,
                    pad_state, shard_state, update_bitmap,
                    update_bitmap_partitioned, with_mesh)
from .index import TrussIndex
from .peel import EMPTY_STATS

_PROGRESSIVE_N = obs_metrics.counter(
    "truss_progressive_updates_total",
    "single-edge Algorithm-1/2 maintenance operations")
_BITMAP_BYTES = obs_metrics.gauge(
    "truss_bitmap_bytes",
    "resident adjacency-bitmap bytes per device under the spec's bitmap "
    "partition (O(N*W) replicated, O(N*W/S) nodes)")
_STATE_BYTES = obs_metrics.gauge(
    "truss_state_bytes_per_device",
    "resident GraphState bytes per device: row-blocked edge arrays + "
    "replicated node tables + the per-device bitmap slab")


def _state_device(mesh, shard_axis: str, partition: str, device):
    """The state's device: ``device``, or under a mesh its first shard's.
    Raises ``TypeError`` for a mesh that is not a ``ShardMesh`` and
    ``ValueError`` for a partitioned bitmap without a mesh."""
    if mesh is None:
        if partition != "replicated":
            raise ValueError(
                f"partition={partition!r} needs a mesh (the bitmap slabs "
                "live one per device; pass mesh=... or keep 'replicated')")
        return torch.device(device)
    return lead_device(mesh, shard_axis, device)


class DynamicGraph:
    """Mutable truss-maintained graph: owns a ``GraphState``, applies update
    batches (netted, auto progressive/fused), and serves phi/k-truss views."""

    def __init__(self, n_nodes: int, edges=(), d_max: int | None = None,
                 e_cap: int | None = None, support_method: str = "sorted",
                 tracked_ks: tuple[int, ...] = (), mesh=None,
                 shard_axis: str = "shard", partition: str = "replicated",
                 device="cuda"):
        self.device = _state_device(mesh, shard_axis, partition, device)
        edges = np.asarray(edges if isinstance(edges, np.ndarray)
                           else list(edges), dtype=np.int64).reshape(-1, 2)
        deg = (np.bincount(edges.reshape(-1), minlength=n_nodes)
               if edges.size else np.zeros(n_nodes))
        d_max = int(d_max or max(8, int(deg.max(initial=0)) * 2))
        e_cap = int(e_cap or max(16, len(edges) * 2))
        self.mesh = mesh
        self.spec = GraphSpec(n_nodes=n_nodes, d_max=d_max, e_cap=e_cap)
        if mesh is not None:
            # round e_cap up so edge arrays split into uniform row blocks
            self.spec = with_mesh(self.spec, mesh, shard_axis,
                                  partition=partition)
        self.state = self._placed(from_edge_list(self.spec, edges,
                                                 self.device))
        self.support_method = support_method
        self._bitmap = None
        self._set_memory_gauges()
        phi, stats = decomposition.decompose_with_stats(
            self.spec, self.state, support_method, bitmap=self._bitmap_cache(),
            mesh=self.mesh, device=self.device)
        self.state = self.state._replace(phi=phi)
        # every maintenance path records a PeelStats — never None
        self.last_peel_stats = stats
        self.index = TrussIndex(self.spec, tracked_ks)
        # Host mirror of the present-edge set, kept in sync by every update
        # path so batch netting never forces a device->host transfer.
        lo, hi = np.minimum(edges[:, 0], edges[:, 1]), np.maximum(edges[:, 0], edges[:, 1])
        self._present = set(zip(lo.tolist(), hi.tolist()))

    @classmethod
    def from_state(cls, spec: GraphSpec, state: GraphState,
                   support_method: str = "sorted",
                   tracked_ks: tuple[int, ...] = (),
                   mesh=None, shard_axis: str = "shard",
                   partition: str = "replicated",
                   device="cuda") -> "DynamicGraph":
        """Rebuild a wrapper around already-maintained arrays (tensors or
        host arrays, e.g. a restored checkpoint): phi is trusted as-is, no
        re-decomposition.  ``mesh`` re-shards the state onto the mesh,
        padding the edge axis where the stored capacity does not split
        into uniform row blocks; ``partition`` picks the bitmap layout as
        in ``__init__`` (snapshots never store the bitmap)."""
        g = cls.__new__(cls)
        g.device = _state_device(mesh, shard_axis, partition, device)
        g.mesh = mesh
        g.spec = spec
        g.state = GraphState(*(
            (x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.array(x))).to(g.device) for x in state))
        if mesh is not None:
            g.spec = with_mesh(spec, mesh, shard_axis, partition=partition)
            g.state = g._placed(pad_state(spec, g.state, g.spec))
        g.support_method = support_method
        g._bitmap = None
        g._set_memory_gauges()
        g.last_peel_stats = EMPTY_STATS  # phi trusted as-is: no peel ran
        g.index = TrussIndex(g.spec, tracked_ks)
        el = g.edge_list()
        g._present = set(zip(el[:, 0].tolist(), el[:, 1].tolist()))
        return g

    def _placed(self, st: GraphState) -> GraphState:
        """``st`` placed for the mesh (a no-op without one)."""
        return st if self.mesh is None else shard_state(self.spec, st,
                                                        self.mesh)

    # -- bitmap cache --------------------------------------------------------
    def _partitioned(self) -> bool:
        """Whether the cached bitmap is one word slab per shard rather than
        one full copy."""
        return self.spec.partition == "nodes" and self.mesh is not None

    def _set_memory_gauges(self):
        """Publish the spec's per-device memory accounting."""
        _BITMAP_BYTES.set(self.spec.bitmap_bytes_per_device)
        _STATE_BYTES.set(self.spec.state_bytes_per_device)

    def _bitmap_cache(self):
        """Adjacency bitmap of the active edge set (bitmap method only),
        built once and maintained in place by every update path.  Under
        ``partition="nodes"`` it is the list of word slabs, each built
        owner-local on its shard's device — O(N·W/S) a device."""
        if self.support_method != "bitmap":
            return None
        if self._bitmap is None:
            if self._partitioned():
                self._bitmap = build_bitmap_partitioned(
                    self.spec, self.state, self.state.active, self.mesh)
            else:
                self._bitmap = build_bitmap(self.spec, self.state,
                                            self.state.active)
        return self._bitmap

    def _bitmap_apply(self, dels, inss):
        """Fold structural edge changes into the cached bitmap (O(batch)
        scatter; no-op when the cache is cold or the method is sorted).
        Word slabs update owner-local: each takes only its own bits."""
        if self._bitmap is None:
            return
        for pairs, set_bits in ((dels, False), (inss, True)):
            if not len(pairs):
                continue
            arr = torch.as_tensor(np.asarray(pairs, np.int32).reshape(-1, 2),
                                  device=self.device)
            valid = torch.ones((len(arr),), dtype=torch.bool,
                               device=self.device)
            if self._partitioned():
                update_bitmap_partitioned(self.spec, self._bitmap, arr[:, 0],
                                          arr[:, 1], valid, set_bits=set_bits,
                                          mesh=self.mesh)
            else:
                update_bitmap(self.spec, self._bitmap, arr[:, 0], arr[:, 1],
                              valid, set_bits=set_bits)

    # -- capacity ------------------------------------------------------------
    def _ensure_capacity(self, a: int, b: int, inserting: bool):
        if not inserting:
            return
        spec = self.spec
        deg = self.state.deg.cpu().numpy()
        n_edges = int(self.state.active.sum())
        if (n_edges + 1 > spec.e_cap or deg[a] + 1 > spec.d_max
                or deg[b] + 1 > spec.d_max):
            self._grow(extra_edge=(a, b))

    def _grow(self, extra_edge=None, min_d: int = 0, min_e: int = 0):
        """Double capacities and rebuild state (host path, rare)."""
        el = self.edge_list()
        deg = (np.bincount(el.reshape(-1), minlength=self.spec.n_nodes)
               if len(el) else np.zeros(self.spec.n_nodes, np.int64))
        if extra_edge is not None:
            deg[extra_edge[0]] += 1
            deg[extra_edge[1]] += 1
        s = self.spec.n_shards
        new_e = max(self.spec.e_cap * 2, len(el) + 16, min_e + 16)
        new_spec = GraphSpec(
            n_nodes=self.spec.n_nodes,
            d_max=max(self.spec.d_max * 2, int(deg.max(initial=0)) + 4,
                      min_d + 4),
            e_cap=-(-new_e // s) * s,  # keep the shard row blocks uniform
            n_shards=s, shard_axis=self.spec.shard_axis,
            partition=self.spec.partition,
        )
        # carry phi over: from_edge_list keeps el's order as slot order
        act = self.state.active.cpu().numpy()
        phi_old = self.state.phi.cpu().numpy()[act]
        self.spec = new_spec
        self.state = from_edge_list(new_spec, el, self.device)
        phi = np.zeros(new_spec.e_cap, np.int32)
        phi[:len(el)] = phi_old
        self.state = self._placed(self.state._replace(
            phi=torch.from_numpy(phi).to(self.device)))
        self._bitmap = None
        self._set_memory_gauges()
        self.index = TrussIndex(new_spec, self.index.tracked)
        self.index.invalidate_all()

    # -- updates ---------------------------------------------------------------
    def insert(self, a: int, b: int):
        """progressiveUpdate insertion (Algorithm 2)."""
        self._ensure_capacity(a, b, inserting=True)
        _lo, hi = self._range_of(a, b, inserting=True)
        self.state = maintenance.insert_edge_maintain(self.spec, self.state,
                                                      a, b)
        self.last_peel_stats = EMPTY_STATS
        _PROGRESSIVE_N.inc()
        # the inserted edge joins (and can merge components of) every level
        # k <= phi(e) <= hi + 1 — invalidate from the bottom
        self.index.invalidate(2, max(hi, 1))
        self._present.add((min(a, b), max(a, b)))
        self._bitmap_apply((), [(min(a, b), max(a, b))])

    def delete(self, a: int, b: int):
        """progressiveUpdate deletion (Algorithm 1)."""
        _lo, hi = self._range_of(a, b, inserting=False)
        self.state = maintenance.delete_edge_maintain(self.spec, self.state,
                                                      a, b)
        self.last_peel_stats = EMPTY_STATS
        _PROGRESSIVE_N.inc()
        # the deleted edge leaves (and can split components of) every level
        # k <= phi(e), not just the Theorem-1 phi range
        self.index.invalidate(2, max(hi, 1))
        self._present.discard((min(a, b), max(a, b)))
        self._bitmap_apply([(min(a, b), max(a, b))], ())

    def _range_of(self, a: int, b: int, inserting: bool):
        """Theorem 1/2 affected range for index invalidation."""
        _id1, _id2, valid, kmin, kmax, ns = maintenance._edge_partner_stats(
            self.spec, self.state, a, b)
        if not bool(valid.any()):
            return (1, 0)  # empty range
        kmin, kmax, ns = int(kmin), int(kmax), int(ns)
        if inserting:
            return (kmin, min(ns + 1, kmax))
        u, v = (torch.tensor(x, dtype=torch.int32, device=self.device)
                for x in (min(a, b), max(a, b)))
        slot, found = lookup_edge(self.spec, self.state, u, v)
        phi_e = int(self.state.phi[int(slot)]) if bool(found) else 0
        return (kmin, phi_e)

    def apply_batch(self, updates, strategy: str = "auto",
                    fused_threshold: int = 8, defer_sync: bool = False,
                    engine: str = "auto"):
        """Apply a batch of (op, a, b) updates with truss maintenance.

        The batch is first *netted* on the host (an edge inserted then
        deleted inside one batch cancels), then applied either
        ``progressive`` (Algorithms 1/2 per netted update) or ``fused`` (one
        ``batch.batch_maintain`` call); ``auto`` picks fused once the netted
        batch reaches ``fused_threshold`` updates.  ``engine`` selects the
        fused path's peel engine (``auto`` / ``delta`` / ``recompute``).

        ``defer_sync=True`` (the service's pipelined flush): the fused path
        returns the invalidation bound ``hi`` as a 0-d int32 tensor on the
        graph's device *instead of* invalidating the index here; the caller
        runs ``index.invalidate(2, max(int(hi), 1))`` before any label
        query reads this state.  The progressive path and a netted no-op
        return ``None`` (their invalidation is done).  The peel loop reads
        its frontier on the host every wave, so when this returns only the
        launches after the last wave's read can still be running.
        """
        ups = [(int(op), int(a), int(b)) for op, a, b in updates]
        if not ups:
            return
        present0 = self._present
        cur = set(present0)
        for op, a, b in ups:
            if a == b:
                raise ValueError("self-loops are not allowed")
            key = (min(a, b), max(a, b))
            if op == maintenance.OP_INSERT:
                if key in cur:
                    raise ValueError(f"insert of present edge {key}")
                cur.add(key)
            else:
                if key not in cur:
                    raise ValueError(f"delete of absent edge {key}")
                cur.discard(key)
        dels = sorted(present0 - cur)
        inss = sorted(cur - present0)
        n_net = len(dels) + len(inss)
        if n_net == 0:
            return None
        if strategy == "auto":
            strategy = "fused" if n_net >= fused_threshold else "progressive"
        if strategy == "progressive":
            for a, b in dels:
                self.delete(a, b)
            for a, b in inss:
                self.insert(a, b)
            return None
        if strategy != "fused":
            raise ValueError(f"unknown strategy {strategy!r}")
        final = np.fromiter((x for e in cur for x in e), np.int64,
                            2 * len(cur))
        deg = np.bincount(final, minlength=self.spec.n_nodes)
        if len(cur) > self.spec.e_cap or deg.max(initial=0) > self.spec.d_max:
            self._grow(min_d=int(deg.max(initial=0)), min_e=len(cur))
        bsz = 1
        while bsz < max(len(dels), len(inss)):
            bsz <<= 1

        def pad(pairs):
            arr = np.zeros((bsz, 2), np.int32)
            msk = np.zeros(bsz, bool)
            if pairs:
                arr[:len(pairs)] = np.asarray(pairs, np.int32)
                msk[:len(pairs)] = True
            arr, msk = (torch.from_numpy(x).to(self.device) for x in (arr, msk))
            return arr[:, 0], arr[:, 1], msk

        da, db, dm = pad(dels)
        ia, ib, im = pad(inss)
        # warm the cache from the PRE-update state, then fold the structural
        # changes in: batch_maintain's delta-peel wants the POST-update bitmap
        if self.support_method == "bitmap":
            self._bitmap_cache()
            self._bitmap_apply(dels, inss)
        try:
            with obs_trace.span("graph.apply_batch", dels=len(dels),
                                ins=len(inss), defer=defer_sync):
                self.state, _lo, hi, stats = batch.batch_maintain(
                    self.spec, self.state, da, db, dm, ia, ib, im,
                    method=self.support_method, engine=engine,
                    bitmap=self._bitmap, mesh=self.mesh)
        except BaseException:
            # the cache already describes the post-update edge set but
            # _present still the pre-update one — drop it rather than let
            # later bitmap-method peels read a diverged cache
            self._bitmap = None
            raise
        self.last_peel_stats = stats
        self._present = cur
        if defer_sync:
            return hi
        # updated edges join/leave every level below the range too, so
        # invalidate [2, hi + 1]; the mixed-batch fallback's hi = +inf
        # invalidates everything
        self.index.invalidate(2, max(int(hi), 1))
        return None

    def batch_update_then_decompose(self, updates):
        """batchUpdate baseline: apply structural updates, re-decompose."""
        el = set(self._present)
        for op, a, b in updates:
            key = (min(a, b), max(a, b))
            if op == maintenance.OP_INSERT:
                el.add(key)
            else:
                el.discard(key)
        self._present = set(el)
        el = np.asarray(sorted(el), np.int64).reshape(-1, 2)
        deg = (np.bincount(el.reshape(-1), minlength=self.spec.n_nodes)
               if len(el) else np.zeros(self.spec.n_nodes))
        if len(el) > self.spec.e_cap or deg.max(initial=0) > self.spec.d_max:
            s = self.spec.n_shards
            self.spec = GraphSpec(
                self.spec.n_nodes,
                max(self.spec.d_max, int(deg.max(initial=0)) + 4),
                -(-max(self.spec.e_cap, len(el) + 16) // s) * s,
                n_shards=s, shard_axis=self.spec.shard_axis,
                partition=self.spec.partition)
            self._set_memory_gauges()
        self.state = self._placed(from_edge_list(self.spec, el, self.device))
        self._bitmap = None  # wholesale structural rebuild: cache is stale
        phi, stats = decomposition.decompose_with_stats(
            self.spec, self.state, self.support_method,
            bitmap=self._bitmap_cache(), mesh=self.mesh, device=self.device)
        self.state = self.state._replace(phi=phi)
        self.last_peel_stats = stats
        self.index = TrussIndex(self.spec, self.index.tracked)
        self.index.invalidate_all()

    # -- views -----------------------------------------------------------------
    def edge_list(self) -> np.ndarray:
        """Active edges as an ``[m, 2]`` host array."""
        act = self.state.active.cpu().numpy()
        return self.state.edges.cpu().numpy()[act]

    def phi_dict(self) -> dict:
        """Host mapping ``(u, v) -> phi`` over active edges (test/oracle view)."""
        act = self.state.active.cpu().numpy()
        edges = self.state.edges.cpu().numpy()[act]
        phis = self.state.phi.cpu().numpy()[act]
        return dict(zip(zip(edges[:, 0].tolist(), edges[:, 1].tolist()),
                        phis.tolist()))

    def k_truss(self, k: int) -> np.ndarray:
        """Edges of the k-truss (``phi >= k``) as an ``[m, 2]`` host array."""
        act = (self.state.active & (self.state.phi >= k)).cpu().numpy()
        return self.state.edges.cpu().numpy()[act]

    def max_truss(self) -> int:
        """Largest k with a non-empty k-truss (0 when the graph is empty)."""
        return int(torch.where(self.state.active, self.state.phi, 0).max())
