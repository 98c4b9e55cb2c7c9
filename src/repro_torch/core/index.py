"""Truss index (paper §5): representatives for k-truss components + queries
(PyTorch port of ``repro.core.index``).

A maximal k-truss is a connected component of the subgraph induced by edges
with phi >= k.  Components are labelled by min-label propagation with
pointer jumping (every component at once, in O(log n) waves); the
representative of a component is its minimum edge slot.  ``TrussIndex``
caches per-k labels and invalidates only levels inside an update's
Theorem-1/2 range.
"""
from __future__ import annotations

import torch

from .graph import GraphSpec, GraphState, _endpoints

_INF = 2**30
_I32 = torch.int32


def _scatter_min(target: torch.Tensor, ids: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``target.at[ids].min(vals)`` (ids in range), returned as a new tensor."""
    return target.scatter_reduce(0, ids.long(), vals, reduce="amin",
                                 include_self=True)


def component_labels(spec: GraphSpec, st: GraphState, k) -> torch.Tensor:
    """int32[E_cap] component label per edge of the (phi >= k)-subgraph.

    Labels are node ids (min node in the component); non-member edges get
    _INF.  Connectivity is node-sharing between edges.
    """
    n = spec.n_nodes
    sub = st.active & (st.phi >= k)
    u, v = _endpoints(spec, st.edges)
    su, sv = u[sub], v[sub]
    smin = torch.minimum(su, sv)

    labels = torch.full((n,), _INF, dtype=_I32, device=st.phi.device)
    labels = _scatter_min(_scatter_min(labels, su, smin), sv, smin)

    it = 0
    while it < n:
        m = torch.minimum(labels[su.long()], labels[sv.long()])
        new = _scatter_min(_scatter_min(labels, su, m), sv, m)
        # pointer jumping: label[v] <- label[label[v]] (labels are node ids)
        safe = torch.clamp(new, max=n - 1).long()
        jumped = torch.minimum(torch.where(new < _INF, new[safe], new), new)
        changed = bool((jumped != labels).any())
        labels = jumped
        it += 1
        if not changed:
            break
    return torch.where(sub, torch.minimum(labels[u.long()], labels[v.long()]),
                       _INF)


def representatives_from_labels(spec: GraphSpec, lab: torch.Tensor) -> torch.Tensor:
    """rep_mask[E_cap] from precomputed edge labels: one min-slot edge per
    component (a scatter-min, no label propagation)."""
    member = lab < _INF
    slot = torch.arange(spec.e_cap, dtype=_I32, device=lab.device)
    tgt = torch.where(member, torch.clamp(lab, max=spec.n_nodes), spec.n_nodes)
    per_label = torch.full((spec.n_nodes + 1,), _INF, dtype=_I32,
                           device=lab.device)
    per_label = _scatter_min(per_label, tgt, torch.where(member, slot, _INF))
    return member & (per_label[torch.clamp(lab, max=spec.n_nodes).long()]
                     == slot)


def representatives(spec: GraphSpec, st: GraphState, k):
    """(rep_mask[E_cap], edge_label[E_cap]): one min-slot edge per component."""
    lab = component_labels(spec, st, k)
    return representatives_from_labels(spec, lab), lab


class TrussIndex:
    """Host-side cache of per-k component labels with range invalidation
    (paper §5.3 ``indexedUpdate``)."""

    def __init__(self, spec: GraphSpec, tracked_ks: tuple[int, ...]):
        self.spec = spec
        self.tracked = tuple(tracked_ks)
        self._labels: dict[int, torch.Tensor] = {}
        self._reps: dict[int, torch.Tensor] = {}
        self._dirty: set[int] = set(self.tracked)

    def track(self, k: int):
        """Add a level to the tracked set."""
        if k not in self.tracked:
            self.tracked = self.tracked + (k,)
            self._dirty.add(k)

    def invalidate(self, lo: int, hi: int):
        """An update affected phi range [lo, hi] => levels k <= hi+1 with
        k >= lo may have changed membership or connectivity."""
        for k in self.tracked:
            if lo <= k <= hi + 1:
                self._dirty.add(k)

    def invalidate_all(self):
        """Mark every tracked level dirty (used after restore/rebuild)."""
        self._dirty.update(self.tracked)

    def query(self, st: GraphState, k: int) -> torch.Tensor:
        """Edge component labels of the k-truss level (cached)."""
        if k in self._dirty or k not in self._labels:
            self._labels[k] = component_labels(self.spec, st, k)
            self._reps.pop(k, None)  # labels and reps invalidate together
            self._dirty.discard(k)
        return self._labels[k]

    def query_representatives(self, st: GraphState, k: int):
        """(rep_mask, labels) for level k, cached alongside the labels and
        invalidated together."""
        lab = self.query(st, k)
        if k not in self._reps:
            self._reps[k] = representatives_from_labels(self.spec, lab)
        return self._reps[k], lab
