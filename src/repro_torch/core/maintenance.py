"""Incremental truss maintenance (paper §4) — frontier-synchronous form
(PyTorch port of ``repro.core.maintenance``).

The paper's Algorithms 1 and 2 are queue-driven scalar loops; they run here
as the same chaotic iteration in batched frontier waves: a wave compacts the
frontier mask into a fixed-size index batch, evaluates the paper's
local-support certificate for the whole batch with one gather/searchsorted
pass, applies the phi updates, and scatters the next frontier from the
partners of every edge whose state changed.  Theorem 1 / Theorem 2 range
pruning bounds both admission and expansion.

Deviations from the published pseudocode are the reference's, kept bit for
bit: the localSupport2 qualification rule, and the inserted edge's phi kept
as an exact local estimate iterated to a joint fixpoint (see
``repro.core.maintenance``).

The entry points update the passed ``GraphState`` **in place** (the
reference donates it) and return it: do not read the passed-in state as the
pre-update graph after the call.
"""
from __future__ import annotations

import torch

from .graph import (GraphSpec, GraphState, delete_edge_struct,
                    insert_edge_struct, lookup_edge, nonzero_padded,
                    triangle_partners)
from .peel import chunk_partners, gather_mask, gather_phi, scatter_or

_NEG = -(2**30)
_POS = 2**30
_I32 = torch.int32


def _as_i32(x, st: GraphState) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_I32, device=st.edges.device)


def _edge_partner_stats(spec: GraphSpec, st: GraphState, a, b):
    """kmin, kmax over E_{S_ab<->{a,b}} and |S_ab| (paper Table 1),
    evaluated on the current structure."""
    a, b = _as_i32(a, st), _as_i32(b, st)
    id1, id2, valid = triangle_partners(spec, st, a.reshape(1), b.reshape(1))
    id1, id2, valid = id1[0], id2[0], valid[0]
    p1 = gather_phi(st.phi, id1, spec.e_cap)
    p2 = gather_phi(st.phi, id2, spec.e_cap)
    kmin = torch.where(valid, torch.minimum(p1, p2), _POS).min()
    kmax = torch.where(valid, torch.maximum(p1, p2), _NEG).max()
    n_common = valid.sum(dtype=_I32)
    return id1, id2, valid, kmin, kmax, n_common


def _phi_new_estimate(spec: GraphSpec, phi: torch.Tensor, id1, id2,
                      valid) -> torch.Tensor:
    """Exact local phi of the inserted edge given partner-edge phis."""
    p1 = gather_phi(phi, id1, spec.e_cap)
    p2 = gather_phi(phi, id2, spec.e_cap)
    pmin = torch.where(valid, torch.minimum(p1, p2), 0)           # [D]
    ks = torch.arange(3, spec.d_max + 3, dtype=_I32, device=phi.device)
    cnt = (pmin[None, :] >= ks[:, None]).sum(1, dtype=_I32)        # [K]
    feasible = cnt >= (ks - 2)
    return torch.clamp(torch.where(feasible, ks, 2).max(), min=2)


# ---------------------------------------------------------------------------
# deletion — Algorithm 1
# ---------------------------------------------------------------------------

def delete_edge_maintain(spec: GraphSpec, st: GraphState, a, b,
                         batch: int = 256) -> GraphState:
    """Delete (a, b) and maintain phi for all remaining edges (in place)."""
    e_cap = spec.e_cap
    a, b = _as_i32(a, st), _as_i32(b, st)
    slot, _ = lookup_edge(spec, st, torch.minimum(a, b), torch.maximum(a, b))
    phi_e = gather_phi(st.phi, slot, e_cap)
    id1, id2, valid, kmin, _kmax, _ns = _edge_partner_stats(spec, st, a, b)

    st, _ = delete_edge_struct(spec, st, a, b)
    lo, hi = kmin, phi_e

    # Theorem 1(a): nothing to do if S empty or kmin > phi(e).
    propagate = valid.any() & (kmin <= phi_e)

    def in_range(phi, ids):
        p = gather_phi(phi, ids, e_cap)
        return (ids < e_cap) & (p >= lo) & (p <= hi)

    frontier = torch.zeros_like(st.active)
    frontier = scatter_or(frontier, id1, valid & in_range(st.phi, id1) & propagate)
    frontier = scatter_or(frontier, id2, valid & in_range(st.phi, id2) & propagate)
    frontier = frontier & st.active

    phi = st.phi.clone()
    marked = torch.zeros_like(st.active)
    it = 0
    while it < 4 * e_cap and bool(frontier.any()):
        idx = nonzero_padded(frontier, batch, e_cap)
        live = idx < e_cap
        idxc = torch.clamp(idx, max=e_cap - 1).long()
        k = phi[idxc]

        # localSupport(f, phi(f)) on current phi (Alg. 1 step 5); partner
        # aliveness folds into tval (deleted slots never qualify)
        p1, p2, tval = chunk_partners(spec, st, idx, st.active)
        q1 = gather_phi(phi, p1, e_cap) >= k[:, None]
        q2 = gather_phi(phi, p2, e_cap) >= k[:, None]
        ls = (tval & q1 & q2).sum(1, dtype=_I32)

        dec = (live & st.active[idxc] & ~marked[idxc] & (ls < k - 2)
               & (k >= lo) & (k <= hi))
        phi[idxc[dec]] -= 1
        marked = scatter_or(marked, idx, dec)

        # expand: partners of every decremented edge, Theorem-1 range filter
        exp1 = tval & dec[:, None] & in_range(phi, p1)
        exp2 = tval & dec[:, None] & in_range(phi, p2)
        nxt = scatter_or(torch.zeros_like(marked), p1, exp1)
        nxt = scatter_or(nxt, p2, exp2)
        nxt = nxt & st.active & ~marked

        processed = scatter_or(torch.zeros_like(marked), idx, live)
        frontier = (frontier & ~processed) | nxt
        it += 1
    st.phi.copy_(torch.where(st.active, phi, 0))
    return st


# ---------------------------------------------------------------------------
# insertion — Algorithm 2 (mark-and-verify) + new-edge phi fixpoint
# ---------------------------------------------------------------------------

def insert_edge_maintain(spec: GraphSpec, st: GraphState, a, b,
                         batch: int = 256) -> GraphState:
    """Insert (a, b), maintain phi of existing edges, compute phi of (a, b)
    (in place)."""
    e_cap = spec.e_cap
    a, b = _as_i32(a, st), _as_i32(b, st)
    id1, id2, valid, kmin, kmax, n_common = _edge_partner_stats(spec, st, a, b)
    st, e_new = insert_edge_struct(spec, st, a, b)

    bound = torch.minimum(n_common + 1, kmax)
    propagate = valid.any() & (kmin <= n_common + 1)
    lo, hi = kmin, bound

    def in_range(phi, ids):
        p = gather_phi(phi, ids, e_cap)
        return (ids < e_cap) & (p >= lo) & (p <= hi) & (ids != e_new)

    # Upper-bound initialization (Lemma 1 + Lemma 4): the outer fixpoint
    # iterates FROM ABOVE (see repro's oracle.Oracle.insert)
    ub = torch.where(valid.any(), torch.minimum(n_common + 2, kmax + 1),
                     _as_i32(2, st))
    phi = st.phi.clone()
    phi[e_new.long()] = ub

    def mark_and_verify(phi):
        """One full mark-and-verify sweep at a fixed phi[e_new]; returns marks."""
        frontier = torch.zeros_like(st.active)
        frontier = scatter_or(frontier, id1,
                              valid & in_range(phi, id1) & propagate)
        frontier = scatter_or(frontier, id2,
                              valid & in_range(phi, id2) & propagate)
        frontier = frontier & st.active
        marked = torch.zeros_like(st.active)
        settled = torch.zeros_like(st.active)
        it = 0
        while it < 8 * e_cap and bool(frontier.any()):
            idx = nonzero_padded(frontier, batch, e_cap)
            live = idx < e_cap
            idxc = torch.clamp(idx, max=e_cap - 1).long()
            k = phi[idxc]
            p1, p2, tval = chunk_partners(spec, st, idx, st.active)

            def qualifies(ids):
                p = gather_phi(phi, ids, e_cap)
                firm = p >= (k[:, None] + 1)            # already in the (k+1)-truss
                maybe = ((p == k[:, None]) & ~gather_mask(settled, ids)
                         & (ids != e_new))              # optimistically promotable
                return firm | maybe

            ls2 = (tval & qualifies(p1) & qualifies(p2)).sum(1, dtype=_I32)
            ok = (live & st.active[idxc] & (k >= lo) & (k <= hi)
                  & ~settled[idxc])
            passes = ok & (ls2 >= k - 1)
            fails = ok & (ls2 < k - 1)

            newly_marked = passes & ~marked[idxc]
            marked = (scatter_or(marked, idx, newly_marked)
                      & ~scatter_or(torch.zeros_like(marked), idx, fails))
            settled = scatter_or(settled, idx, fails)

            changed = newly_marked | fails
            exp1 = (tval & changed[:, None] & in_range(phi, p1)
                    & ~gather_mask(settled, p1))
            exp2 = (tval & changed[:, None] & in_range(phi, p2)
                    & ~gather_mask(settled, p2))
            nxt = scatter_or(torch.zeros_like(marked), p1, exp1)
            nxt = scatter_or(nxt, p2, exp2)
            nxt = nxt & st.active & ~settled

            processed = scatter_or(torch.zeros_like(marked), idx, live)
            frontier = (frontier & ~processed) | nxt
            it += 1
        return marked

    # outer fixpoint on phi[e_new]
    marked = torch.zeros_like(st.active)
    it = 0
    while it < spec.d_max + 2:
        marked = mark_and_verify(phi)
        trial = phi + marked.to(_I32)
        est = _phi_new_estimate(spec, trial, id1, id2, valid)
        it += 1
        if bool(est == phi[e_new.long()]):
            break
        phi[e_new.long()] = est
    st.phi.copy_(torch.where(st.active, phi + marked.to(_I32), 0))
    return st


# ---------------------------------------------------------------------------
# update streams (progressiveUpdate driver)
# ---------------------------------------------------------------------------

OP_INSERT = 1
OP_DELETE = 0


def apply_updates(spec: GraphSpec, st: GraphState, ops, aa, bb,
                  batch: int = 256) -> GraphState:
    """Apply a stream of single-edge updates with incremental maintenance
    (the paper's ``progressiveUpdate``): each update runs Algorithm 1 or 2
    on ``st`` in place, in stream order."""
    as_list = lambda x: torch.as_tensor(x).reshape(-1).tolist()  # noqa: E731
    for op, a, b in zip(as_list(ops), as_list(aa), as_list(bb)):
        if op == OP_INSERT:
            st = insert_edge_maintain(spec, st, a, b, batch=batch)
        else:
            st = delete_edge_maintain(spec, st, a, b, batch=batch)
    return st
