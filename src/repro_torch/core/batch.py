"""Fused batched truss maintenance — B updates, one frontier loop (PyTorch
port of ``repro.core.batch``).

Three stages, as in the reference:

1. **Structural pass** — one vectorized ``apply_edge_batch_struct`` call.
2. **Affected set** — per-update Theorem 1/2 ranges (deletion stats on the
   pre-update graph, insertion stats on the post-update graph) seed one
   shared frontier, widened by ``n_updates - 1`` for sequential drift; a
   mixed batch whose inserted edges touch a deleted edge's endpoint falls
   back to the unfiltered closure.  A BFS over triangle adjacency collects
   every edge that could transitively change.
3. **Frozen-boundary re-peel** — the shared peel engine recomputes phi for
   the affected set with every other edge frozen at its old phi.

``st`` is updated **in place** (the reference donates it) and returned.
"""
from __future__ import annotations

import torch

from .graph import (GraphSpec, GraphState, apply_edge_batch_struct,
                    lookup_edge, nonzero_padded, triangle_partners)
from .maintenance import _NEG, _POS
from .peel import chunk_partners, gather_phi, peel as run_peel, scatter_or

_I32 = torch.int32


def batch_maintain(spec: GraphSpec, st: GraphState,
                   del_a, del_b, del_valid,
                   ins_a, ins_b, ins_valid,
                   batch: int = 256, method: str = "sorted",
                   engine: str = "auto",
                   bitmap: torch.Tensor | None = None, mesh=None):
    """Apply B deletions + B insertions jointly and maintain phi exactly.

    All tensors are length-B int32/bool (padded, masked) on the state's
    device.  Deletions and insertions must be disjoint, structurally valid
    edge sets (``DynamicGraph.apply_batch`` nets them on the host).
    ``bitmap``, when given (bitmap method), must be the adjacency bitmap of
    the POST-update active set; it is not modified.  ``mesh`` must be
    ``None`` (ROADMAP item 13).

    Returns ``(state, lo, hi, stats)`` — the post-update state, the widened
    union affected range (0-d int32; ``lo > hi`` means nothing beyond the
    inserted edges could change) for index invalidation, and the re-peel
    ``PeelStats``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-partitioned maintenance is not ported yet (ROADMAP item 13)")
    e_cap, n = spec.e_cap, spec.n_nodes
    bsz = del_a.shape[0]

    # ---- per-deletion Theorem-1 stats on the PRE-update graph ------------
    du = torch.minimum(del_a, del_b).to(_I32)
    dv = torch.maximum(del_a, del_b).to(_I32)
    duc = torch.where(del_valid, du, 0)
    dvc = torch.where(del_valid, dv, 0)
    d_id1, d_id2, d_val = triangle_partners(spec, st, duc, dvc)     # [B, D]
    d_val = d_val & del_valid[:, None]
    dp = torch.minimum(gather_phi(st.phi, d_id1, e_cap),
                       gather_phi(st.phi, d_id2, e_cap))
    d_kmin = torch.where(d_val, dp, _POS).min(1).values
    d_slot, _ = lookup_edge(spec, st, duc, dvc)
    d_phi = gather_phi(st.phi, d_slot, e_cap)
    d_has = d_val.any(1)
    d_lo = torch.where(d_has, d_kmin, _POS)
    d_hi = torch.where(d_has, d_phi, _NEG)

    # ---- one vectorized structural pass ----------------------------------
    st1, ins_slots = apply_edge_batch_struct(
        spec, st, del_a, del_b, del_valid, ins_a, ins_b, ins_valid)

    # ---- per-insertion Theorem-2 stats on the POST-update graph ----------
    iu = torch.minimum(ins_a, ins_b).to(_I32)
    iv = torch.maximum(ins_a, ins_b).to(_I32)
    iuc = torch.where(ins_valid, iu, 0)
    ivc = torch.where(ins_valid, iv, 0)
    i_id1, i_id2, i_val = triangle_partners(spec, st1, iuc, ivc)    # [B, D]
    i_val = i_val & ins_valid[:, None]

    slots_sorted = torch.sort(torch.where(ins_valid, ins_slots, e_cap)).values

    def is_new(ids):
        pos = torch.clamp(torch.searchsorted(slots_sorted, ids.reshape(-1)),
                          max=bsz - 1).reshape(ids.shape)
        return (ids < e_cap) & (slots_sorted[pos] == ids)

    new1, new2 = is_new(i_id1), is_new(i_id2)
    q1 = gather_phi(st1.phi, i_id1, e_cap)
    q2 = gather_phi(st1.phi, i_id2, e_cap)
    ex1 = i_val & ~new1
    ex2 = i_val & ~new2
    kmin_ex = torch.minimum(torch.where(ex1, q1, _POS).min(1).values,
                            torch.where(ex2, q2, _POS).min(1).values)
    kmax_ex = torch.maximum(torch.where(ex1, q1, _NEG).max(1).values,
                            torch.where(ex2, q2, _NEG).max(1).values)
    n_common = i_val.sum(1, dtype=_I32)
    any_new = (i_val & (new1 | new2)).any(1)
    i_has = i_val.any(1)
    # A partner edge that is itself new has no pre-update phi: drop the
    # kmin/kmax refinements and keep the always-sound bounds [2, |S|+1].
    i_lo = torch.where(i_has, torch.where(any_new, 2, kmin_ex), _POS)
    i_hi = torch.where(i_has,
                       torch.where(any_new, n_common + 1,
                                   torch.minimum(n_common + 1, kmax_ex)),
                       _NEG)

    # ---- union range, widened for sequential drift; mixed-batch fallback -
    n_del = del_valid.sum(dtype=_I32)
    n_ins = ins_valid.sum(dtype=_I32)
    slack = torch.clamp(n_del + n_ins - 1, min=0)
    lo_u = torch.minimum(d_lo.min(), i_lo.min()) - slack
    hi_u = torch.maximum(d_hi.max(), i_hi.max()) + slack
    # Range filtering stays sound for a mixed batch iff no inserted edge
    # touches a deleted edge's endpoint; otherwise fall back to the
    # unfiltered closure (re-decomposition of the affected component).
    del_nodes = torch.zeros((n + 1,), dtype=torch.bool, device=du.device)
    del_nodes[torch.where(del_valid, du, n).long()] = True
    del_nodes[torch.where(del_valid, dv, n).long()] = True
    touches = ins_valid & (del_nodes[torch.where(ins_valid, iu, n).long()]
                           | del_nodes[torch.where(ins_valid, iv, n).long()])
    separable = (n_del == 0) | (n_ins == 0) | ~touches.any()
    lo = torch.where(separable, torch.clamp(lo_u, min=2), 2)
    hi = torch.where(separable, hi_u, _POS)

    act_pad = torch.cat([st1.active, st1.active.new_zeros(1)])
    phi_pad = torch.cat([st1.phi, st1.phi.new_zeros(1)])

    def admissible(ids, msk):
        p = phi_pad[torch.clamp(ids, max=e_cap).long()]
        idc = torch.clamp(ids, max=e_cap).long()
        return msk & (ids < e_cap) & act_pad[idc] & (p >= lo) & (p <= hi)

    # ---- shared frontier seeds ------------------------------------------
    seeds = torch.zeros_like(st1.active)
    for ids, msk in ((d_id1, d_val), (d_id2, d_val),
                     (i_id1, i_val), (i_id2, i_val)):
        seeds = scatter_or(seeds, ids, admissible(ids, msk))
    seeds = seeds & st1.active
    affected = scatter_or(seeds, ins_slots, ins_valid)  # new edges always in A

    # ---- BFS closure over triangle adjacency -----------------------------
    frontier = affected
    it = 0
    while it < e_cap and bool(frontier.any()):
        idx = nonzero_padded(frontier, batch, e_cap)
        live = idx < e_cap
        p1, p2, tval = chunk_partners(spec, st1, idx, st1.active)
        nxt = scatter_or(torch.zeros_like(affected), p1, admissible(p1, tval))
        nxt = scatter_or(nxt, p2, admissible(p2, tval))
        nxt = nxt & ~affected
        processed = scatter_or(torch.zeros_like(affected), idx, live)
        affected = affected | nxt
        frontier = (frontier & ~processed) | nxt
        it += 1

    # ---- frozen-boundary re-peel (shared engine, peel.py) ----------------
    phi_final, stats = run_peel(spec, st1, affected, bitmap=bitmap,
                                method=method, engine=engine,
                                device=st1.phi.device)
    st1.phi.copy_(phi_final)
    return st1, lo, hi, stats
