"""Delta-peel engine — the shared support-maintenance core of every peel loop
(PyTorch port of ``repro.core.peel``, single device).

Every peel consumer (full ``decompose``, the fused batch engine's
frozen-boundary re-peel) routes through ``peel`` with two wave disciplines:

* ``recompute_peel`` — every wave recomputes the support of the whole
  qualifying subgraph (searchsorted rows, or a fresh bitmap and the
  ``bitmap_support`` kernel);
* ``delta_peel`` — ``sorted``: support computed once, then each wave
  enumerates the triangles of the killed frontier only and scatter-subtracts
  support deltas onto surviving partners (tie-broken by slot so a triangle
  with several dead members is counted once); ``bitmap``: the dead edges'
  bits are cleared out of the adjacency bitmap incrementally and the fused
  ``peel_wave`` kernel re-derives (support, kill frontier) from the cleared
  bitmap, reading rows straight out of it by endpoint.

Frozen edges (outside ``peel_mask``) support level-k triangles iff their
unchanged phi >= k and retire from the qualifying subgraph when k passes
their phi — a retire is a kill that keeps its phi.

Each ``lax.while_loop`` of the reference is a host loop here that reads its
condition once per wave (one device sync); every other wave quantity, ``k``
included, stays on the device.  The ``waves < 8 * e_cap`` cap is kept.
Results (phi and every ``PeelStats`` field) are bitwise those of the
reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs import metrics as obs_metrics
from .graph import (GraphSpec, GraphState, _endpoints, add_drop, build_bitmap,
                    nonzero_padded, set_drop, support_all, support_all_bitmap,
                    triangle_partners, update_bitmap)

_INF = 2**30
_I32 = torch.int32

# wave-level profile families; the host-stepped profiled loop that observes
# them (the reference's ``set_wave_profile``) arrives with the CLI slice
_WAVE_S = obs_metrics.histogram(
    "truss_peel_wave_seconds",
    "wall time of one host-stepped peel wave (wave-profile mode only)",
    buckets=(1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
             1e-2, 2.5e-2, 5e-2, 0.1, 0.25))
_WAVE_COLL = obs_metrics.histogram(
    "truss_peel_wave_collective_share",
    "estimated fraction of one wave spent in the per-wave decision "
    "all-reduce (wave-profile mode under a mesh)",
    buckets=(0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9))


# ---------------------------------------------------------------------------
# wave primitives — shared with maintenance.py (Algorithms 1/2 frontiers)
# and batch.py (affected-set BFS closure)
# ---------------------------------------------------------------------------

def gather_phi(phi: torch.Tensor, ids: torch.Tensor, e_cap: int) -> torch.Tensor:
    """phi gather with OOB/sentinel (e_cap) ids mapping to 0."""
    return torch.where(ids < e_cap,
                       phi[torch.clamp(ids, max=e_cap - 1).long()], 0)


def gather_mask(mask: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """bool-mask gather with OOB/sentinel ids mapping to False."""
    e_cap = mask.shape[0]
    padded = torch.cat([mask, mask.new_zeros(1)])
    return padded[torch.clamp(ids, max=e_cap).long()]


def scatter_or(mask: torch.Tensor, ids: torch.Tensor,
               cond: torch.Tensor) -> torch.Tensor:
    """mask | (cond scattered at ids) (sentinel/e_cap ids dropped); pure."""
    e_cap = mask.shape[0]
    padded = torch.cat([mask, mask.new_zeros(1)])
    tgt = torch.where(cond, ids, e_cap).reshape(-1)
    padded[torch.clamp(tgt, max=e_cap).long()] = True
    return padded[:e_cap]


def chunk_partners(spec: GraphSpec, st: GraphState, idx: torch.Tensor,
                   alive: torch.Tensor):
    """Triangle partners of a compacted chunk of edge slots.

    ``idx`` is a fixed-size batch of edge slots (sentinel ``e_cap`` on dead
    rows).  Returns ``(p1, p2, tval)`` of shape [C, D]: partner-edge slot
    ids and a validity mask requiring a live row AND both partners in
    ``alive`` — exactly the triangles of the chunk edges that exist in the
    ``alive`` subgraph.
    """
    live = idx < spec.e_cap
    idxc = torch.clamp(idx, max=spec.e_cap - 1).long()
    u, v = _endpoints(spec, st.edges[idxc])
    p1, p2, tval = triangle_partners(spec, st, u, v)
    tval = (tval & live[:, None]
            & gather_mask(alive, p1) & gather_mask(alive, p2))
    return p1, p2, tval


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class PeelStats(NamedTuple):
    """Instrumentation returned by every peel-engine call (0-d int32
    tensors on the state's device).

    waves:    loop iterations (kill chunks + level advances)
    kills:    peelable edges assigned a phi
    deltas:   scatter-subtracted support updates
    frontier: peelable edges entering the peel (|peel_mask ∩ active|)

    ``stats_dict`` converts to host ints; ``EMPTY_STATS`` is the no-peel
    record the progressive Algorithm-1/2 paths report (host ints, all zero).
    """
    waves: torch.Tensor
    kills: torch.Tensor
    deltas: torch.Tensor
    frontier: torch.Tensor = 0


EMPTY_STATS = PeelStats(0, 0, 0, 0)


def stats_dict(ps: PeelStats) -> dict:
    """Host-int dict of a ``PeelStats`` (``int()`` syncs device scalars)."""
    return {"waves": int(ps.waves), "kills": int(ps.kills),
            "deltas": int(ps.deltas), "frontier": int(ps.frontier)}


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=_I32, device=like.device)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=_I32)


def _on(device, *tensors):
    return tuple(None if t is None else t.to(device) for t in tensors)


def peel(spec: GraphSpec, st: GraphState, peel_mask: torch.Tensor,
         bitmap: torch.Tensor | None = None, method: str = "sorted",
         engine: str = "auto", chunk: int = 64, mesh=None, device="cuda"):
    """The one peel entry point every consumer routes through.

    ``engine='auto'`` picks ``delta`` for ``bitmap`` (incremental bit
    clearing + the fused ``peel_wave`` kernel) and ``recompute`` for
    ``sorted``, as the reference does.  Inputs are moved to ``device``
    (a no-op when they already live there).  ``mesh`` must be ``None``:
    the mesh-partitioned engine is a later slice (ROADMAP item 13).
    Returns ``(phi, PeelStats)``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-partitioned peeling is not ported yet (ROADMAP item 13)")
    st = GraphState(*_on(device, *st))
    peel_mask, bitmap = _on(device, peel_mask, bitmap)
    if engine == "auto":
        engine = "delta" if method == "bitmap" else "recompute"
    if engine == "delta":
        return delta_peel(spec, st, peel_mask, bitmap=bitmap, method=method,
                          chunk=chunk)
    if engine != "recompute":
        raise ValueError(f"unknown engine {engine!r}")
    return recompute_peel(spec, st, peel_mask, method=method)


def delta_peel(spec: GraphSpec, st: GraphState, peel: torch.Tensor,
               bitmap: torch.Tensor | None = None, method: str = "sorted",
               chunk: int = 64):
    """Peel ``peel``-masked edges against a frozen boundary; returns
    ``(phi int32[E_cap], PeelStats)``.  ``peel = st.active`` is a full
    decomposition.

    ``sorted``: support is delta-maintained by killed-frontier triangle
    enumeration, chunked under a triangle budget.  ``bitmap``: dead edges'
    bits are cleared incrementally and the ``peel_wave`` kernel re-derives
    (support, kill frontier) each wave.  ``bitmap``, when given, must be
    the adjacency bitmap of ``st.active``; it is not modified.
    """
    peel = peel & st.active
    frozen = st.active & ~peel
    fphi = st.phi
    alive0 = peel | (frozen & (fphi >= 3))

    if method == "bitmap":
        phi, stats = _peel_bitmap(spec, st, peel, frozen, fphi, alive0, bitmap)
    elif method == "sorted":
        phi, stats = _peel_sorted(spec, st, peel, frozen, fphi, alive0, chunk)
    else:
        raise ValueError(f"unknown method {method!r}")
    return phi, stats._replace(frontier=_count(peel))


def _next_level(k, any_dead, alive_peel, sup, alive_frozen, fphi):
    """Level fixpoint -> jump k past dead levels: nothing peels before an
    alive edge's support bound (min sup + 3) or before the frozen boundary
    next shrinks (min frozen phi exits at phi + 1)."""
    min_sup = torch.where(alive_peel, sup, _INF).min()
    min_frz = torch.where(alive_frozen, fphi, _INF).min()
    k_next = torch.maximum(k + 1, torch.minimum(min_sup + 3, min_frz + 1))
    return torch.where(any_dead, k, k_next)


def recompute_peel(spec: GraphSpec, st: GraphState, peel: torch.Tensor,
                   method: str = "sorted"):
    """Per-wave full support recomputation against a frozen boundary — the
    dense discipline: every wave recomputes the support of the whole
    qualifying subgraph.  Same contract as ``delta_peel``;
    ``PeelStats.deltas`` is 0."""
    e_cap = spec.e_cap
    peel = peel & st.active
    frozen = st.active & ~peel
    fphi = st.phi
    if method == "bitmap":
        sup_fn = lambda qual: support_all_bitmap(spec, st, qual)  # noqa: E731
    elif method == "sorted":
        sup_fn = lambda qual: support_all(spec, st, qual)  # noqa: E731
    else:
        raise ValueError(f"unknown method {method!r}")

    alive, phi, k = peel, st.phi, _scalar(3, st.phi)
    kills = _scalar(0, st.phi)
    waves = 0
    while waves < 8 * e_cap and bool(alive.any()):
        # an edge counts toward level-k support iff it is an unpeeled member
        # of the peel set or a frozen edge whose phi keeps it in the k-truss
        qual = alive | (frozen & (fphi >= k))
        sup = sup_fn(qual)
        kill = alive & (sup < k - 2)
        any_kill = kill.any()
        phi = torch.where(kill, k - 1, phi)
        alive = alive & ~kill
        min_sup = torch.where(alive, sup, _INF).min()
        j2 = torch.where(frozen & (fphi >= k), fphi, _INF).min() + 1
        k_jump = torch.maximum(torch.minimum(min_sup + 3, j2), k + 1)
        k = torch.where(any_kill, k, k_jump)
        waves += 1
        kills = kills + _count(kill)
    return (torch.where(st.active, phi, 0),
            PeelStats(_scalar(waves, phi), kills, _scalar(0, phi),
                      _count(peel)))


def _peel_bitmap(spec, st, peel, frozen, fphi, alive0, bitmap):
    """Kill-wave loop over the incrementally-cleared adjacency bitmap."""
    from ..kernels import ops as kernel_ops  # kernels never import core

    e_cap = spec.e_cap
    eu, ev = _endpoints(spec, st.edges)
    eu, ev = eu.contiguous(), ev.contiguous()

    if bitmap is None:
        bm = build_bitmap(spec, st, alive0)
    else:
        # the provided bitmap covers st.active: clear, on the engine's own
        # copy, the bits of edges outside the initial qualifying set
        bm = update_bitmap(spec, bitmap.clone(), st.edges[:, 0],
                           st.edges[:, 1], st.active & ~alive0,
                           set_bits=False)

    alive, phi, k = alive0, st.phi, _scalar(3, st.phi)
    kills, deltas = _scalar(0, phi), _scalar(0, phi)
    waves = 0
    while waves < 8 * e_cap and bool((alive & peel).any()):
        # one fused pass over the current bitmap: support of every peelable
        # edge + the level-k kill frontier (frozen support is never read —
        # frozen edges retire by level, not threshold)
        sup, kill = kernel_ops.peel_wave_gathered(bm, eu, ev, alive & peel, k)
        retire = alive & frozen & (fphi < k)
        dead = kill | retire
        phi = torch.where(kill, k - 1, phi)
        alive = alive & ~dead
        # clear the whole wave's bits at once — O(wave) real updates
        update_bitmap(spec, bm, st.edges[:, 0], st.edges[:, 1], dead,
                      set_bits=False)
        k = _next_level(k, dead.any(), alive & peel, sup, alive & frozen, fphi)
        waves += 1
        kills = kills + _count(kill)
        deltas = deltas + 2 * _count(dead)
    return (torch.where(st.active, phi, 0),
            PeelStats(_scalar(waves, phi), kills, deltas))


def _peel_sorted(spec, st, peel, frozen, fphi, alive0, chunk):
    """Killed-frontier triangle-delta loop (searchsorted row intersection)."""
    e_cap = spec.e_cap
    sup = support_all(spec, st, alive0)

    # Triangle-budget admission: a dead edge's alive triangle count IS its
    # maintained support, so the cumulative support of the admitted
    # sub-chunk bounds the number of real deltas — compact them into a
    # fixed buffer and scatter only those.
    budget = max(chunk, 2 * spec.d_max)
    compact = 2 * (budget + spec.d_max)  # ≤ 2 decs per admitted triangle

    alive, phi, k = alive0, st.phi.clone(), _scalar(3, st.phi)
    kills, deltas = _scalar(0, phi), _scalar(0, phi)
    waves = 0
    while waves < 8 * e_cap and bool((alive & peel).any()):
        # dead set at level k: peelable edges below threshold + frozen edges
        # whose level has passed (kills on stale, higher support stay sound)
        retire = alive & frozen & (fphi < k)
        kill = alive & peel & (sup < k - 2)
        dead = kill | retire
        any_dead = dead.any()

        # admit dead edges in slot order while their cumulative triangle
        # count fits the compaction buffer (the first always fits); the
        # rest stay pending — the level cannot advance until all are done
        w_e = torch.where(dead, sup + 1, 0)
        csum = torch.cumsum(w_e, 0, dtype=_I32)
        dcount = torch.cumsum(dead.to(_I32), 0, dtype=_I32)
        admit = dead & ((csum <= budget) & (dcount <= chunk) | (dcount == 1))

        idx = nonzero_padded(admit, chunk, e_cap)
        live = idx < e_cap
        idxc = torch.clamp(idx, max=e_cap - 1).long()
        in_chunk = scatter_or(torch.zeros_like(alive), idx, live)

        # triangles of the killed frontier only (both partners alive at wave
        # start); tie-break multi-kill triangles by slot so each surviving
        # partner loses exactly one unit per dead triangle
        p1, p2, tval = chunk_partners(spec, st, idx, alive)
        c1 = gather_mask(in_chunk, p1)
        c2 = gather_mask(in_chunk, p2)
        own = idx[:, None]
        dec1 = tval & ~c1 & (~c2 | (own < p2))
        dec2 = tval & ~c2 & (~c1 | (own < p1))
        flat = torch.cat([torch.where(dec1, p1, e_cap).reshape(-1),
                          torch.where(dec2, p2, e_cap).reshape(-1)])
        upd = nonzero_padded(flat < e_cap, compact, flat.shape[0])
        ids = torch.where(upd < flat.shape[0],
                          flat[torch.clamp(upd, max=flat.shape[0] - 1).long()],
                          e_cap)
        add_drop(sup, ids, -1)

        kill_rows = live & kill[idxc]
        set_drop(phi, torch.where(kill_rows, idx, e_cap), k - 1)
        alive = alive & ~in_chunk
        k = _next_level(k, any_dead, alive & peel, sup, alive & frozen, fphi)
        waves += 1
        kills = kills + _count(kill_rows)
        deltas = deltas + _count(dec1) + _count(dec2)
    return (torch.where(st.active, phi, 0),
            PeelStats(_scalar(waves, phi), kills, deltas))
