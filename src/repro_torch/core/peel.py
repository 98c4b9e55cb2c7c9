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

``peel(mesh=ShardMesh)`` runs the same disciplines over the shards of
``mesh[spec.shard_axis]`` (``sharded_peel``), bitwise equal to
``mesh=None``: edge-sharded engines where each shard works its row block
of the edge axis (K1 or K2 once a shard a wave) and one packed 4-lane
``pmin`` decision is read on the host once a wave, and, under
``partition="nodes"``, the node-partitioned engine where each shard holds
one word slab of the bitmap and a wave sums the shards' partial supports.

``set_wave_profile(True)`` (``serve_truss --wave-profile``) routes host-level
peels through ``_profiled_peel``, the recompute discipline timed wave by
wave, as the reference does.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..obs import metrics as obs_metrics, trace as obs_trace
from . import distributed as dist
from .graph import (GraphSpec, GraphState, _endpoints, add_drop,
                    bitmap_sharding, build_bitmap, nonzero_padded,
                    partial_bitmap, set_drop, support, support_all,
                    support_all_bitmap, triangle_partners, update_bitmap)

_INF = 2**30
_I32 = torch.int32

# -- wave-level profiling (measurement mode; see set_wave_profile) ----------
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

_WAVE_PROFILE = False


def set_wave_profile(on: bool = True):
    """Toggle wave-level profiling process-wide (``serve_truss
    --wave-profile``).  While on, ``peel`` routes through a host-stepped
    recompute loop that times **each wave individually** — one device sync
    per wave, so this is a measurement mode, not a serving mode.  phi is
    unchanged (every engine computes the same decomposition); ``PeelStats``
    reflects the recompute discipline."""
    global _WAVE_PROFILE
    _WAVE_PROFILE = bool(on)


def wave_profile_enabled() -> bool:
    """Whether ``peel`` currently runs the host-stepped profiled loop."""
    return _WAVE_PROFILE


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
         engine: str = "auto", chunk: int = 64, mesh=None, device="cuda",
         profile: bool = True):
    """The one peel entry point every consumer routes through.

    ``engine='auto'`` picks ``delta`` for ``bitmap`` (incremental bit
    clearing + the fused ``peel_wave`` kernel) and ``recompute`` for
    ``sorted``, as the reference does.  Inputs are moved to ``device``
    (a no-op when they already live there).  ``mesh`` (a ``ShardMesh``)
    runs the peel over the shards of ``mesh[spec.shard_axis]``
    (``sharded_peel``); the state then moves to the first shard's device,
    which must be of ``device``'s kind, and a ``partition="nodes"`` bitmap
    is the list of its word slabs.  Under ``set_wave_profile`` the peel
    runs ``_profiled_peel`` unless ``profile`` is False: the fused batch
    engine passes False, since its re-peel runs inside a jit trace in the
    reference, where the profiled loop never runs.  Returns ``(phi,
    PeelStats)``.
    """
    if mesh is not None:
        device = dist.lead_device(mesh, spec.shard_axis, device)
    st = GraphState(*_on(device, *st))
    peel_mask = peel_mask.to(device)
    if isinstance(bitmap, torch.Tensor):   # word slabs stay on their shards
        bitmap = bitmap.to(device)
    if engine == "auto":
        engine = "delta" if method == "bitmap" else "recompute"
    if _WAVE_PROFILE and profile:
        return _profiled_peel(spec, st, peel_mask, method=method, mesh=mesh)
    if mesh is not None:
        return sharded_peel(spec, st, peel_mask, bitmap=bitmap, method=method,
                            engine=engine, mesh=mesh)
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
    _check_method(method)
    alive, phi, k = peel, st.phi, _scalar(3, st.phi)
    kills = _scalar(0, st.phi)
    waves = 0
    while waves < 8 * e_cap and bool(alive.any()):
        alive, phi, k, kill = _recompute_wave(spec, st, frozen, alive, phi, k,
                                              method)
        waves += 1
        kills = kills + _count(kill)
    return (torch.where(st.active, phi, 0),
            PeelStats(_scalar(waves, phi), kills, _scalar(0, phi),
                      _count(peel)))


def _check_method(method: str):
    if method not in ("bitmap", "sorted"):
        raise ValueError(f"unknown method {method!r}")


def _recompute_wave(spec, st, frozen, alive, phi, k, method):
    """One wave of the recompute discipline: the support of the whole
    qualifying subgraph, the level-k kills, and the level jump.  Returns
    ``(alive, phi, k, kill)``."""
    # an edge counts toward level-k support iff it is an unpeeled member of
    # the peel set or a frozen edge whose phi keeps it in the k-truss
    qual = alive | (frozen & (st.phi >= k))
    if method == "bitmap":
        sup = support_all_bitmap(spec, st, qual)
    else:
        sup = support_all(spec, st, qual)
    return _recompute_step(sup, frozen, st.phi, alive, phi, k)


def _recompute_step(sup, frozen, fphi, alive, phi, k):
    """The rest of a recompute wave, given the qualifying subgraph's
    support: the level-k kills and the level jump."""
    kill = alive & (sup < k - 2)
    any_kill = kill.any()
    phi = torch.where(kill, k - 1, phi)
    alive = alive & ~kill
    min_sup = torch.where(alive, sup, _INF).min()
    j2 = torch.where(frozen & (fphi >= k), fphi, _INF).min() + 1
    k_jump = torch.maximum(torch.minimum(min_sup + 3, j2), k + 1)
    k = torch.where(any_kill, k, k_jump)
    return alive, phi, k, kill


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profiled_peel(spec: GraphSpec, st: GraphState, peel_mask: torch.Tensor,
                   method: str = "sorted", mesh=None):
    """Host-stepped wave-profiled peel (``set_wave_profile``): the recompute
    discipline one wave at a time, each wave timed between two
    ``torch.cuda.synchronize()`` calls on the card.  phi is identical to
    every other engine (the wave discipline never changes the
    decomposition) and ``PeelStats`` reflects the recompute discipline
    (``deltas`` is 0).

    Per wave: ``truss_peel_wave_seconds`` observes the synced wall time and
    a ``peel.wave`` trace instant carries (wave, k, kills, dur_us).  Under
    a ``mesh``, one decision of the sharded engines (the packed 4-lane
    ``pmin`` over the shards, read on the host) is timed after each wave
    and ``truss_peel_wave_collective_share`` observes decision / wave: the
    sharded engines are bitwise equal wave for wave, so the profiled wave
    is the work a sharded wave does between decisions."""
    e_cap = spec.e_cap
    _check_method(method)
    dev = st.phi.device
    probe = None
    if mesh is not None:
        shard_devs = mesh.shard_devices(spec.shard_axis)

        def probe():
            _decision([torch.zeros(4, dtype=_I32, device=d)
                       for d in shard_devs])
            for d in dict.fromkeys(shard_devs):
                _sync(d)

        probe()   # first allocations and launches off the clock
    peel_m = peel_mask & st.active
    frozen = st.active & ~peel_m
    alive, phi, k = peel_m, st.phi, _scalar(3, st.phi)
    waves = kills = 0
    _sync(dev)
    while bool(alive.any()) and waves < 8 * e_cap:
        t0 = time.perf_counter()
        alive, phi, k, kill = _recompute_wave(spec, st, frozen, alive, phi, k,
                                              method)
        nk = int(_count(kill))      # a host read: the wave has run
        _sync(dev)
        dt = time.perf_counter() - t0
        waves += 1
        kills += nk
        _WAVE_S.observe(dt)
        obs_trace.instant("peel.wave", wave=waves, k=int(k), kills=nk,
                          dur_us=round(dt * 1e6, 1))
        if probe is not None and dt > 0:
            t1 = time.perf_counter()
            probe()
            _WAVE_COLL.observe(min(1.0, (time.perf_counter() - t1) / dt))
    return (torch.where(st.active, phi, 0),
            PeelStats(_scalar(waves, phi), _scalar(kills, phi),
                      _scalar(0, phi), _count(peel_m)))


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
        alive, phi, k, dead = _delta_step(sup, kill, peel, frozen, fphi,
                                          alive, phi, k)
        # clear the whole wave's bits at once — O(wave) real updates
        update_bitmap(spec, bm, st.edges[:, 0], st.edges[:, 1], dead,
                      set_bits=False)
        waves += 1
        kills = kills + _count(kill)
        deltas = deltas + 2 * _count(dead)
    return (torch.where(st.active, phi, 0),
            PeelStats(_scalar(waves, phi), kills, deltas))


def _delta_step(sup, kill, peel, frozen, fphi, alive, phi, k):
    """The rest of a delta bitmap wave, given its support and kill
    frontier: frozen edges past their level retire, kills take phi k - 1,
    the level jumps past dead levels.  Returns ``(alive, phi, k, dead)``."""
    retire = alive & frozen & (fphi < k)
    dead = kill | retire
    phi = torch.where(kill, k - 1, phi)
    alive = alive & ~dead
    k = _next_level(k, dead.any(), alive & peel, sup, alive & frozen, fphi)
    return alive, phi, k, dead


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


# ---------------------------------------------------------------------------
# mesh-partitioned engines — the same wave disciplines over a ShardMesh
# ---------------------------------------------------------------------------

def _decision(lanes):
    """The one exchange per wave that the edge-sharded loops read on the
    host: a packed 4-lane ``pmin`` over the shards carrying the global min
    peelable support, min frozen phi, any-dead and any-work flags (encoded
    0 = true, so min == logical any).  Each shard's lanes are an int32
    ``[4]`` tensor on its device.  Returns host ``(min_sup, min_frz,
    any_dead, go)``."""
    min_sup, min_frz, not_dead, not_work = dist.pmin(lanes)[0].tolist()
    return min_sup, min_frz, not_dead == 0, not_work == 0


def _go(masks) -> bool:
    """Whether any shard's mask has a set entry (one ``pmin``, one read)."""
    return _decision([torch.stack([_scalar(0, m), _scalar(0, m),
                                   _scalar(0, m), 1 - m.any().to(_I32)])
                      for m in masks])[3]


def _lanes(min_of, min_frz_of, any_dead, any_work):
    return torch.stack([min_of, min_frz_of, 1 - any_dead.to(_I32),
                        1 - any_work.to(_I32)])


def _row_blocks(spec: GraphSpec, devs, *tensors):
    """Each tensor's row blocks, block *s* on shard *s*'s device (views
    where the shard's device holds the tensor)."""
    blk = spec.e_cap // spec.n_shards
    return tuple([x[s * blk:(s + 1) * blk].to(d) for s, d in enumerate(devs)]
                 for x in tensors)


def _by_device(devs, per_shard) -> dict:
    """One entry per distinct device of a collective's per-shard results
    (shards on one device share one result)."""
    return dict(zip(devs, per_shard))


def _stats_on(lead, waves, kills, deltas, frontier) -> PeelStats:
    return PeelStats(torch.tensor(waves, dtype=_I32, device=lead),
                     kills.to(lead), deltas.to(lead), frontier.to(lead))


def sharded_peel(spec: GraphSpec, st: GraphState, peel_mask: torch.Tensor,
                 bitmap=None, method: str = "bitmap", engine: str = "delta",
                 mesh=None):
    """Mesh-partitioned ``peel``: same contract, same bits, many shards.

    ``st`` lies on the first shard's device (``shard_state``); each shard
    works its row block of the edge axis.  Cross-shard coupling is the
    decision ``pmin`` plus, for the bitmap methods, sums of disjoint-bit
    partial bitmaps (delta: wave 0 only, then the gathered dead edges
    clear their bits on each bitmap copy; recompute: the whole qualifying
    set each wave) or, for sorted recompute, an all-gather of the
    qualifying masks.  ``partition="nodes"`` with the bitmap method runs
    ``_partitioned_bitmap_peel``, whose ``bitmap`` is the list of word
    slabs.  Wave-by-wave arithmetic is the single-device loops', so phi
    and ``PeelStats`` are bitwise equal.
    """
    if mesh is None:
        raise ValueError("sharded_peel requires a mesh (use peel otherwise)")
    dist.require_mesh(mesh)
    if int(mesh.shape[spec.shard_axis]) != spec.n_shards:
        raise ValueError(
            f"mesh axis {spec.shard_axis!r} has "
            f"{int(mesh.shape[spec.shard_axis])} shards but spec declares "
            f"{spec.n_shards} shards (build the spec with graph.with_mesh)")
    if spec.partition == "nodes" and method == "bitmap":
        if engine not in ("delta", "recompute"):
            raise ValueError(f"unknown engine {engine!r}")
        return _partitioned_bitmap_peel(spec, st, peel_mask, bitmap, mesh,
                                        engine)
    if engine == "delta":
        if method != "bitmap":
            raise ValueError(
                "the sorted delta discipline is not mesh-partitioned (its "
                "chunk-admission order is global); use engine='recompute' "
                "or method='bitmap'")
        return _sharded_delta_bitmap(spec, st, peel_mask, bitmap, mesh)
    if engine != "recompute":
        raise ValueError(f"unknown engine {engine!r}")
    return _sharded_recompute(spec, st, peel_mask, mesh, method)


def _sharded_delta_bitmap(spec, st, peel_mask, bitmap, mesh):
    """Edge-sharded twin of ``_peel_bitmap``: K1 on each shard's row block
    against one bitmap copy per distinct device.  Every shard's K1 of a
    wave runs before any bit is cleared; then the shards' dead masks are
    gathered and one ``update_bitmap`` clear is applied to each copy —
    exactly the bits the reference's psum of dead partial bitmaps clears,
    without a zero-filled ``[N, W]`` partial per shard per wave."""
    from ..kernels import ops as kernel_ops  # kernels never import core

    devs = mesh.shard_devices(spec.shard_axis)
    lead = devs[0]
    edges, active, fphi, pm = _row_blocks(spec, devs, st.edges, st.active,
                                          st.phi, peel_mask)
    peelm = [p & a for p, a in zip(pm, active)]
    frozen = [a & ~p for a, p in zip(active, peelm)]
    alive = [p | (f & (x >= 3)) for p, f, x in zip(peelm, frozen, fphi)]
    eu, ev = zip(*(_endpoints(spec, e) for e in edges))
    full = {d: st.edges.to(d) for d in dict.fromkeys(devs)}

    # wave 0: the qualifying bitmap, summed from the shards' partials
    if bitmap is None:
        bms = _by_device(devs, dist.psum(
            [partial_bitmap(spec, e, a) for e, a in zip(edges, alive)]))
    elif not isinstance(bitmap, torch.Tensor):
        raise ValueError("a partition='replicated' bitmap is one [N, W] "
                         "tensor")
    else:
        # the provided bitmap covers st.active: clear the bits of edges
        # outside the initial qualifying set (frozen with phi < 3)
        out = _by_device(devs, dist.psum(
            [partial_bitmap(spec, e, a & ~q)
             for e, a, q in zip(edges, active, alive)]))
        bms = {d: bitmap.to(d) - b for d, b in out.items()}

    phi = list(fphi)
    kills = [_scalar(0, x) for x in fphi]
    deltas = [_scalar(0, x) for x in fphi]
    k, waves, go = 3, 0, _go(peelm)
    while go and waves < 8 * spec.e_cap:
        # the fused kernel on every shard's row block, before any clear
        outs = [kernel_ops.peel_wave_gathered(bms[d], u, v, a & p, k)
                for d, u, v, a, p in zip(devs, eu, ev, alive, peelm)]
        dead, lanes = [], []
        for s, (sup, kill) in enumerate(outs):
            retire = alive[s] & frozen[s] & (fphi[s] < k)
            dead.append(kill | retire)
            phi[s] = torch.where(kill, k - 1, phi[s])
            alive[s] = alive[s] & ~dead[s]
            kills[s] = kills[s] + _count(kill)
            deltas[s] = deltas[s] + 2 * _count(dead[s])
            work = alive[s] & peelm[s]
            lanes.append(_lanes(torch.where(work, sup, _INF).min(),
                                torch.where(alive[s] & frozen[s], fphi[s],
                                            _INF).min(),
                                dead[s].any(), work.any()))
        # the bit exchange: the wave's dead edges, gathered, cleared on
        # each bitmap copy
        gone = _by_device(devs, dist.all_gather(dead))
        for d, bm in bms.items():
            update_bitmap(spec, bm, full[d][:, 0], full[d][:, 1], gone[d],
                          set_bits=False)
        min_sup, min_frz, any_dead, go = _decision(lanes)
        if not any_dead:
            k = max(k + 1, min(min_sup + 3, min_frz + 1))
        waves += 1
    phi = torch.cat([torch.where(a, x, 0).to(lead)
                     for a, x in zip(active, phi)])
    return phi, _stats_on(lead, waves, dist.psum(kills)[0],
                          dist.psum(deltas)[0],
                          dist.psum([_count(p) for p in peelm])[0])


def _sharded_recompute(spec, st, peel_mask, mesh, method):
    """Edge-sharded twin of ``recompute_peel``: each wave recomputes the
    support of each shard's row block against the whole qualifying
    subgraph — K2 on the summed partial bitmaps (``bitmap``) or the
    adjacency rows against the all-gathered qualifying mask
    (``sorted``)."""
    from ..kernels import ops as kernel_ops  # kernels never import core

    _check_method(method)
    devs = mesh.shard_devices(spec.shard_axis)
    lead = devs[0]
    edges, active, fphi, pm = _row_blocks(spec, devs, st.edges, st.active,
                                          st.phi, peel_mask)
    peelm = [p & a for p, a in zip(pm, active)]
    frozen = [a & ~p for a, p in zip(active, peelm)]
    eu, ev = zip(*(_endpoints(spec, e) for e in edges))
    # node tables replicated, one copy per distinct device
    tables = {d: GraphState(*(x.to(d) for x in st))
              for d in dict.fromkeys(devs)}

    def sup_of(qual):
        if method == "bitmap":
            bms = dist.psum([partial_bitmap(spec, e, q)
                             for e, q in zip(edges, qual)])
            return [torch.where(q, kernel_ops.bitmap_support_gathered(
                bm, u, v), 0) for bm, u, v, q in zip(bms, eu, ev, qual)]
        qual_g = dist.all_gather(qual)
        return [torch.where(q, support(spec, tables[d], u, v, alive=g), 0)
                for d, u, v, q, g in zip(devs, eu, ev, qual, qual_g)]

    alive, phi = list(peelm), list(fphi)
    kills = [_scalar(0, x) for x in fphi]
    k, waves, go = 3, 0, _go(peelm)
    while go and waves < 8 * spec.e_cap:
        qual = [a | (f & (x >= k)) for a, f, x in zip(alive, frozen, fphi)]
        sups = sup_of(qual)
        lanes = []
        for s, sup in enumerate(sups):
            kill = alive[s] & (sup < k - 2)
            phi[s] = torch.where(kill, k - 1, phi[s])
            alive[s] = alive[s] & ~kill
            kills[s] = kills[s] + _count(kill)
            lanes.append(_lanes(torch.where(alive[s], sup, _INF).min(),
                                torch.where(frozen[s] & (fphi[s] >= k),
                                            fphi[s], _INF).min(),
                                kill.any(), alive[s].any()))
        min_sup, j2m, any_kill, go = _decision(lanes)
        if not any_kill:
            # level fixpoint -> jump k past dead levels (see recompute_peel)
            k = max(min(min_sup + 3, j2m + 1), k + 1)
        waves += 1
    phi = torch.cat([torch.where(a, x, 0).to(lead)
                     for a, x in zip(active, phi)])
    return phi, _stats_on(lead, waves, dist.psum(kills)[0],
                          _scalar(0, phi),
                          dist.psum([_count(p) for p in peelm])[0])


def _own_slabs(spec, bitmap, sh) -> list:
    """The engine's own copies of a node-partitioned bitmap's word slabs."""
    if not isinstance(bitmap, (list, tuple)) or len(bitmap) != len(sh.devices):
        raise ValueError(f"a partition='nodes' bitmap is a list of "
                         f"{len(sh.devices)} word slabs (graph."
                         f"build_bitmap_partitioned)")
    for slab in bitmap:
        if tuple(slab.shape) != (spec.n_nodes, sh.word_count):
            raise ValueError(f"word slab of shape {tuple(slab.shape)}, "
                             f"expected {(spec.n_nodes, sh.word_count)}")
    return [slab.to(d).clone() for slab, d in zip(bitmap, sh.devices)]


def _partitioned_bitmap_peel(spec, st, peel_mask, bitmap, mesh, engine):
    """Node-partitioned twin of ``_peel_bitmap`` / ``recompute_peel``
    (``spec.partition == "nodes"``): shard *s* holds only the bitmap word
    slab ``[:, s·Wb:(s+1)·Wb]`` — O(N·W/S) — and the edge-axis state runs
    replicated, one copy per distinct device, through the single-device
    wave arithmetic.

    A wave's one exchange is a ``psum`` of the shards' int32 partial
    supports (K2 on each slab): popcounts of disjoint columns sum to the
    full support, so the kills, phi and k are the replicated engines'.
    Bit clearing (delta) and slab rebuilds (recompute) are owner-local.
    ``PeelStats`` are the replicated values, not sums."""
    from ..kernels import ops as kernel_ops  # kernels never import core

    sh = bitmap_sharding(spec, mesh)
    devs, offs, wb = sh.devices, sh.word_offsets, sh.word_count
    lead = devs[0]
    reps = tuple(dict.fromkeys(devs))
    edges = {d: st.edges.to(d) for d in reps}
    active = {d: st.active.to(d) for d in reps}
    fphi = {d: st.phi.to(d) for d in reps}
    peelm = {d: peel_mask.to(d) & active[d] for d in reps}
    frozen = {d: active[d] & ~peelm[d] for d in reps}
    ends = {d: _endpoints(spec, edges[d]) for d in reps}

    def psum_sup(slabs):
        """Partial popcounts of each shard's slab, summed (the wave's one
        collective)."""
        return _by_device(devs, dist.psum([
            kernel_ops.bitmap_support_gathered(slab, *ends[d])
            for slab, d in zip(slabs, devs)]))

    def slabs_of(valid):
        return [partial_bitmap(spec, edges[d], valid[d], word_offset=o,
                               word_count=wb) for d, o in zip(devs, offs)]

    phi = dict(fphi)
    k = {d: _scalar(3, fphi[d]) for d in reps}
    kills = {d: _scalar(0, fphi[d]) for d in reps}
    deltas = {d: _scalar(0, fphi[d]) for d in reps}
    waves = 0
    if engine == "delta":
        alive = {d: peelm[d] | (frozen[d] & (fphi[d] >= 3)) for d in reps}
        if bitmap is None:
            slabs = slabs_of(alive)
        else:
            # the provided slabs cover st.active: drop the bits of edges
            # outside the initial qualifying set, owner-local
            slabs = _own_slabs(spec, bitmap, sh)
            for slab, d, o in zip(slabs, devs, offs):
                update_bitmap(spec, slab, edges[d][:, 0], edges[d][:, 1],
                              active[d] & ~alive[d], set_bits=False,
                              word_offset=o, word_count=wb)
        while (waves < 8 * spec.e_cap
               and bool((alive[lead] & peelm[lead]).any())):
            sups = psum_sup(slabs)
            dead = {}
            for d in reps:
                # threshold AFTER the sum: a slab's partial never meets k
                work = alive[d] & peelm[d]
                sup = torch.where(work, sups[d], 0)
                kill = work & (sup < k[d] - 2)
                alive[d], phi[d], k[d], dead[d] = _delta_step(
                    sup, kill, peelm[d], frozen[d], fphi[d], alive[d],
                    phi[d], k[d])
                kills[d] = kills[d] + _count(kill)
                deltas[d] = deltas[d] + 2 * _count(dead[d])
            for slab, d, o in zip(slabs, devs, offs):
                update_bitmap(spec, slab, edges[d][:, 0], edges[d][:, 1],
                              dead[d], set_bits=False, word_offset=o,
                              word_count=wb)
            waves += 1
    else:  # recompute: rebuild each shard's slab from qual every wave
        alive = dict(peelm)
        while waves < 8 * spec.e_cap and bool(alive[lead].any()):
            qual = {d: alive[d] | (frozen[d] & (fphi[d] >= k[d]))
                    for d in reps}
            sups = psum_sup(slabs_of(qual))
            for d in reps:
                alive[d], phi[d], k[d], kill = _recompute_step(
                    torch.where(qual[d], sups[d], 0), frozen[d], fphi[d],
                    alive[d], phi[d], k[d])
                kills[d] = kills[d] + _count(kill)
            waves += 1
    phi = torch.where(active[lead], phi[lead], 0)
    return phi, _stats_on(lead, waves, kills[lead], deltas[lead],
                          _count(peelm[lead]))
