"""Batch truss decomposition — the paper's ``batchUpdate`` building block.

A thin façade over the shared peel engine (``peel.py``): a full
decomposition is a peel of the whole active set with an empty frozen
boundary.  ``engine``: ``delta`` (incremental support maintenance),
``recompute`` (per-wave full recomputation) or ``auto`` (the reference's
per-method choice).

``phi`` semantics: an edge stripped at level k gets phi = k-1.
"""
from __future__ import annotations

import torch

from ..obs import profiling, trace
from .graph import GraphSpec, GraphState
from .peel import PeelStats, peel as run_peel


def decompose_with_stats(spec: GraphSpec, st: GraphState,
                         method: str = "sorted", engine: str = "auto",
                         chunk: int = 64, bitmap: torch.Tensor | None = None,
                         mesh=None, device="cuda") -> tuple[torch.Tensor, PeelStats]:
    """Return ``(phi[E_cap], PeelStats)`` for the active subgraph of ``st``.

    method: 'sorted' (searchsorted row intersection) or 'bitmap'
            (adjacency-bitmap AND + popcount, the CUDA-kernel path).
    engine: 'auto' | 'delta' | 'recompute' (see ``peel.peel``).
    bitmap: optional cached adjacency bitmap of ``st.active`` (its word
            slabs under ``partition="nodes"``).
    mesh:   optional ``ShardMesh`` — run the peel over its shards along
            ``spec.shard_axis`` (bitwise equal; ``distributed.py`` is a
            host-side façade over the same argument).
    device: where the peel runs (inputs are moved there; under a mesh,
            its first shard's device, of the same kind).

    Host-level entry, so it carries the ``decompose`` trace span and the
    ``--profile-dir`` ``torch.profiler`` region.
    """
    with trace.span("decompose", method=method, engine=engine,
                    e_cap=spec.e_cap):
        with profiling.profile_region("decompose"):
            return run_peel(spec, st, st.active, bitmap=bitmap, method=method,
                            engine=engine, chunk=chunk, mesh=mesh,
                            device=device)


def decompose(spec: GraphSpec, st: GraphState, method: str = "sorted",
              engine: str = "auto", chunk: int = 64,
              bitmap: torch.Tensor | None = None, mesh=None,
              device="cuda") -> torch.Tensor:
    """``decompose_with_stats`` without the stats: just phi[E_cap]."""
    phi, _ = decompose_with_stats(spec, st, method, engine, chunk,
                                  bitmap=bitmap, mesh=mesh, device=device)
    return phi


def decompose_and_set(spec: GraphSpec, st: GraphState, method: str = "sorted",
                      bitmap: torch.Tensor | None = None, mesh=None,
                      device="cuda") -> GraphState:
    """Convenience: run ``decompose`` and return the state with phi installed."""
    phi = decompose(spec, st, method, bitmap=bitmap, mesh=mesh, device=device)
    return GraphState(*(x.to(phi.device) for x in st))._replace(phi=phi)
