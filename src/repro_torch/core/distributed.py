"""The shard mesh of the sharded truss substrate, its collectives, and the
distributed-decompose façade (PyTorch port of ``repro.core.distributed``).

The reference is single-controller SPMD: one process drives every device
through ``shard_map``, and its callers hand one ``Mesh`` to
``DynamicGraph(mesh=...)``, ``TrussService(mesh=...)`` and
``Replica(mesh=...)``.  The port keeps that program structure with a
``ShardMesh``: one process, one ``torch.device`` per shard (devices may
repeat: on one card every shard is ``cuda:0``), and explicit ``psum`` /
``pmin`` / ``pmax`` / ``all_gather`` over lists of per-shard tensors, each
result landing on every shard's device.  The same program runs unchanged
over several cards.

The façade drives a from-scratch decomposition over a raw edge list
through the shared engine (``peel(mesh=...)``):

* ``delta=True``  → ``engine='delta'``: wave 0 sums the shards' partial
  bitmaps of the qualifying set; later waves exchange only the edges each
  shard killed (O(Δ)) and clear their bits on every bitmap copy.
* ``delta=False`` → ``engine='recompute'``: every wave sums the partial
  bitmaps of the whole qualifying set.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .graph import GraphSpec, GraphState


class ShardMesh:
    """A named grid of shard devices driven by one process.

    ``devices``: one ``torch.device`` per mesh position, row-major over
    ``axis_names`` (positions may share a device).  ``shape``: a dict from
    axis name to size, so ``mesh.shape[spec.shard_axis]`` reads as in the
    reference.
    """

    def __init__(self, devices, axis_names=("shard",), shape=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = (len(self.devices),) if shape is None else tuple(
            int(x) for x in shape)
        if len(sizes) != len(self.axis_names) or \
                math.prod(sizes) != len(self.devices) or not self.devices:
            raise ValueError(f"{len(self.devices)} devices do not fill a mesh "
                             f"of shape {sizes} over {self.axis_names}")
        self.shape = dict(zip(self.axis_names, sizes))

    def shard_devices(self, axis: str) -> tuple:
        """The device of each position along ``axis`` (the other axes at
        position 0): the shards of a peel over that axis."""
        i = self.axis_names.index(axis)
        sizes = tuple(self.shape.values())
        stride = math.prod(sizes[i + 1:])
        return tuple(self.devices[s * stride] for s in range(sizes[i]))

    def __repr__(self):
        return (f"ShardMesh({[str(d) for d in self.devices]}, "
                f"shape={self.shape})")


def require_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``ShardMesh``."""
    if not isinstance(mesh, ShardMesh):
        raise TypeError(f"mesh must be a ShardMesh (launch.mesh."
                        f"make_shard_mesh), got {type(mesh).__name__}")


def lead_device(mesh, axis: str, device) -> torch.device:
    """The device that holds a mesh-placed ``GraphState``: the first shard's
    along ``axis``.  ``device`` (an entry point's ``device=``) must be of
    the same kind, so a caller asking for the CPU never gets the card."""
    require_mesh(mesh)
    lead = mesh.shard_devices(axis)[0]
    if torch.device(device).type != lead.type:
        raise ValueError(f"device={device!r} but the mesh's shards are on "
                         f"{lead.type} (build it with make_shard_mesh(..., "
                         f"device={torch.device(device).type!r}))")
    return lead


# ---------------------------------------------------------------------------
# collectives over per-shard tensors: each takes one tensor per shard (on
# that shard's device) and returns one result per shard, on its device.
# ``.to`` is a no-op where shards share a device, so shards on one device
# share one result tensor.
# ---------------------------------------------------------------------------

def _spread(total: torch.Tensor, parts) -> list:
    return [total.to(p.device) for p in parts]


def psum(parts) -> list:
    """Elementwise sum over shards, in the parts' dtype (int32 stays int32
    and wraps as uint32 does: disjoint bits sum to their OR)."""
    total = parts[0].clone()
    for p in parts[1:]:
        total.add_(p.to(total.device))
    return _spread(total, parts)


def pmin(parts) -> list:
    """Elementwise minimum over shards."""
    total = parts[0].clone()
    for p in parts[1:]:
        torch.minimum(total, p.to(total.device), out=total)
    return _spread(total, parts)


def pmax(parts) -> list:
    """Elementwise maximum over shards."""
    total = parts[0].clone()
    for p in parts[1:]:
        torch.maximum(total, p.to(total.device), out=total)
    return _spread(total, parts)


def all_gather(parts) -> list:
    """The shards' tensors concatenated along axis 0 (tiled)."""
    return _spread(torch.cat([p.to(parts[0].device) for p in parts]), parts)


# ---------------------------------------------------------------------------
# the façade
# ---------------------------------------------------------------------------

def _bitmap_state(spec: GraphSpec, edges, active) -> GraphState:
    """Minimal GraphState for a bitmap-method peel: the bitmap disciplines
    read only the edge-axis arrays, so the node tables are 1-wide dummies."""
    n, dev = spec.n_nodes, edges.device
    return GraphState(
        edges=edges, active=active,
        phi=torch.zeros((spec.e_cap,), dtype=torch.int32, device=dev),
        nbr=torch.full((n, 1), n, dtype=torch.int32, device=dev),
        eid=torch.full((n, 1), spec.e_cap, dtype=torch.int32, device=dev),
        deg=torch.zeros((n,), dtype=torch.int32, device=dev))


def make_distributed_decompose(spec: GraphSpec, mesh: ShardMesh,
                               axis: str = "data", delta: bool = False):
    """Returns a fn (edges int32 [E, 2], active bool [E]) -> phi [E].

    ``E`` must be a multiple of the mesh axis size (pad with inactive
    sentinel rows; ``distributed_decompose`` does this for host edge
    lists).  The body is the shared engine's sharded loop."""
    from .peel import peel  # peel imports this module's collectives

    require_mesh(mesh)
    s = int(mesh.shape[axis])

    def fn(edges, active):
        e = int(edges.shape[0])
        sspec = dataclasses.replace(spec, e_cap=e, n_shards=s, shard_axis=axis)
        st = _bitmap_state(sspec, edges, active)
        phi, _ = peel(sspec, st, active, method="bitmap",
                      engine="delta" if delta else "recompute", mesh=mesh,
                      device=edges.device)
        return phi

    return fn


def distributed_decompose(spec: GraphSpec, mesh: ShardMesh,
                          edges_np: np.ndarray, axis: str = "data",
                          delta: bool = False) -> np.ndarray:
    """Host convenience: pad a host edge list to the shard count, run on
    the mesh, return phi [m] on the host."""
    require_mesh(mesh)
    m = len(edges_np)
    dp = int(mesh.shape[axis])
    e_pad = -(-m // dp) * dp
    edges = np.full((e_pad, 2), spec.n_nodes, np.int32)
    edges[:m] = edges_np
    active = np.zeros((e_pad,), bool)
    active[:m] = True
    dev = mesh.shard_devices(axis)[0]
    fn = make_distributed_decompose(spec, mesh, axis, delta)
    phi = fn(torch.from_numpy(edges).to(dev), torch.from_numpy(active).to(dev))
    return phi.cpu().numpy()[:m]
