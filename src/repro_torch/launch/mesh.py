"""Meshes and sharding annotations (port of ``repro.launch.mesh``).

The truss half: ``make_shard_mesh`` / ``make_test_mesh``.  Unlike the
reference's ``make_shard_mesh``, which raises when there are fewer devices
than shards, shards here may outnumber the visible devices: they cycle over
them (``cuda:{s % device_count}``), so one H100 runs any shard count with
every shard on ``cuda:0`` (ROADMAP R6).

The LM half: ``make_production_mesh`` (single pod ``(16, 16)`` over
``("data", "model")``; multi-pod ``(2, 16, 16)`` over ``("pod", "data",
"model")``, the pod axis pure data parallelism), its positions cycling over
the visible devices of ``device``'s kind as well (``"meta"`` included, for
the dry-run), and the sharding annotations the cell plans
(``launch/specs.py``) carry: ``PartitionSpec`` and ``NamedSharding``, the
port's own, since PyTorch's ``DeviceMesh`` needs a process group and a
``ShardMesh`` is one process.  ``NamedSharding.shard_shape`` follows jax's:
each named dim divided by the product of its axes' sizes, which must divide
it.
"""
from __future__ import annotations

import math

import torch

from ..core.distributed import ShardMesh


def _visible(device) -> list:
    """The visible devices of ``device``'s kind (the CPU and ``meta`` are
    one device each)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind in ("cpu", "meta"):
        return [torch.device(kind)]
    raise ValueError(f"no shard devices of kind {kind!r}")


def _cycle(n: int, device) -> list:
    vis = _visible(device)
    if not vis:
        raise RuntimeError(f"no {torch.device(device).type} device is visible")
    if n < 1:
        raise ValueError(f"need at least one shard, got {n}")
    return [vis[s % len(vis)] for s in range(n)]


def make_shard_mesh(n_shards: int | None = None, axis: str = "shard",
                    device="cuda") -> ShardMesh:
    """1-D mesh for the sharded peel substrate (``GraphSpec.shard_axis``).
    ``n_shards=None`` takes every visible device of ``device``'s kind;
    more shards than devices cycle over them."""
    n = len(_visible(device)) if n_shards is None else int(n_shards)
    return ShardMesh(_cycle(n, device), (axis,))


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device="cuda") -> ShardMesh:
    """A mesh of ``shape`` over ``axes``, positions cycling over the
    visible devices of ``device``'s kind."""
    return ShardMesh(_cycle(math.prod(shape), device), axes, shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> ShardMesh:
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` over ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes, device)


def dp_axes(mesh: ShardMesh) -> tuple:
    """The combined pure-data-parallel axes of a mesh."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def model_size(mesh: ShardMesh) -> int:
    return mesh.shape["model"]


# ---------------------------------------------------------------------------
# sharding annotations
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """jax's ``PartitionSpec``: one entry a dim, each None (replicated), an
    axis name, or a tuple of axis names; a one-name tuple reads as the
    name, as jax normalises it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A ``PartitionSpec`` over a mesh's named axes (an annotation: nothing
    is placed by it)."""

    def __init__(self, mesh: ShardMesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def shard_shape(self, global_shape) -> tuple:
        """The shape of one position's shard of an array of
        ``global_shape``: each dim divided by the product of the sizes of
        the axes it is named on.  Raises ``ValueError`` where a dim is not
        divisible, or the spec has more entries than the array dims."""
        shape = tuple(int(x) for x in global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec!r} has more entries than the "
                             f"{len(shape)} dims of {shape}")
        out = []
        for dim, (n, part) in enumerate(zip(shape, tuple(self.spec) + (None,) * (
                len(shape) - len(self.spec)))):
            axes = () if part is None else (
                part if isinstance(part, tuple) else (part,))
            ways = math.prod(self.mesh.shape[a] for a in axes)
            if n % ways:
                raise ValueError(f"{self!r} splits dim {dim} of {shape} "
                                 f"{ways} ways, which does not divide {n}")
            out.append(n // ways)
        return tuple(out)


def named(mesh: ShardMesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated(mesh: ShardMesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
