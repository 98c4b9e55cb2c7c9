"""Shard meshes for the sharded truss substrate (port of the truss half of
``repro.launch.mesh``).

Unlike the reference's ``make_shard_mesh``, which raises when there are
fewer devices than shards, shards here may outnumber the visible devices:
they cycle over them (``cuda:{s % device_count}``), so one H100 runs any
shard count with every shard on ``cuda:0`` (ROADMAP R6).
"""
from __future__ import annotations

import math

import torch

from ..core.distributed import ShardMesh


def _visible(device) -> list:
    """The visible devices of ``device``'s kind (the CPU is one device)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
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
