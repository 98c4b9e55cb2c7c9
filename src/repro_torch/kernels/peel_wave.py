"""Hopper kernel K1: the fused peel wave — support and kill frontier.

Replaces ``repro/kernels/peel_wave.py::peel_wave_kernel``: for each row
pair, ``sup = Σ_w popcount(a & b)`` masked to 0 outside ``alive`` and
``kill = alive & (sup < k - 2)``, with ``k`` a device scalar so one kernel
serves every peel level.  The CUDA source is ``csrc/bitmap_popcount.cu``;
its note says what bounds it on an H100 (device-memory bytes) and what
each body does about it.  The peel engine calls the gathered entry (rows
read straight from the ``[N, W]`` bitmap by endpoint ids), so the
reference's per-wave ``[E, W]`` row gathers never exist; it runs the
digest body (only the rows of alive slots are digested, and each alive
slot probes from its sparser endpoint) unless ``body="direct"`` asks for
the direct body, which the rows entry runs.  Plain version:
``ref.peel_wave_ref``.
"""
from __future__ import annotations

import torch

from . import _build
from .bitmap_support import digest_args, row_pair_args

#: launches of this kernel since import (reset by callers that count a run)
LAUNCHES = 0
#: the same launches by body
LAUNCHES_BY_BODY = {"digest": 0, "direct": 0}


def peel_wave_launcher(a: torch.Tensor, b: torch.Tensor, alive: torch.Tensor,
                       k, ia=None, ib=None, body: str | None = None,
                       capacity: int | None = None):
    """Check a K1 launch and bind its C entry on the current stream.
    Returns ``(body, launch, (sup, kill))``: each ``launch()`` enqueues the
    kernel into ``sup``/``kill`` and raises on a refused launch; it counts
    nothing."""
    a_p, b_p, stride, ia_p, ib_p, n, nw = row_pair_args(a, b, ia, ib, 0, None)
    if (alive.device != a.device or alive.dtype not in (torch.bool, torch.uint8)
            or alive.shape != (n,) or not alive.is_contiguous()):
        raise ValueError(f"alive: need a contiguous bool [{n}] tensor on "
                         f"{a.device}, got {alive.dtype} {tuple(alive.shape)}")
    body, capacity, ws = digest_args(a, b, ia, nw, body, capacity)
    k = torch.as_tensor(k, dtype=torch.int32, device=a.device).reshape(())
    sup = torch.empty((n,), dtype=torch.int32, device=a.device)
    kill = torch.empty((n,), dtype=torch.bool, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = _build.library()
    if body == "digest":
        entry, args = lib.peel_wave_digest_launch, (
            a_p, stride, a.shape[0], ia_p, ib_p, n, nw, capacity,
            alive.data_ptr(), k.data_ptr(), sup.data_ptr(), kill.data_ptr(),
            ws.data_ptr() if ws is not None else None, stream)
    else:
        entry, args = lib.peel_wave_launch, (
            a_p, b_p, stride, ia_p, ib_p, n, nw, alive.data_ptr(),
            k.data_ptr(), sup.data_ptr(), kill.data_ptr(), stream)

    def launch(keep=(a, b, ia, ib, alive, k, ws)):   # alive while bound
        with torch.cuda.device(a.device):
            _build.check(entry(*args), f"peel_wave ({body})")
    return body, launch, (sup, kill)


def peel_wave_cuda(a: torch.Tensor, b: torch.Tensor, alive: torch.Tensor, k,
                   ia=None, ib=None, body: str | None = None,
                   capacity: int | None = None):
    """Launch K1 over row pairs (see ``bitmap_support.row_pair_args`` for
    the addressing, ``bitmap_support.digest_args`` for ``body`` and
    ``capacity``).  Returns ``(sup int32[E], kill bool[E])``."""
    global LAUNCHES
    body, launch, out = peel_wave_launcher(a, b, alive, k, ia, ib, body,
                                           capacity)
    if out[0].numel() == 0:
        return out
    launch()
    LAUNCHES += 1
    LAUNCHES_BY_BODY[body] += 1
    return out
