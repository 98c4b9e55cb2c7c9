"""Gated profiler hooks around the stack's expensive regions.

The same API as ``repro.obs.profiling``: ``configure(profile_dir)`` arms
it, ``is_configured()`` says whether it is armed and under its trace cap,
and ``profile_region(name)`` wraps a region.  Not armed,
``profile_region`` is a no-op, as in the reference (the service enters it
around every flush).

Armed, it raises ``NotImplementedError``: the ``torch.profiler`` twin of
the reference's trace-per-region hook, with its guard against the device
records a session drops first, is ROADMAP item 12.  Raising keeps an armed
run from silently recording nothing.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

_DIR: str | None = None
_MAX = 8


def configure(profile_dir: str | None, max_traces: int = 8):
    """Arm (or, with ``None``, disarm) profiling into ``profile_dir``;
    ``max_traces`` caps the traces a process records (none is recorded
    until the twin lands)."""
    global _DIR, _MAX
    _DIR = profile_dir
    _MAX = int(max_traces)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)


def is_configured() -> bool:
    """Whether a profile directory is armed and under its trace cap."""
    return _DIR is not None and _MAX > 0


@contextmanager
def profile_region(name: str):
    """Context manager: a no-op unless armed; armed, raises
    ``NotImplementedError`` (the profiler twin is ROADMAP item 12)."""
    if is_configured():
        raise NotImplementedError(
            f"profile_region({name!r}): the torch.profiler twin of "
            "obs.profiling is not ported yet (ROADMAP item 12); call "
            "configure(None) to disarm")
    yield
