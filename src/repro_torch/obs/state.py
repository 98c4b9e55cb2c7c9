"""Process-wide observability switch — the one mutable flag everything gates on.

Lives in its own leaf module so ``obs.metrics`` / ``obs.trace`` can import
it without circular imports, and so the hot-path check is a single
attribute read (``STATE.enabled``) with no function-call overhead.  Toggle
through ``repro.obs.enable`` / ``repro.obs.disabled`` rather than poking
the flag directly.
"""
from __future__ import annotations


class _ObsState:
    """Holder for the process-wide enable flag (slots: one attr, no dict)."""

    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = True


STATE = _ObsState()
