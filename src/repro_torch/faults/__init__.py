"""Chaos plane: deterministic fault injection and resilience primitives.

Evolving networks never stop, so the maintenance engine must survive more
than clean crashes: disks return EIO from fsync, appends die mid-write
with ENOSPC, pages tear, bits rot, and the device-side peel itself can
fail.  This package supplies the three legs the serving stack stands on
when that happens:

* :mod:`repro_torch.faults.inject` — ``RealIO`` (the store's default syscall
  surface) and ``FaultyIO`` (the same surface with a *deterministic,
  seeded* fault schedule: every injected fault is a pure function of the
  schedule and the operation index, so a failing chaos run replays
  exactly).  ``PeelChaos`` injects device-side peel failures by
  generation, and ``flip_bit`` plants at-rest bit-rot for scrub/recovery
  tests.
* :mod:`repro_torch.faults.retry` — ``RetryPolicy`` (capped decorrelated-jitter
  backoff with max-attempt and deadline bounds) and ``CircuitBreaker``
  (closed/open/half-open) shared by the service flush path, the query
  router, and the CLI submit loop.
* :mod:`repro_torch.faults.crc` — pure-Python table-driven CRC32C, the per-record
  WAL v2 checksum and the scrubber's integrity primitive.

Everything here is dependency-free and deterministic under a fixed seed;
``tests/test_torch_chaos.py`` drives a sample of seeded schedules through
it.
"""
from .crc import crc32c
from .inject import (FAULT_KINDS, Fault, FaultyIO, InjectedFault,
                     InjectedPeelFault, PeelChaos, RealIO, flip_bit,
                     seeded_schedule)
from .retry import CircuitBreaker, RetryExhausted, RetryPolicy

__all__ = [
    "crc32c",
    "FAULT_KINDS", "Fault", "FaultyIO", "InjectedFault", "InjectedPeelFault",
    "PeelChaos", "RealIO", "flip_bit", "seeded_schedule",
    "CircuitBreaker", "RetryExhausted", "RetryPolicy",
]
