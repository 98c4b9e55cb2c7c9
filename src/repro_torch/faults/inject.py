"""Deterministic fault injection for the durability and peel paths.

``RealIO`` is the syscall surface ``TrussStore`` performs all its durable
work through: append-handle open, buffered write, fd/dir fsync, atomic
rename, truncate.  ``FaultyIO`` is the same surface with a *schedule* of
``Fault``s: each fault names an operation type and the (per-type) call
index it fires at, so a given ``(schedule, workload)`` pair replays
bit-for-bit — a failing chaos run is a reproducible artifact, not a
flake.  Injected errors are genuine ``OSError``s with real errnos (EIO,
ENOSPC), so production code paths cannot tell them from the disk doing it.

Supported fault kinds (``FAULT_KINDS``):

* ``fsync_eio``   — fsync raises EIO; ``arg`` > 0 additionally drops that
  many tail bytes first (lost dirty pages, the fsyncgate failure mode).
* ``enospc``      — a write lands only a prefix, then raises ENOSPC.
* ``torn_write``  — a write *silently* lands only a prefix (torn page).
* ``bitflip``     — a write lands fully with one bit flipped (``arg``
  selects the bit), modelling in-flight corruption.
* ``rename_fail`` — atomic replace raises EIO before renaming.

``FaultyIO`` also journals every operation (with its outcome), which is
how the dir-fsync-ordering regression tests assert that truncation,
compaction and snapshot renames are each followed by the parent-directory
fsync that makes them durable.

``PeelChaos`` injects *device-side* failures: it raises at a generation's
dispatch (optionally only for the delta engine, to exercise the
delta→recompute fallback) or at its landing, and ``flip_bit`` plants
at-rest bit-rot in finished files for scrub/recovery tests.
"""
from __future__ import annotations

import errno
import os
import random
from dataclasses import dataclass, field

from ..obs import metrics as obs_metrics, trace as obs_trace

_FAULTS_N = obs_metrics.counter(
    "truss_faults_injected_total", "chaos-plane faults injected, by kind",
    labels=("kind",))

#: injectable fault kinds, in the order the seeded scheduler cycles them.
FAULT_KINDS = ("fsync_eio", "enospc", "torn_write", "bitflip", "rename_fail")

#: the operation type each kind attaches to by default.
_KIND_OPS = {
    "fsync_eio": "fsync",
    "enospc": "write",
    "torn_write": "write",
    "bitflip": "write",
    "rename_fail": "replace",
}


class InjectedFault(RuntimeError):
    """Base class for non-IO injected failures (IO faults raise plain
    ``OSError`` with a real errno, indistinguishable from the disk)."""


class InjectedPeelFault(InjectedFault):
    """A device-side peel failure planted by ``PeelChaos``."""


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: fire on the ``at``-th operation of type ``op``.

    ``op`` defaults from the kind (``fsync_eio``→fsync, write corruptions
    →write, ``rename_fail``→replace) but can be overridden — e.g.
    ``op="fsync_path"`` targets directory fsyncs specifically.  ``arg``
    seeds the fault detail (bit index / tear split / dropped tail bytes);
    ``sticky`` keeps firing on every later matching operation until the
    schedule is cleared (a persistent outage rather than a glitch).
    """
    kind: str
    at: int = 0
    arg: int = 0
    sticky: bool = False
    op: str = field(default="")

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not self.op:
            object.__setattr__(self, "op", _KIND_OPS[self.kind])


def seeded_schedule(seed: int, n_faults: int = 1, kinds=FAULT_KINDS,
                    at_range: tuple[int, int] = (2, 30),
                    sticky: bool = False) -> list[Fault]:
    """A deterministic fault schedule: ``seed`` fully determines the kinds,
    firing indices and detail args.  ``at_range`` bounds the per-op-type
    firing index (the default skips the store-construction prefix so
    faults land mid-workload).  ``sticky=True`` turns every fault into a
    persistent outage (it keeps firing once reached) — that is what drives
    the circuit breaker open rather than being absorbed by one retry."""
    rng = random.Random(seed)
    return [Fault(kind=rng.choice(tuple(kinds)),
                  at=rng.randrange(*at_range),
                  arg=rng.randrange(1 << 16),
                  sticky=sticky)
            for _ in range(n_faults)]


def flip_bit(path: str, bit: int):
    """Flip one bit of ``path`` in place (at-rest bit-rot; ``bit`` is
    taken modulo the file's size in bits, so any integer is valid)."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot flip a bit in empty file {path}")
    bit %= size * 8
    with open(path, "r+b") as f:
        f.seek(bit // 8)
        byte = f.read(1)[0]
        f.seek(bit // 8)
        f.write(bytes([byte ^ (1 << (bit % 8))]))


class _AppendHandle:
    """A binary append handle whose writes route through the owning IO
    layer (so ``FaultyIO`` can tear/flip/abort them)."""

    def __init__(self, io: "RealIO", path: str):
        self._io = io
        self.path = path
        self._f = open(path, "ab")

    def write(self, data: bytes) -> int:
        """Append ``data`` via the IO layer's (possibly faulty) write."""
        return self._io._write(self._f, self.path, data)

    def flush(self):
        """Flush userspace buffers to the OS."""
        self._f.flush()

    def tell(self) -> int:
        """Current append offset."""
        return self._f.tell()

    def fileno(self) -> int:
        """Underlying file descriptor (for fsync)."""
        return self._f.fileno()

    def close(self):
        """Close the underlying handle."""
        self._f.close()


class RealIO:
    """The store's syscall surface with no faults — production default.

    Every durable operation ``TrussStore`` performs funnels through one of
    these methods, which is what makes the whole WAL/snapshot/commit path
    injectable: swap in a ``FaultyIO`` and the store cannot tell the
    difference until the disk "fails".
    """

    def open_append(self, path: str) -> _AppendHandle:
        """Open ``path`` for binary append."""
        return _AppendHandle(self, path)

    def _write(self, f, path: str, data: bytes) -> int:
        """Raw write on an open handle (hook point for fault injection)."""
        return f.write(data)

    def fsync(self, f):
        """fsync an open handle's descriptor."""
        os.fsync(f.fileno())

    def fsync_path(self, path: str):
        """Open-and-fsync a path (files after rename, parent directories)."""
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def replace(self, src: str, dst: str):
        """Atomic rename of ``src`` onto ``dst``."""
        os.replace(src, dst)

    def truncate(self, path: str, length: int):
        """Truncate ``path`` to ``length`` bytes."""
        with open(path, "rb+") as f:
            f.truncate(length)


class FaultyIO(RealIO):
    """``RealIO`` plus a deterministic fault schedule and an op journal.

    Operations of each type are counted from 0; a ``Fault`` fires when its
    type's counter reaches ``at`` (and keeps firing when ``sticky``).
    ``journal`` records ``(op, target, outcome)`` for every call —
    ``outcome`` is ``"ok"`` or the fault kind — so tests can assert
    *ordering* properties (e.g. every truncate/rename is followed by a
    parent-dir fsync) and not just outcomes.  ``injected`` counts fired
    faults by kind; ``clear()`` removes all remaining faults (the outage
    ends), and new faults can be planted live with ``inject()``.
    """

    def __init__(self, faults=()):
        self.faults: list[Fault] = list(faults)
        self.journal: list[tuple[str, str, str]] = []
        self.ops_seen: dict[str, int] = {}
        self.injected: dict[str, int] = {}
        # bytes written per path since its last successful fsync: the pool
        # of genuinely *dirty* pages a failing fsync may lose.  Bytes that
        # survived an fsync are durable — no fault model may drop them
        # (that would be bit-rot, a different fault kind)
        self._unsynced: dict[str, int] = {}

    def _dirtied(self, path: str, n: int):
        self._unsynced[path] = self._unsynced.get(path, 0) + n

    def inject(self, *faults: Fault):
        """Plant additional faults into the live schedule."""
        self.faults.extend(faults)

    def clear(self):
        """Drop every remaining scheduled fault (end of the outage)."""
        self.faults = []

    def _fire(self, op: str, target: str) -> Fault | None:
        """Advance the per-type op counter; return the fault to apply (and
        journal the outcome) or journal ``"ok"`` and return None."""
        idx = self.ops_seen.get(op, 0)
        self.ops_seen[op] = idx + 1
        hit = None
        for f in self.faults:
            if f.op == op and (idx == f.at or (f.sticky and idx >= f.at)):
                hit = f
                break
        if hit is not None and not hit.sticky:
            self.faults.remove(hit)
        outcome = hit.kind if hit is not None else "ok"
        self.journal.append((op, target, outcome))
        if hit is not None:
            self.injected[hit.kind] = self.injected.get(hit.kind, 0) + 1
            _FAULTS_N.labels(kind=hit.kind).inc()
            obs_trace.instant("fault.injected", kind=hit.kind, op=op,
                              at=idx, target=os.path.basename(target))
        return hit

    def _write(self, f, path: str, data: bytes) -> int:
        fault = self._fire("write", path)
        if fault is None or not data:
            self._dirtied(path, len(data))
            return f.write(data)
        if fault.kind == "bitflip":
            bit = fault.arg % (len(data) * 8)
            corrupt = bytearray(data)
            corrupt[bit // 8] ^= 1 << (bit % 8)
            self._dirtied(path, len(data))
            return f.write(bytes(corrupt))
        # enospc / torn_write: only a prefix reaches the file
        split = fault.arg % len(data)
        f.write(data[:split])
        f.flush()
        self._dirtied(path, split)
        if fault.kind == "enospc":
            raise OSError(errno.ENOSPC, f"injected ENOSPC writing {path}")
        return len(data)  # torn_write: silent short write

    def fsync(self, f):
        """Fsync, or raise injected EIO — optionally dropping up to
        ``arg % 64`` *unsynced* bytes first (the fsyncgate failure mode:
        dirty pages are lost, already-durable bytes are never touched)."""
        path = getattr(f, "path", "<fd>")
        fault = self._fire("fsync", path)
        if fault is not None:
            if fault.arg > 0:
                # lost dirty pages (the fsyncgate failure mode): only bytes
                # never yet fsynced are at risk — durable bytes stay put
                drop = min(fault.arg % 64, self._unsynced.get(path, 0))
                if drop:
                    size = os.fstat(f.fileno()).st_size
                    os.ftruncate(f.fileno(), max(0, size - drop))
                    self._unsynced[path] -= drop
            raise OSError(errno.EIO, "injected EIO on fsync")
        os.fsync(f.fileno())
        self._unsynced[path] = 0

    def fsync_path(self, path: str):
        """Directory/file fsync-by-path, or raise injected EIO."""
        fault = self._fire("fsync_path", path)
        if fault is not None:
            raise OSError(errno.EIO, f"injected EIO on fsync of {path}")
        super().fsync_path(path)

    def replace(self, src: str, dst: str):
        """Atomic rename, or raise injected EIO before it happens."""
        fault = self._fire("replace", dst)
        if fault is not None:
            raise OSError(errno.EIO, f"injected rename failure onto {dst}")
        super().replace(src, dst)

    def truncate(self, path: str, length: int):
        """Truncate (journaled for ordering assertions, never failed —
        it is the *repair* primitive, failing it tests nothing new)."""
        self._fire("truncate", path)  # journal-only: ordering evidence
        super().truncate(path, length)
        # callers truncate to a verified boundary before rewriting; treat
        # the result as clean (conservative: over-counting durable bytes
        # only makes a later fsync fault drop less, never more)
        self._unsynced[path] = 0


class PeelChaos:
    """Deterministic device-side peel failures, keyed by generation.

    ``dispatch_gens`` raise at those generations' dispatch — before any
    state mutates, so quarantine/retry semantics are clean; ``engines``
    restricts which engine attempts fail (the default fails the delta
    engine but lets ``recompute`` through, exercising the automatic
    fallback).  ``land_gens`` raise at the generation's *landing* instead
    (the result is lost in flight), which forces the service's
    self-heal-from-store path.  ``fail_all`` turns every dispatch into a
    failure until ``clear()`` — a persistent device outage.
    """

    def __init__(self, dispatch_gens=(), land_gens=(),
                 engines=("auto", "delta"), fail_all: bool = False):
        self.dispatch_gens = set(int(g) for g in dispatch_gens)
        self.land_gens = set(int(g) for g in land_gens)
        self.engines = tuple(engines)
        self.fail_all = bool(fail_all)
        self.injected = 0

    def clear(self):
        """End the outage: no further peel faults fire."""
        self.dispatch_gens = set()
        self.land_gens = set()
        self.fail_all = False

    def check_dispatch(self, gen: int, engine: str):
        """Raise ``InjectedPeelFault`` if this (generation, engine) dispatch
        is scheduled to fail."""
        if (self.fail_all or gen in self.dispatch_gens) \
                and engine in self.engines:
            self.injected += 1
            _FAULTS_N.labels(kind="peel_dispatch").inc()
            raise InjectedPeelFault(
                f"injected peel failure at gen {gen} ({engine})")

    def check_land(self, gen: int):
        """Raise ``InjectedPeelFault`` if this generation's landing is
        scheduled to fail."""
        if gen in self.land_gens:
            self.land_gens.discard(gen)
            self.injected += 1
            _FAULTS_N.labels(kind="peel_land").inc()
            raise InjectedPeelFault(f"injected land failure at gen {gen}")
