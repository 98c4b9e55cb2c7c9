"""Durable state for the truss service: checksummed WAL + snapshot.

The WAL is the source of truth for writes: every acknowledged update is
appended (with the generation it will commit in) *before* it is applied to
the in-memory graph, and the log is fsynced at every generation flush and
snapshot.  A process crash at any point therefore loses nothing that was
acked; an OS/power failure additionally bounds the loss to writes acked
since the last generation boundary (appends between boundaries sit in the
OS page cache).
A snapshot checkpoints the full oracle state — ``GraphSpec`` capacities,
``GraphState`` arrays (edges/active/phi/nbr/eid/deg), committed generation,
and the WAL high-water mark — through ``training.checkpoint`` (atomic rename,
dtype-tagged ``np.savez``), so recovery is

    restore last snapshot  +  replay the WAL tail past its high-water mark

and lands on the *exact* phi the live service had (Wang & Cheng's
out-of-core framing: truss state that survives the process).

**WAL v2 (checksummed records).**  Each record line carries a CRC32C of
its body (``gen op a b c<crc32c-hex>``) and the ``# base`` compaction
header carries one too, so *any* single-bit corruption — in flight or at
rest — is detected rather than replayed into the graph (see
``docs/WAL_FORMAT.md`` for the grammar and the proof sketch that no
single-bit flip can masquerade as a valid v1 or v2 record).  Legacy v1
records (four integers, no checksum) are still read.  Detection feeds
three recovery paths, classified against the committed frontier:

* **torn tail** (final record cut at EOF) — truncate at the last valid
  record, exactly as v1 did, now followed by file + parent-dir fsyncs;
* **corrupt above the frontier** — the damaged suffix is copied to
  ``quarantine/`` (with a JSON sidecar recording the cut index and
  reason) and the log is truncated at the last valid record: acked but
  uncommitted work is surfaced, never silently replayed;
* **corrupt below the frontier** — committed data is damaged; the suffix
  is quarantined and ``WalCorruptionError`` raises loudly (the snapshot
  fallback, not silent truncation, is the recovery path).

**Verified fsync.**  The store keeps the unsynced record bytes in memory
and, at every ``fsync``, reads the on-disk tail back and compares: a torn
or bit-flipped write (the page cache lying) is repaired by rewriting the
tail from memory before the sync — this is what makes "zero acked-write
loss below the committed frontier" hold even under write-path corruption.

**Snapshot manifests and fallback.**  ``snapshot.npz`` gets a manifest
sidecar (SHA-256 digest, size, WAL high-water mark); the previous
snapshot+manifest rotate to ``*.prev`` instead of being deleted, and the
WAL compacts only to the *previous* snapshot's high-water mark.  A
corrupt current snapshot is therefore recoverable: quarantine it, load
``.prev``, replay the (longer) retained tail.  ``scrub()`` audits all of
it — record checksums, manifest digests, commit-frontier sanity — on a
live store without stopping ingest.

The same machinery doubles as a **physical replication stream** (the
replica cluster, ``repro_torch.cluster``): a store opened with ``readonly=True``
never mutates the directory (no torn-tail truncation, no append handle,
no quarantine) and can tail the primary's log with ``read_wal``; two
sidecar metadata files coordinate the cluster without touching the log format:

* ``commit.json`` — the primary's committed frontier ``(gen, wal_len)``,
  atomically replaced at every generation flush.  Records below the
  frontier form *complete* generation groups, so a replica that applies
  exactly up to it commits the same batches the primary did (bitwise-equal
  phi at every generation boundary).
* ``replicas/<id>.json`` — per-replica lease files (applied gen, applied
  WAL index, wall-clock heartbeat) published by each tailer; the primary's
  ``stats()`` and the router read these for lag reporting and stale-lease
  eviction.

Layout of a store directory::

    <root>/wal.log                 optional "# base <n> c<crc>" header,
                                   then append-only "gen op a b c<crc>"
                                   records, one per line
    <root>/snapshot.npz            latest checkpoint (atomic-renamed)
    <root>/snapshot.npz.manifest.json  digest sidecar {algo,digest,size,wal_len}
    <root>/snapshot.npz.prev[...]  previous checkpoint + manifest (fallback)
    <root>/commit.json             committed frontier {gen, wal_len}
    <root>/replicas/               per-replica leases {gen, wal_applied, ts}
    <root>/quarantine/             damaged bytes + poisoned-generation records

All syscalls route through an injectable IO layer (``repro_torch.faults`` —
``RealIO`` in production, ``FaultyIO`` under chaos testing), so every
recovery path above is exercised by deterministic fault schedules.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

from ..faults.crc import crc32c
from ..faults.inject import RealIO
from ..obs import metrics as obs_metrics, trace as obs_trace
from ..training import checkpoint

_APPEND_S = obs_metrics.histogram(
    "truss_wal_append_seconds", "WAL append latency per append call")
_APPEND_RECS = obs_metrics.counter(
    "truss_wal_append_records_total", "records appended to the WAL")
_FSYNC_S = obs_metrics.histogram(
    "truss_wal_fsync_seconds", "WAL fsync latency (real syncs only)")
_FSYNC_N = obs_metrics.counter(
    "truss_wal_fsync_total", "real WAL fsyncs (dirty-skip no-ops excluded)")
_SNAP_N = obs_metrics.counter(
    "truss_snapshot_total", "snapshots checkpointed (each compacts the WAL)")
_CRC_FAIL_N = obs_metrics.counter(
    "truss_wal_crc_failures_total",
    "WAL records rejected by checksum/format verification")
_REWRITE_N = obs_metrics.counter(
    "truss_wal_rewrites_total",
    "unsynced WAL tails repaired from memory at fsync read-back")
_QUAR_BYTES = obs_metrics.counter(
    "truss_wal_quarantine_bytes_total", "damaged WAL bytes quarantined")
_QUAR_N = obs_metrics.counter(
    "truss_quarantine_total", "quarantine entries written, by kind",
    labels=("kind",))
_SNAP_FALLBACK_N = obs_metrics.counter(
    "truss_snapshot_fallback_total",
    "restores served by the .prev snapshot after main verification failed")
_SCRUB_N = obs_metrics.counter("truss_scrub_total", "scrub passes run")
_SCRUB_VIOL_N = obs_metrics.counter(
    "truss_scrub_violations_total", "invariant violations found by scrub")

_SNAPSHOT = "snapshot.npz"
_WAL = "wal.log"
_COMMIT = "commit.json"
_REPLICAS = "replicas"
_QUARANTINE = "quarantine"
_MANIFEST_SUFFIX = ".manifest.json"
_PREV_SUFFIX = ".prev"
_BASE_PREFIX = "# base "
_TRACE_PREFIX = "# trace "


class WalCorruptionError(RuntimeError):
    """Checksum-verified WAL data *below the committed frontier* is damaged
    — committed state cannot be reconstructed from this log alone, so the
    store refuses to open/serve rather than silently diverge."""


class SnapshotCorruptionError(RuntimeError):
    """Neither the current snapshot nor its ``.prev`` fallback passed
    digest verification (or loaded)."""


def _sha256_file(path: str) -> str:
    """Streaming SHA-256 hex digest of a file (snapshot manifests)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class TrussStore:
    """WAL + snapshot directory. One writer (the service); any reader.

    ``readonly=True`` opens the directory as a replication *consumer*: all
    mutating entry points raise, the init scan never truncates a torn tail
    (the primary may still be completing it), and ``read_wal`` keeps working
    as the primary appends/compacts underneath.

    ``io`` swaps the syscall surface (``repro_torch.faults.RealIO`` by default;
    a ``FaultyIO`` under chaos testing).  ``checksum=False`` writes legacy
    v1 records — kept only for the clean-path overhead A/B in
    ``benchmarks/chaos_availability.py``; readers accept both formats.
    """

    def __init__(self, root: str, readonly: bool = False, io=None,
                 checksum: bool = True):
        self.root = root
        self.readonly = readonly
        self._io = io if io is not None else RealIO()
        self.checksum = bool(checksum)
        if not readonly:
            os.makedirs(root, exist_ok=True)
        self.wal_path = os.path.join(root, _WAL)
        self.snap_path = os.path.join(root, _SNAPSHOT)
        self.manifest_path = self.snap_path + _MANIFEST_SUFFIX
        self.base = 0     # records compacted away into the snapshot
        self.wal_len = 0  # global record count (base + records on disk)
        self._wal_f = None
        # read_wal tail cache: (byte offset, global index) just past the last
        # fully-parsed record, so repeated tailing is O(new records) instead
        # of an O(history) rescan.  Invalidated on compaction / rollback.
        self._tail_cache: tuple[int, int] | None = None
        # why the last read_wal/init scan stopped early: ("torn"|"corrupt",
        # global index) — replicas read this to tell a live append tail
        # from damage below the frontier
        self.stopped: tuple[str, int] | None = None
        # trace annotations seen by scans/tailing: {gen: trace_id}.  These
        # ride in the log as checksummed comment lines (``# trace ...``)
        # and never count toward record indexing.
        self._annots: dict[int, str] = {}
        valid_bytes = self._scan()
        if not readonly:
            self._repair_tail(valid_bytes)
            self._wal_f = self._io.open_append(self.wal_path)
        self._synced_len = self.wal_len  # records already fsynced to disk
        self._synced_off = valid_bytes   # byte offset of the verified prefix
        self._tail_records: list[bytes] = []  # unsynced bytes (fsync verify)

    def _scan(self) -> int:
        """Count complete, checksum-valid records; returns the byte length
        of the valid prefix and records why the scan stopped (if it did)
        in ``self.stopped``."""
        if not os.path.exists(self.wal_path):
            return 0
        valid_bytes = 0
        with open(self.wal_path, "rb") as f:
            for i, line in enumerate(f):
                if i == 0:
                    hdr = self._parse_header(line)
                    if hdr == "corrupt":
                        self.stopped = ("corrupt", 0)
                        return 0
                    if hdr is not None:
                        self.base = hdr
                        valid_bytes += len(line)
                        continue
                if not line.endswith(b"\n"):
                    self.stopped = ("torn", self.base + self.wal_len)
                    break
                status, rec = self._classify(line)
                if status == "corrupt":
                    self.stopped = ("corrupt", self.base + self.wal_len)
                    break
                valid_bytes += len(line)
                if status == "annot":
                    self._annots[rec[0]] = rec[1]
                    continue  # annotations are not records
                self.wal_len += 1
        self.wal_len += self.base
        return valid_bytes

    def _repair_tail(self, valid_bytes: int):
        """Writable-open recovery: classify damage after the valid prefix
        against the committed frontier, quarantine the damaged suffix,
        truncate at the last valid record (file + dir fsynced — a crash
        mid-repair must not resurrect the damage), or raise when the
        damage sits below the frontier (committed data)."""
        if not os.path.exists(self.wal_path):
            return
        size = os.path.getsize(self.wal_path)
        if valid_bytes >= size:
            return
        kind, idx = self.stopped or ("torn", self.wal_len)
        if kind == "corrupt":
            _CRC_FAIL_N.inc()
            with open(self.wal_path, "rb") as f:
                f.seek(valid_bytes)
                damaged = f.read()
            commit = self.read_commit()
            frontier = None if commit is None else int(commit["wal_len"])
            below = frontier is not None and idx < frontier
            reason = ("crc-failure below committed frontier" if below
                      else "crc-failure above committed frontier")
            self._quarantine_bytes(damaged, idx, reason)
            if below:
                raise WalCorruptionError(
                    f"WAL record {idx} is corrupt below the committed "
                    f"frontier {frontier}: committed state cannot be "
                    f"replayed from this log (quarantined; restore from "
                    f"snapshot)")
        obs_trace.instant("wal.truncate_tail", at=valid_bytes,
                          dropped=size - valid_bytes, kind=kind)
        self._io.truncate(self.wal_path, valid_bytes)
        self._io.fsync_path(self.wal_path)
        self._io.fsync_path(self.root)
        self.stopped = None

    def _check_writable(self):
        if self.readonly:
            raise ValueError("store is open read-only (replica tailer)")

    # -- record grammar ------------------------------------------------------
    def _encode(self, gen: int, op: int, a: int, b: int) -> bytes:
        """One WAL line: v2 appends ``c<crc32c>`` over the 4-int body."""
        body = f"{int(gen)} {int(op)} {int(a)} {int(b)}"
        if self.checksum:
            return f"{body} c{crc32c(body.encode()):08x}\n".encode()
        return f"{body}\n".encode()

    @staticmethod
    def _classify(line: bytes):
        """``("ok"|"legacy", record)`` for a valid v2/v1 line,
        ``("annot", (gen, trace_id))`` for a checksummed ``# trace``
        annotation, else ``("corrupt", None)``.  The v2 checksum field is
        tagged ``c`` so a single-bit flip can never turn a v2 line into a
        well-formed v1 line (the tag survives any field merge).
        Annotations are comment lines, so readers that predate them (and
        the v1 grammar) skip them without miscounting records."""
        if line.startswith(_TRACE_PREFIX.encode()):
            parts = line.split()
            if len(parts) != 5:
                return "corrupt", None
            tag = parts[4]
            if (len(tag) != 9 or not tag.startswith(b"c")
                    or tag[1:].translate(None, b"0123456789abcdef")):
                return "corrupt", None
            if crc32c(b" ".join(parts[:4])) != int(tag[1:], 16):
                return "corrupt", None
            try:
                gen = int(parts[2])
            except ValueError:
                return "corrupt", None
            tid = parts[3]
            if len(tid) != 32 or tid.translate(None, b"0123456789abcdef"):
                return "corrupt", None
            return "annot", (gen, tid.decode())
        parts = line.split()
        if len(parts) == 5:
            tag = parts[4]
            # canonical form only: ``c`` + exactly 8 lowercase hex digits.
            # int(, 16) alone would also accept uppercase/"+"-prefixed
            # text, and a single bit flip turns lowercase hex into
            # uppercase (0x20) — undetectable if tolerated
            if (len(tag) != 9 or not tag.startswith(b"c")
                    or tag[1:].translate(None, b"0123456789abcdef")):
                return "corrupt", None
            try:
                rec = tuple(int(x) for x in parts[:4])
            except ValueError:
                return "corrupt", None
            if crc32c(b" ".join(parts[:4])) != int(tag[1:], 16):
                return "corrupt", None
            return "ok", rec
        if len(parts) == 4:
            try:
                return "legacy", tuple(int(x) for x in parts)
            except ValueError:
                return "corrupt", None
        return "corrupt", None

    @classmethod
    def _parse(cls, line) -> tuple[int, int, int, int] | None:
        """A valid record's ``(gen, op, a, b)``, else None (v1 or v2;
        annotations are not records)."""
        status, rec = cls._classify(line)
        return rec if status in ("ok", "legacy") else None

    @staticmethod
    def _parse_header(line: bytes) -> int | str | None:
        """``# base`` header: the base count, ``"corrupt"`` when its
        checksum fails, or None when the line is not a header."""
        if not (line.endswith(b"\n")
                and line.startswith(_BASE_PREFIX.encode())):
            return None
        parts = line.split()
        if len(parts) == 4:
            # v2 header: the 4th field must be the canonical checksum tag
            # (legacy v1 headers have exactly 3 fields, so a 4-field line
            # with a mangled tag is damage, not an old format)
            tag = parts[3]
            if (len(tag) != 9 or not tag.startswith(b"c")
                    or tag[1:].translate(None, b"0123456789abcdef")):
                return "corrupt"
            if crc32c(b" ".join(parts[:3])) != int(tag[1:], 16):
                return "corrupt"
        elif len(parts) != 3:
            return "corrupt"
        try:
            return int(parts[2])
        except ValueError:
            return "corrupt"

    def _encode_header(self, base: int) -> bytes:
        body = f"{_BASE_PREFIX.rstrip()} {int(base)}"
        if self.checksum:
            return f"{body} c{crc32c(body.encode()):08x}\n".encode()
        return f"{body}\n".encode()

    def _replace_json(self, directory: str, path: str, obj: dict):
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".jsontmp")
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        self._io.replace(tmp, path)

    # -- WAL -----------------------------------------------------------------
    def append(self, gen: int, records) -> int:
        """Append ``(op, a, b)`` records committing in generation ``gen``."""
        return self.append_tagged([(gen, op, a, b) for op, a, b in records])

    def append_tagged(self, records) -> int:
        """Append ``(gen, op, a, b)`` records — one buffered write per call,
        so a batched submit pays a single syscall path regardless of batch
        size.  Returns the (global) WAL index of the first record appended.
        A failed append (e.g. disk full) rolls the file back to the last
        record boundary, so a retry can never concatenate onto a torn
        half-record."""
        self._check_writable()
        start = self.wal_len
        offset = self._wal_f.tell()
        data = b"".join(self._encode(*rec) for rec in records)
        t0 = time.perf_counter()
        try:
            with obs_trace.span("wal.append", n=len(records)):
                self._wal_f.write(data)
                self._wal_f.flush()
        except Exception:
            try:
                self._wal_f.close()
            except Exception:
                pass
            self._io.truncate(self.wal_path, offset)
            self._wal_f = self._io.open_append(self.wal_path)
            self._tail_cache = None  # offsets past the truncation are invalid
            raise
        self.wal_len += len(records)
        self._tail_records.append(data)
        _APPEND_S.observe(time.perf_counter() - t0)
        _APPEND_RECS.inc(len(records))
        return start

    def append_annotation(self, gen: int, trace_id: str):
        """Append a ``# trace <gen> <trace_id>`` annotation: a checksummed
        comment line binding generation ``gen`` to the distributed trace
        that originated its writes.  Annotations never count toward
        ``wal_len``/record indexing (legacy readers skip comment lines), so
        the replication protocol and the commit frontier are untouched;
        they ride the same rollback/verified-fsync path as records."""
        self._check_writable()
        body = f"{_TRACE_PREFIX.rstrip()} {int(gen)} {trace_id}"
        data = f"{body} c{crc32c(body.encode()):08x}\n".encode()
        offset = self._wal_f.tell()
        try:
            self._wal_f.write(data)
            self._wal_f.flush()
        except Exception:
            try:
                self._wal_f.close()
            except Exception:
                pass
            self._io.truncate(self.wal_path, offset)
            self._wal_f = self._io.open_append(self.wal_path)
            self._tail_cache = None
            raise
        self._tail_records.append(data)
        self._annots[int(gen)] = trace_id

    def read_trace_annotations(self) -> dict[int, str]:
        """``{gen: trace_id}`` for every annotation this store has seen
        (populated by the open scan and by ``read_wal`` tailing — a replica
        that polls the frontier sees each generation's annotation before
        its records, because the writer appends it first)."""
        return dict(self._annots)

    def fsync(self):
        """Force acknowledged records to disk (called at flush/snapshot).
        No-op when nothing was appended since the last sync, so a batched
        submit that crosses several flush boundaries still pays exactly one
        fsync.

        The sync is *verified*: the unsynced tail is read back and compared
        against the in-memory record bytes first, and a mismatch (torn or
        bit-flipped write) is repaired by truncating to the verified prefix
        and rewriting the tail from memory.  An acked record therefore
        either reaches disk intact or this call raises — it can never be
        silently corrupted by the write path."""
        self._check_writable()
        if self._synced_len == self.wal_len:
            return
        t0 = time.perf_counter()
        with obs_trace.span("wal.fsync",
                            n=self.wal_len - self._synced_len):
            expected = b"".join(self._tail_records)
            self._wal_f.flush()
            for _attempt in range(3):
                with open(self.wal_path, "rb") as f:
                    if os.fstat(f.fileno()).st_size < self._synced_off:
                        # the already-durable prefix shrank underneath us:
                        # memory only holds the unsynced tail, so this is
                        # unrepairable here — fail loudly rather than
                        # zero-extending over committed records
                        raise OSError(
                            "WAL synced prefix shrank below "
                            f"{self._synced_off} bytes — durable records "
                            "lost outside the write path")
                    f.seek(self._synced_off)
                    if f.read() == expected:
                        break
                _REWRITE_N.inc()
                obs_trace.instant("wal.tail_rewrite",
                                  n_bytes=len(expected))
                self._wal_f.close()
                self._io.truncate(self.wal_path, self._synced_off)
                self._wal_f = self._io.open_append(self.wal_path)
                self._wal_f.write(expected)
                self._wal_f.flush()
                self._tail_cache = None
            else:
                raise OSError(
                    "WAL tail failed read-back verification after rewrite")
            self._io.fsync(self._wal_f)
        self._synced_len = self.wal_len
        self._synced_off += len(expected)
        self._tail_records = []
        _FSYNC_S.observe(time.perf_counter() - t0)
        _FSYNC_N.inc()

    def read_wal(self, start: int = 0,
                 stop: int | None = None) -> list[tuple[int, int, int, int]]:
        """``(gen, op, a, b)`` records from global WAL index ``start`` on
        (``start`` below the compaction base yields the tail that still
        exists).  Stops at the first malformed/checksum-failing record — a
        torn tail, an append the primary is still completing, or damage
        (``self.stopped`` says which and where); the cached resume offset
        never advances past a complete record, so the next call re-reads it
        once it is whole.  Repeated tailing with a monotonically increasing
        ``start`` is O(new records).  ``stop`` bounds the read (exclusive)
        *and parks the cache there* — a tailer that consumes only up to the
        committed frontier passes it so the next poll resumes from the
        frontier instead of rescanning from 0 (a cache parked past
        ``start`` is useless)."""
        if not os.path.exists(self.wal_path):
            return []
        out = []
        self.stopped = None
        with open(self.wal_path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            first = f.readline()
            base, hdr = 0, 0
            parsed = self._parse_header(first)
            if parsed == "corrupt":
                self.stopped = ("corrupt", self.base)
                return []
            if parsed is not None:
                base = parsed
                hdr = len(first)
            if base != self.base:
                # the log was compacted underneath us (readonly tailer): the
                # cached offset refers to the replaced file
                self.base = base
                self.wal_len = max(self.wal_len, base)
                self._tail_cache = None
            pos, idx = hdr, base
            tc = self._tail_cache
            if tc is not None and tc[1] <= max(start, base) and hdr <= tc[0] <= size:
                pos, idx = tc
            f.seek(pos)
            for line in f:
                if stop is not None and idx >= stop:
                    break
                if not line.endswith(b"\n"):
                    self.stopped = ("torn", idx)
                    break
                status, rec = self._classify(line)
                if status == "corrupt":
                    self.stopped = ("corrupt", idx)
                    break
                if status == "annot":
                    # trace annotation: consume the bytes, note the gen ->
                    # trace binding, but never advance the record index
                    self._annots[rec[0]] = rec[1]
                    pos += len(line)
                    continue
                if idx >= start:
                    out.append(rec)
                pos += len(line)
                idx += 1
            self._tail_cache = (pos, idx)
            if idx > self.wal_len:  # readonly observer of a live writer
                self.wal_len = idx
        return out

    # -- cluster metadata ----------------------------------------------------
    def publish_commit(self, gen: int, wal_len: int):
        """Advertise the committed frontier: every WAL record below
        ``wal_len`` belongs to a generation the primary has applied, so a
        tailer that stops exactly there only ever applies complete
        generation groups.  Atomic replace; advisory (recovery truth stays
        snapshot + WAL), so no fsync."""
        self._check_writable()
        self._replace_json(self.root, os.path.join(self.root, _COMMIT),
                           {"gen": int(gen), "wal_len": int(wal_len)})

    def read_commit(self) -> dict | None:
        """The primary's committed frontier, or None before the first one
        (or when the sidecar is damaged — it is advisory, so a corrupt
        frontier degrades to conservative recovery, never a crash)."""
        try:
            with open(os.path.join(self.root, _COMMIT)) as f:
                obj = json.load(f)
            if not isinstance(obj, dict) or "wal_len" not in obj:
                return None
            return obj
        except (OSError, ValueError):
            return None

    def publish_replica(self, replica_id: str, meta: dict):
        """Write this replica's lease file (applied frontier + heartbeat).
        Replicas own their lease, so this is allowed on readonly stores."""
        d = os.path.join(self.root, _REPLICAS)
        os.makedirs(d, exist_ok=True)
        self._replace_json(d, os.path.join(d, f"{replica_id}.json"),
                           {**meta, "ts": time.time()})

    def remove_replica(self, replica_id: str):
        """Retire a lease (replica shut down or promoted to primary)."""
        try:
            os.remove(os.path.join(self.root, _REPLICAS, f"{replica_id}.json"))
        except FileNotFoundError:
            pass

    def read_replicas(self) -> dict[str, dict]:
        """All replica leases, keyed by replica id."""
        d = os.path.join(self.root, _REPLICAS)
        if not os.path.isdir(d):
            return {}
        out = {}
        for name in sorted(os.listdir(d)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    out[name[:-len(".json")]] = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # lease being replaced underneath us
        return out

    # -- quarantine ----------------------------------------------------------
    def _quarantine_dir(self) -> str:
        d = os.path.join(self.root, _QUARANTINE)
        os.makedirs(d, exist_ok=True)
        return d

    def _quarantine_bytes(self, data: bytes, start_idx: int, reason: str):
        """Preserve damaged WAL bytes (from global record ``start_idx`` on)
        under ``quarantine/`` with a JSON sidecar, before truncation drops
        them from the log: detection must leave evidence, not just heal."""
        d = self._quarantine_dir()
        stem = os.path.join(d, f"wal-{int(start_idx)}")
        with open(stem + ".bin", "wb") as f:
            f.write(data)
        self._replace_json(d, stem + ".json", {
            "kind": "wal-bytes", "start_index": int(start_idx),
            "n_bytes": len(data), "reason": reason, "ts": time.time()})
        _QUAR_BYTES.inc(len(data))
        _QUAR_N.labels(kind="wal-bytes").inc()
        obs_trace.instant("wal.quarantine", start=start_idx,
                          n_bytes=len(data), reason=reason)

    def write_quarantine_gen(self, gen: int, records, reason: str,
                             status: str = "quarantined"):
        """Record a poisoned generation (peel failure on both engines): the
        records stay in the WAL — never dropped — and this sidecar accounts
        for them until a later retry updates ``status`` to recovered."""
        self._check_writable()
        d = self._quarantine_dir()
        self._replace_json(d, os.path.join(d, f"gen-{int(gen)}.json"), {
            "kind": "generation", "gen": int(gen),
            "records": [list(int(x) for x in r) for r in records],
            "reason": reason, "status": status, "ts": time.time()})
        if status == "quarantined":
            _QUAR_N.labels(kind="generation").inc()
        obs_trace.instant("gen.quarantine", gen=gen, n=len(records),
                          status=status)

    def read_quarantine(self) -> list[dict]:
        """All quarantine sidecars (damaged bytes and poisoned
        generations), oldest first."""
        d = os.path.join(self.root, _QUARANTINE)
        if not os.path.isdir(d):
            return []
        out = []
        for name in sorted(os.listdir(d)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    out.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                continue
        return out

    # -- snapshots -----------------------------------------------------------
    def snapshot(self, tree: dict):
        """Checkpoint the service state tree (caller stamps ``wal_len``)
        with a digest manifest, then compact.  The previous snapshot and
        manifest rotate to ``.prev`` (not deleted) and the WAL compacts
        only to the *previous* snapshot's high-water mark, so a corrupt
        current snapshot can always be recovered as ``.prev`` + the longer
        retained tail.  Snapshot data, manifest and the new header are
        fsynced *before* the old WAL prefix is dropped — a power failure
        can never lose both."""
        self._check_writable()
        with obs_trace.span("store.snapshot", wal_len=self.wal_len):
            prev_wal_len = 0
            man = self._read_manifest(self.manifest_path)
            if man is not None:
                prev_wal_len = int(man.get("wal_len", 0))
            if os.path.exists(self.snap_path):
                self._io.replace(self.snap_path,
                                 self.snap_path + _PREV_SUFFIX)
                if os.path.exists(self.manifest_path):
                    self._io.replace(self.manifest_path,
                                     self.manifest_path + _PREV_SUFFIX)
                self._io.fsync_path(self.root)  # persist the rotation
            checkpoint.save(self.snap_path, tree)
            self._replace_json(self.root, self.manifest_path, {
                "algo": "sha256",
                "digest": _sha256_file(self.snap_path),
                "size": os.path.getsize(self.snap_path),
                "wal_len": self.wal_len})
            self._io.fsync_path(self.snap_path)
            self._io.fsync_path(self.root)  # persist save + manifest renames
            self._compact(prev_wal_len)
        _SNAP_N.inc()

    @staticmethod
    def _read_manifest(path: str) -> dict | None:
        try:
            with open(path) as f:
                obj = json.load(f)
            return obj if isinstance(obj, dict) else None
        except (OSError, ValueError):
            return None

    def _compact(self, base: int):
        """Atomically rewrite the log as ``# base <base>`` + the retained
        records ``[base, wal_len)`` (the interval back to the previous
        snapshot — the current snapshot's fallback replay source)."""
        base = max(int(base), self.base)
        self._wal_f.close()
        tail = b""
        if base < self.wal_len and os.path.exists(self.wal_path):
            with open(self.wal_path, "rb") as f:
                first = f.readline()
                pos = len(first) if self._parse_header(first) is not None else 0
                f.seek(pos)
                idx = self.base
                for line in f:
                    if idx >= base:
                        break
                    pos += len(line)
                    if self._classify(line)[0] != "annot":
                        idx += 1
                f.seek(pos)
                tail = f.read()
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".waltmp")
        with os.fdopen(fd, "wb") as f:
            f.write(self._encode_header(base))
            f.write(tail)
            f.flush()
            os.fsync(f.fileno())
        self._io.replace(tmp, self.wal_path)
        self._io.fsync_path(self.root)  # persist the rename
        self.base = base
        self._wal_f = self._io.open_append(self.wal_path)
        self._tail_cache = None      # offsets referred to the replaced file
        self._synced_len = self.wal_len
        self._synced_off = os.path.getsize(self.wal_path)
        self._tail_records = []

    def _verify_snapshot(self, path: str, manifest_path: str) -> bool:
        """Digest-check a snapshot against its manifest (legacy snapshots
        without a manifest pass — the load attempt still guards them)."""
        if not os.path.exists(manifest_path):
            return True
        man = self._read_manifest(manifest_path)
        if man is None:
            return False
        try:
            return (int(man.get("size", -1)) == os.path.getsize(path)
                    and man.get("digest") == _sha256_file(path))
        except OSError:
            return False

    def load_snapshot(self) -> dict | None:
        """Load the latest checkpoint tree, or None if no snapshot exists.

        Verification order: current snapshot (manifest digest + actual
        load), then the ``.prev`` fallback.  On fallback from a writable
        store the corrupt current snapshot is quarantined so a later
        ``snapshot()`` rotation cannot shadow the good ``.prev`` with it.
        Raises ``SnapshotCorruptionError`` when snapshots exist but none
        verifies."""
        candidates = (
            (self.snap_path, self.manifest_path, False),
            (self.snap_path + _PREV_SUFFIX,
             self.manifest_path + _PREV_SUFFIX, True),
        )
        existed = False
        for path, man_path, is_prev in candidates:
            if not os.path.exists(path):
                continue
            existed = True
            tree = None
            if self._verify_snapshot(path, man_path):
                try:
                    tree = checkpoint.restore(path)
                except Exception:
                    tree = None
            if tree is None:
                obs_trace.instant("snapshot.corrupt", path=path)
                continue
            if is_prev:
                _SNAP_FALLBACK_N.inc()
                obs_trace.instant("snapshot.fallback", path=path)
                if not self.readonly and os.path.exists(self.snap_path):
                    d = self._quarantine_dir()
                    self._io.replace(self.snap_path,
                                     os.path.join(d, _SNAPSHOT + ".corrupt"))
                    if os.path.exists(self.manifest_path):
                        self._io.replace(
                            self.manifest_path,
                            os.path.join(d, _SNAPSHOT + ".corrupt.manifest"))
                    _QUAR_N.labels(kind="snapshot").inc()
            return tree
        if existed:
            raise SnapshotCorruptionError(
                f"no snapshot in {self.root} passed verification")
        return None

    # -- integrity audit -----------------------------------------------------
    def scrub(self) -> dict:
        """Audit the store in place: every WAL record's checksum, the
        snapshot manifests (current and ``.prev``), and commit-frontier
        sanity (``base <= frontier <= wal_len``).  Read-only and safe on a
        live store; returns a report dict with an overall ``ok`` flag and
        bumps the scrub metric counters."""
        report: dict = {"ok": True}
        wal = {"records": 0, "legacy": 0, "annotations": 0,
               "corrupt_at": None, "base": self.base}
        if os.path.exists(self.wal_path):
            with open(self.wal_path, "rb") as f:
                idx = 0
                for i, line in enumerate(f):
                    if i == 0:
                        hdr = self._parse_header(line)
                        if hdr == "corrupt":
                            wal["corrupt_at"] = self.base
                            break
                        if hdr is not None:
                            idx = hdr
                            continue
                        idx = self.base
                    if not line.endswith(b"\n"):
                        break  # live append tail: not a violation
                    status, _ = self._classify(line)
                    if status == "corrupt":
                        wal["corrupt_at"] = idx
                        break
                    if status == "annot":
                        wal["annotations"] += 1
                        continue
                    wal["records"] += 1
                    if status == "legacy":
                        wal["legacy"] += 1
                    idx += 1
        report["wal"] = wal
        snap = {"present": os.path.exists(self.snap_path),
                "verified": None, "prev_present":
                    os.path.exists(self.snap_path + _PREV_SUFFIX),
                "prev_verified": None}
        if snap["present"]:
            snap["verified"] = self._verify_snapshot(
                self.snap_path, self.manifest_path)
        if snap["prev_present"]:
            snap["prev_verified"] = self._verify_snapshot(
                self.snap_path + _PREV_SUFFIX,
                self.manifest_path + _PREV_SUFFIX)
        report["snapshot"] = snap
        commit = self.read_commit()
        report["commit"] = {
            "present": commit is not None,
            "ok": commit is None or (
                0 <= int(commit.get("gen", -1))
                and self.base <= int(commit["wal_len"]) <= self.wal_len)}
        report["quarantine"] = {"entries": len(self.read_quarantine())}
        violations = int(wal["corrupt_at"] is not None)
        violations += int(snap["verified"] is False)
        violations += int(not report["commit"]["ok"])
        report["ok"] = violations == 0
        report["violations"] = violations
        _SCRUB_N.inc()
        if violations:
            _SCRUB_VIOL_N.inc(violations)
        obs_trace.instant("store.scrub", ok=report["ok"],
                          violations=violations)
        return report

    def close(self):
        """Release the WAL append handle (no-op for readonly stores)."""
        if self._wal_f is not None:
            self._wal_f.close()
            self._wal_f = None
