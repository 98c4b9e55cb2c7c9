"""Merge per-process JSONL traces into one wall-aligned Chrome trace.

Each ``TraceWriter`` JSONL file starts with a ``clock_sync`` header pairing
the process's wall clock with the monotonic clock its spans were stamped
with.  ``merge_files`` rebases every event onto the shared wall timeline
(``wall_ns - perf_ns`` offset per file), assigns each file its own Chrome
``pid`` (with a ``process_name`` metadata row carrying the ``proc`` label),
and emits one ``trace_event`` document — so a router -> primary -> replica
round trip, recorded by different processes, renders as aligned tracks in
``chrome://tracing`` / Perfetto, joined by the ``trace_id`` span attribute
that :class:`repro_torch.obs.trace.TraceContext` propagation stamped on every
hop.

    python -m repro_torch.obs.merge merged.json primary.jsonl replica.jsonl

Files without a header (pre-clock-sync writers, hand-built fixtures) merge
with a zero offset — same-process files still align exactly.
"""
from __future__ import annotations

import argparse
import json


def load_jsonl(path: str):
    """Read one TraceWriter file: ``(clock_sync_header | None, events)``.

    Events are the plain dicts ``event_dict`` wrote; malformed lines are
    skipped (a crash can tear the final line)."""
    header, events = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if "clock_sync" in obj and header is None:
                header = obj
            elif "t0_ns" in obj:
                events.append(obj)
    return header, events


def merge_files(paths) -> dict:
    """One Chrome ``trace_event`` document from many per-process JSONL
    files, wall-clock aligned and pid-separated (see module docstring)."""
    tev = []
    used_pids: set[int] = set()
    for i, path in enumerate(paths):
        header, events = load_jsonl(path)
        offset_ns = 0
        pid, proc = i, ""
        if header is not None:
            sync = header["clock_sync"]
            offset_ns = sync["wall_ns"] - sync["perf_ns"]
            pid = header.get("pid", i)
            proc = header.get("proc", "")
        while pid in used_pids:  # forked pids can collide across hosts
            pid += 1
        used_pids.add(pid)
        tev.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": proc or f"proc-{i} ({path})"}})
        for ev in sorted(events, key=lambda e: (e["t0_ns"], e["seq"])):
            tev.append({
                "name": ev["name"],
                "ph": "X",
                "ts": (ev["t0_ns"] + offset_ns) / 1e3,
                "dur": ev["dur_ns"] / 1e3,
                "pid": pid,
                "tid": 0,
                "args": {**(ev.get("attrs") or {}), "seq": ev["seq"],
                         "parent": ev["parent"], "depth": ev["depth"]},
            })
    return {"traceEvents": tev, "displayTimeUnit": "ms"}


def trace_ids(doc: dict) -> dict:
    """``{trace_id: [pids that recorded spans under it]}`` over a merged
    document — the quick way to see which processes one request touched."""
    out: dict = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        tid = (ev.get("args") or {}).get("trace_id")
        if tid is None:
            continue
        pids = out.setdefault(tid, [])
        if ev["pid"] not in pids:
            pids.append(ev["pid"])
    return out


def main(argv=None) -> int:
    """CLI: ``merge.py OUT.json IN.jsonl [IN.jsonl ...]``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="merged Chrome trace JSON to write")
    ap.add_argument("inputs", nargs="+", help="TraceWriter JSONL files")
    args = ap.parse_args(argv)
    doc = merge_files(args.inputs)
    with open(args.out, "w") as f:
        json.dump(doc, f)
    ids = trace_ids(doc)
    n_spans = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    print(f"{args.out}: {n_spans} spans from {len(args.inputs)} file(s), "
          f"{len(ids)} trace id(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
