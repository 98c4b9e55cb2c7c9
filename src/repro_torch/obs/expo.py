"""Prometheus text exposition: render, parse (round-trip), HTTP endpoint.

``render(registry)`` emits the standard text format (``# HELP``/``# TYPE``
headers, cumulative histogram ``_bucket{le=...}`` series plus ``_sum`` /
``_count``); ``parse(text)`` reads it back into the same plain-dict shape
``Registry.snapshot()`` produces (histogram bucket counts de-cumulated), so
tests can assert ``parse(render(r))`` matches ``r.snapshot()`` — the
round-trip gate that keeps the format honest.

``MetricsServer`` is the ``serve_truss --metrics-port`` backend: a
stdlib ``ThreadingHTTPServer`` on a daemon thread serving ``GET /metrics``
plus ``GET /healthz`` (port 0 picks a free port; read it back from
``.port``).  ``/healthz`` reports the SLO engine's verdict — HTTP 200 with
``{"status": "ok"}`` while every objective is healthy, HTTP 503 with
``burning``/``violated`` otherwise — via an injectable ``health`` callback
(``repro_torch.obs.slo.SLOEngine.health`` in the serving stack).  No third-party
client library anywhere.
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import REGISTRY, Registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v) -> str:
    """Prometheus sample value: integers bare, floats via repr, +Inf."""
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _labelstr(names, values, extra=()) -> str:
    pairs = [f'{n}="{v}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{v}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render(registry: Registry | None = None) -> str:
    """The registry's current state as Prometheus text exposition."""
    snap = (registry if registry is not None else REGISTRY).snapshot()
    lines = []
    for name, fam in snap.items():
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        names = fam["labelnames"]
        for key, val in fam["values"].items():
            if fam["type"] in ("counter", "gauge"):
                lines.append(f"{name}{_labelstr(names, key)} {_fmt(val)}")
                continue
            # histogram: cumulative le-buckets, then sum/count
            cum = 0
            for bound, cnt in zip(val["bounds"] + [float("inf")],
                                  val["buckets"]):
                cum += cnt
                le = _labelstr(names, key, extra=[("le", _fmt(float(bound)))])
                lines.append(f"{name}_bucket{le} {cum}")
            lines.append(f"{name}_sum{_labelstr(names, key)} "
                         f"{_fmt(float(val['sum']))}")
            lines.append(f"{name}_count{_labelstr(names, key)} "
                         f"{val['count']}")
    return "\n".join(lines) + "\n"


def _parse_labels(s: str) -> dict:
    out = {}
    s = s.strip()
    if not s:
        return out
    for part in s.split(","):
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip().strip('"')
    return out


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    return float(s)


def parse(text: str) -> dict:
    """Parse Prometheus text exposition back into the ``Registry.snapshot``
    shape (histogram buckets de-cumulated; counter/gauge values as floats,
    integral floats normalized to int).  Raises ``ValueError`` on a
    malformed sample line — the smoke test's well-formedness check."""
    fams: dict[str, dict] = {}

    def fam_for(name, typ=None):
        f = fams.setdefault(name, {"type": typ or "untyped", "help": "",
                                   "labelnames": [], "values": {}})
        if typ:
            f["type"] = typ
        return f

    raw_hist: dict[str, dict] = {}  # name -> {key: {"le": {bound: cum}, ...}}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            fam_for(name)["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, typ = rest.partition(" ")
            fam_for(name, typ)
            continue
        if line.startswith("#"):
            continue
        # sample: name{labels} value
        if "{" in line:
            name, _, rest = line.partition("{")
            labels_s, _, val_s = rest.partition("}")
            labels = _parse_labels(labels_s)
        else:
            name, _, val_s = line.partition(" ")
            labels = {}
        val_s = val_s.strip()
        if not name or not val_s:
            raise ValueError(f"malformed sample line: {line!r}")
        value = _parse_value(val_s)
        base, suffix = name, ""
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and name[:-len(sfx)] in fams \
                    and fams[name[:-len(sfx)]]["type"] == "histogram":
                base, suffix = name[:-len(sfx)], sfx
                break
        if suffix:
            le = labels.pop("le", None)
            fam = fams[base]
            lns = fam["labelnames"] or sorted(labels)
            fam["labelnames"] = lns
            key = tuple(labels.get(k, "") for k in lns)
            h = raw_hist.setdefault(base, {}).setdefault(
                key, {"le": {}, "sum": 0.0, "count": 0})
            if suffix == "_bucket":
                h["le"][_parse_value(le)] = value
            elif suffix == "_sum":
                h["sum"] = value
            else:
                h["count"] = int(value)
            continue
        fam = fam_for(name)
        lns = fam["labelnames"] or sorted(labels)
        fam["labelnames"] = lns
        key = tuple(labels.get(k, "") for k in lns)
        fam["values"][key] = int(value) if value == int(value) else value

    for base, per_key in raw_hist.items():
        fam = fams[base]
        for key, h in per_key.items():
            bounds = sorted(b for b in h["le"] if not math.isinf(b))
            cums = [h["le"][b] for b in bounds] + [h["le"].get(float("inf"),
                                                              h["count"])]
            counts, prev = [], 0
            for c in cums:
                counts.append(int(c - prev))
                prev = c
            fam["values"][key] = {"buckets": counts, "bounds": bounds,
                                  "sum": h["sum"], "count": h["count"]}
    return fams


class _Handler(BaseHTTPRequestHandler):
    """GET /metrics -> exposition text; GET /healthz -> SLO verdict JSON;
    anything else -> 404.  Quiet logs."""

    registry: Registry = REGISTRY
    health = None  # zero-arg callable -> status str | dict with "status"

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        """Serve one scrape or health probe."""
        path = self.path.split("?")[0]
        if path == "/healthz":
            self._serve_health()
            return
        if path != "/metrics":
            self.send_response(404)
            self.end_headers()
            return
        body = render(self.registry).encode()
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_health(self):
        """200 while status == "ok", 503 while burning/violated (so load
        balancers and the smoke test can react without parsing)."""
        cb = type(self).health
        state = cb() if cb is not None else {"status": "ok"}
        if isinstance(state, str):
            state = {"status": state}
        body = json.dumps(state).encode()
        self.send_response(200 if state.get("status") == "ok" else 503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        """Suppress per-request stderr logging."""


class MetricsServer:
    """Daemon-thread HTTP server exposing one registry at ``/metrics`` and
    an optional health callback at ``/healthz``."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Registry | None = None, health=None):
        handler = type("BoundHandler", (_Handler,),
                       {"registry": registry if registry is not None
                        else REGISTRY,
                        "health": staticmethod(health) if health is not None
                        else None})
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        """The bound port (useful with ``port=0``)."""
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        """Begin serving on a daemon thread; returns self for chaining."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Shut the server down and join its thread."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
