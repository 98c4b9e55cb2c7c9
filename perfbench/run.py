"""One run of one benchmark cell of the port (``repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  The cell's
traffic mix names its kind, a module ``kinds/<kind>.py`` whose ``Cell``
sets up the system under test from the seed (weights, inputs, warm-up of
the cell's shapes), runs its requests, and gives the check that holds what
the timed requests produced to the plain reference.  This file keeps what
every kind shares: the set-up clock, the measured window of ``--seconds``,
the traced segment after it (``--trace 1``), the verdict, the metric
readers and one JSON line: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics.  The numbers compared
and their limits come last, on standard error and under ``checks`` in the
line.

Every metric is a reader ``metrics/<name>.py``; a cell's configuration,
traffic mix, kind and limits are files found by the names in
``BENCHMARK.json``.  The run exits non-zero, and prints no result, without
a card (or with fewer than the cell asks for), and if JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
# before torch starts CUDA: a 30k-token cache beside the weights needs
# segments that grow in place, and every cache stays inside the checkout
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
os.environ["USE_FLAX"] = "0"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.harness import bench, check, counts, drive  # noqa: E402
from perfbench.harness.trace import Session, Trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What a metric reader reads: the cell, its sizes ``m``, its mix, the
    card's ``peak``, the measured ``window``, the ``traced`` segment and
    its ``trace`` (``--trace 1``), ``setup_s`` and the window's peak bytes;
    ``counts`` is the harness's arithmetic of operations and bytes."""
    counts = counts

    def __init__(self, **kw):
        self.__dict__.update(kw)


def loaded_forbidden() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def run_cell(b: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False, witness: bool = False,
             folder: Path = bench.HERE, root: Path = ROOT,
             t_start: float = T_START) -> dict:
    """Set up, measure and check one run of ``cell``; returns the result
    line's fields, and the control's and the bf16 witness's readings where
    asked."""
    marks = {"imports": time.perf_counter()}
    torch.zeros(1, device=device)
    drive.sync(device)
    marks["device"] = time.perf_counter()
    cfg = bench.config(b, cell["config"], root)
    mix = bench.traffic(cell["traffic"], folder)
    spec = bench.limits(cell["name"], folder)["numbers"]
    reference = bench.module(root / cfg["reference"], "perfbench_reference")
    sut = bench.kind(mix["kind"], folder).Cell(cfg, mix, seed, device,
                                                reference, marks)
    setup_s = time.perf_counter() - t_start
    setup_peak = _peak(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    window = sut.measure(seconds)
    window_peak = _peak(device)
    traced = tr = None
    if trace:
        session = Session(device)
        traced = sut.measure(None, count=mix["trace_items"])
        session.close()
        tr = Trace(session)
    chk = sut.check(len(traced.items) if traced else 0)
    warm = sut.warm
    del sut                         # the program's state, before the reference
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    chk.reference()
    items = chk.items()
    lower = {k: getattr(chk, k)() for k, on in (("control", control),
                                                ("witness", witness)) if on}
    ref_s = time.perf_counter() - t_ref
    ok, table = check.verdict(items, spec)

    kind = torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu"
    run = Run(cell=cell, cfg=cfg, m=cfg["model"], mix=mix, window=window,
              traced=traced, trace=tr, setup_s=setup_s, window_peak=window_peak,
              peak=bench.peaks(kind, folder) if kind != "cpu" else None)
    metrics = {}
    for entry in bench.metrics_of(b, cell["name"], trace):
        value = bench.reader(entry["name"], folder)(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": ok, "attempted": window.attempted, "failed": window.failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.wall_s
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.gaps}
    out["checks"] = {k: {"value": v, "limit": lim, "over": over, "of": n}
                     for k, (v, lim, over, n) in table.items()}
    stamps = [("start", t_start)] + list(marks.items()) + [("warm-up", t_start + setup_s)]
    extra = {"setup_parts": {b_[0]: round(b_[1] - a_[1], 3)
                             for a_, b_ in zip(stamps, stamps[1:])},
             "warm_up_s": warm, "item_s": [round(float(q), 4) for q in np.percentile(
                 [it.seconds for it in window.items], [0, 10, 50, 90, 100])],
             "reference_s": ref_s, "calls": len(window.items),
             "trace_lost": tr.lost if tr is not None else None, "items": items}
    for k, v in lower.items():
        extra[k + "_items"] = v
        extra[k] = {n: x[0] for n, x in check.numbers(v, spec).items()}
    return {"line": out, "extra": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    b = bench.benchmark(ROOT)
    cell = bench.cell(b, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(b, cell, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the process loaded {bad}; the benchmark runs the "
              f"port alone", file=sys.stderr)
        return 3
    line = res["line"]
    print(f"perfbench: {json.dumps(res['extra'])}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"({c['over']} of {c['of']} items over it)", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
