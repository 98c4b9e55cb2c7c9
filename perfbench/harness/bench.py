"""What a run reads from its checkout: ``BENCHMARK.json``, and the files a
cell names through it.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, the mix's kind (set-up, requests and check)
``kinds/<kind>.py``, its correctness limits ``limits/<cell>.json``, each
metric a reader ``metrics/<metric>.py`` and the table of peaks
``peaks.json``, all under this folder.  Adding a cell, a mix, a kind or a
metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # the benchmark's folder
ROOT = HERE.parent                               # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(has {[w['name'] for w in bench['workloads']]})")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return load_json(root / entry["file"])


def traffic(name: str, folder: Path = HERE) -> dict:
    return load_json(folder / "traffic" / f"{name}.json")


def limits(cell_name: str, folder: Path = HERE) -> dict:
    return load_json(folder / "limits" / f"{cell_name}.json")


def peaks(kind: str, folder: Path = HERE) -> dict:
    """The published peaks of the card named ``kind``: the table's entry
    whose key the name holds."""
    table = load_json(folder / "peaks.json")
    for key, row in table.items():
        if key in kind:
            return row
    raise KeyError(f"no peaks for {kind!r} in peaks.json ({list(table)})")


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of ``cell_name`` reports: its end-to-end metrics
    (``trace`` off) or its per-layer metrics (``trace`` on), each entry
    whose ``workloads`` lists the cell or that has none."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]


def _tag(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def reader(name: str, folder: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return module(folder / "metrics" / f"{name}.py",
                  "perfbench_metric_" + _tag(name)).read


def kind(name: str, folder: Path = HERE):
    """The module ``kinds/<name>.py`` of a traffic mix's kind."""
    return module(folder / "kinds" / f"{name}.py", "perfbench_kind_" + _tag(name))


def module(path: Path, name: str):
    """The module at ``path`` (a configuration's reference, a kind, a
    metric reader)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
