"""The benchmark's cells at small widths, for runs on the CPU: a folder
laid out as ``perfbench/`` (configurations, mixes, kinds, limits, metric
readers) whose configurations keep each model's equations at small widths
and whose mixes are shorter, with the cells' own limits."""
import copy
import json
import shutil
from pathlib import Path

from perfbench.harness import bench

WIDTHS = {
    "mixtral-8x7b": dict(n_layers=2, d_model=128, n_heads=4, n_kv=2,
                         head_dim=32, d_ff=256, vocab=512, moe_experts=4,
                         moe_capacity=2.0),
}
MIXES = {
    "prefill_mix": dict(tokens_per_call=256, shapes=[[4, 64, 1], [2, 128, 1], [1, 256, 1]],
                        pool_calls=8, max_calls=400, warmup=1, check_rows=6),
    "decode_30k": dict(seq=2048, start=200, batch=6, warmup=1, trace_items=2,
                       check_sessions=4),
}


def build(root: Path) -> tuple:
    """(benchmark dict, folder) of the small cells under ``root``."""
    folder = root / "pb"
    for d in ("configs", "traffic", "limits"):
        (folder / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "kinds"):
        shutil.copytree(bench.HERE / d, folder / d, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(bench.HERE / "peaks.json", folder / "peaks.json")
    b = copy.deepcopy(bench.benchmark())
    for c in b["configs"]:
        cfg = bench.config(b, c["name"])
        cfg["model"].update(WIDTHS[c["name"]])
        cfg["reference"] = str(bench.ROOT / cfg["reference"])
        c["file"] = f"pb/configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for name, small in MIXES.items():
        mix = dict(bench.traffic(name), **small)
        (folder / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for w in b["workloads"]:
        shutil.copy(bench.HERE / "limits" / f"{w['name']}.json", folder / "limits")
    return b, folder
