"""Dry-run of every (architecture x input-shape) cell on the production
meshes, on shapes alone (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--cell C]
        [--mesh single|multi|both] [--out dryrun_artifacts]

The reference lowers and compiles each cell's plan on 512 fake CPU devices
and never allocates.  Here each plan (``launch/specs.py``) is traced: its
``fn`` runs once on its ``meta`` arguments under ``FlopCounterMode``, so
every op computes nothing and every kernel takes its meta route
(``kernels/ops.py``).  A cell is traced once and the trace reused on the
other mesh, unless its program reads the mesh (the MoE expert block's
model-sharded branch).  Each record holds:

* ``trace_s``: seconds of the trace (0 where it was reused);
* ``argument_size_in_bytes``: one mesh position's bytes of the arguments,
  from the in-shardings' shard shapes;
* ``output_size_in_bytes``: the same for the traced outputs under the
  out-shardings, whose tree must match the outputs';
* ``matmul_flops``: what ``torch.utils.flop_counter`` counts over the whole
  step, on every position together (matrix products, convolutions,
  attention), with K3 counted over its band's pairs and K5 as its GEMM;
* ``no_counterpart``: the reference's fields the port cannot produce, each
  with the reason.

Output: ``{arch}__{cell}__{mesh}.json`` a record, ``summary.json``, one
``[OK]`` / ``[FAIL]`` / ``[SKIP]`` line a cell, and ``N/N cells traced``;
the exit code is 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import REGISTRY
from .mesh import make_production_mesh
from .specs import build_cell, shard_bytes

NO_COUNTERPART = {
    "temp_size_in_bytes": "XLA's buffer assignment of a compiled program; "
                          "the port compiles nothing ahead of a run",
    "generated_code_size_in_bytes": "no ahead-of-time executable",
    "alias_size_in_bytes": "XLA's accounting of donated buffers; the "
                           "train plans update their donated arguments in "
                           "place (adamw_update_), with no buffer "
                           "assignment to count",
    "bytes_accessed": "XLA's cost analysis of a fused HLO module; meta ops "
                      "have no fusion or memory traffic",
    "transcendentals": "XLA's cost analysis; flop_counter counts no "
                       "elementwise ops",
    "collectives": "parsed from XLA's optimized HLO text, which the port "
                   "never has (a ShardMesh runs its collectives in Python)",
    "flops": "XLA's per-device cost analysis of the compiled module; the "
             "port records matmul_flops, over every position",
    "lower_s, compile_s, hlo_bytes": "nothing is lowered or compiled; the "
                                     "port records trace_s",
    "*_exact": "the reference extrapolates unrolled variants because XLA "
               "counts a scan body once; the port's layer loop is counted "
               "layer by layer",
}


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_tree(v) for v in tree]
    return [list(tree.shape), str(tree.dtype).replace("torch.", "")]


def trace(plan) -> tuple:
    """Run ``plan.fn`` once on its meta args: ``(outputs, matmul flops,
    seconds)``."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        out = plan.fn(*plan.args)
    return out, int(fc.get_total_flops()), time.perf_counter() - t0


def run_cell(arch, cell_name: str, mesh, mesh_name: str,
             traced: dict | None = None) -> dict:
    """Build and trace one cell's plan on ``mesh``.  ``arch``: an arch id
    or an ``ArchConfig`` (a smoke config, say).  ``traced`` caches a
    mesh-independent trace across calls (keyed by arch and cell)."""
    arch = REGISTRY[arch] if isinstance(arch, str) else arch
    arch_id = arch.arch_id
    cell = next(c for c in arch.cells() if c.name == cell_name)
    rec = {"arch": arch_id, "cell": cell_name, "mesh": mesh_name, "ok": False}
    try:
        plan = build_cell(arch, cell, mesh)
        key = (arch.model, cell_name)
        if traced is not None and key in traced and not plan.mesh_program:
            out, flops, _ = traced[key]
            rec["trace_s"] = 0.0
        else:
            out, flops, secs = trace(plan)
            rec["trace_s"] = round(secs, 3)
            if traced is not None and not plan.mesh_program:
                traced[key] = (out, flops, secs)
        rec["mesh_program"] = plan.mesh_program
        rec["argument_size_in_bytes"] = shard_bytes(plan.in_shardings, plan.args)
        rec["output_size_in_bytes"] = shard_bytes(plan.out_shardings, out)
        rec["matmul_flops"] = flops
        rec["donate_argnums"] = list(plan.donate_argnums)
        rec["outputs"] = _shape_tree(out)
        rec["no_counterpart"] = NO_COUNTERPART
        rec["ok"] = True
        print(f"[OK]   {arch_id:26s} {cell_name:15s} {mesh_name:6s} "
              f"trace={rec['trace_s']}s "
              f"args={rec['argument_size_in_bytes'] / 1e9:.3f}GB/device "
              f"matmul_flops={flops:.3e}", flush=True)
    except Exception as e:  # noqa: BLE001 — recorded, run continues
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch_id:26s} {cell_name:15s} {mesh_name:6s} "
              f"{rec['error']}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_artifacts")
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", make_production_mesh(multi_pod=False,
                                                      device="meta")))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", make_production_mesh(multi_pod=True,
                                                     device="meta")))

    os.makedirs(args.out, exist_ok=True)
    results, n_fail, traced = [], 0, {}
    for arch_id, arch in sorted(REGISTRY.items()):
        if args.arch and arch_id != args.arch:
            continue
        for cell in arch.cells():
            if args.cell and cell.name != args.cell:
                continue
            for mesh_name, mesh in meshes:
                rec = run_cell(arch_id, cell.name, mesh, mesh_name, traced)
                results.append(rec)
                n_fail += 0 if rec["ok"] else 1
                path = os.path.join(
                    args.out, f"{arch_id}__{cell.name}__{mesh_name}.json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            traced.clear()
        for cell in arch.skipped_cells():
            print(f"[SKIP] {arch_id:26s} {cell.name:15s} "
                  "(full-attention arch; long-context rule, DESIGN.md §5)")

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"\n{len(results) - n_fail}/{len(results)} cells traced")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
