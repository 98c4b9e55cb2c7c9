"""The readings the correctness limits are set from: a cell's run on many
seeds in one process, each with the program's readings and, where asked,
its control's (the reference in float8 put in the program's place) and
the bf16 witness's (the reference with bf16 products).

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 [--control-seeds 1,2] [--witness-seeds 1] \
        [--trace-seeds 3] [--out file.jsonl]

One JSON line a seed on standard output (and appended to ``--out``): the
result line a run prints, the readings of the program, the control and the
witness, and the reference's seconds.  The benchmark's own runs never run
the control or the witness.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as R  # noqa: E402  (sets the environment before torch)

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    ctrl, traced = set(ints(args.control_seeds)), set(ints(args.trace_seeds))
    wit = set(ints(args.witness_seeds))
    b = R.bench.benchmark(R.ROOT)
    cell = R.bench.cell(b, args.workload)
    for seed in ints(args.seeds):
        t0 = time.perf_counter()
        res = R.run_cell(b, cell, seed, args.seconds, seed in traced,
                         control=seed in ctrl, witness=seed in wit, t_start=t0)
        rec = {"workload": args.workload, "seed": seed, "trace": seed in traced,
               "wall_s": time.perf_counter() - t0, **res}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
