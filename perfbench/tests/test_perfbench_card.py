"""Each cell run end to end on the card for a short window, as the
benchmark runs it (needs a CUDA device; skips elsewhere):

    python -m pytest -q -m cuda perfbench/tests
"""
import gc

import pytest
import torch

from perfbench import run
from perfbench.harness import bench

B = bench.benchmark()
CELLS = [w["name"] for w in B["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run on the card only")
    res = run.run_cell(B, bench.cell(B, cell), 2 ** 32 + 99, 3.0, False)
    line = res["line"]
    gc.collect()
    torch.cuda.empty_cache()
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {m["name"] for m in bench.metrics_of(B, cell, False)}
