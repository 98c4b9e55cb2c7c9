"""A whole run of each cell at small widths on the CPU (the look for a
card skipped), first of the port as it is, which has to come out correct,
then with the timed path broken underneath, which has to come out not
correct: a decode step that leaves its state (the cache) unchanged, half
of the batch left out (its rows given the other half's answers), and an
answer altered where it is produced.  No cell crosses chips, so no
exchange can be left out.  Last, the control (the reference in float8 in
the program's place) has to fail the cells' limits too."""
import time

import pytest
import torch

from perfbench import run
from perfbench.harness import bench, check
from perfbench.tests import small_cells

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]
SEED = 2 ** 33 + 17


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return small_cells.build(tmp_path_factory.mktemp("cells"))


def run_small(small, cell_name: str, control: bool = False) -> dict:
    b, folder = small
    cell = bench.cell(b, cell_name)
    return run.run_cell(b, cell, SEED, 0.4, False, device="cpu", control=control,
                        folder=folder, root=folder.parent,
                        t_start=time.perf_counter())


def kind_of(small, cell_name: str) -> str:
    b, folder = small
    return bench.traffic(bench.cell(b, cell_name)["traffic"], folder)["kind"]


def half_batch_prefill(orig):
    def prefill(cfg, params, tokens, **kw):
        h = -(-tokens.shape[0] // 2)
        out = orig(cfg, params, tokens[:h], **kw)
        return torch.cat([out, out])[:tokens.shape[0]]
    return prefill


def half_batch_decode(orig):
    def decode_step(cfg, params, cache, token, pos, **kw):
        h = -(-token.shape[0] // 2)
        half = {k: v[:, :h] for k, v in cache.items()}
        out, _ = orig(cfg, params, half, token[:h], pos, **kw)
        return torch.cat([out, out])[:token.shape[0]], cache
    return decode_step


def state_unchanged(orig):
    def decode_step(cfg, params, cache, token, pos, **kw):
        slot = int(pos) % cache["k"].shape[2]
        saved = {k: v[:, :, slot].clone() for k, v in cache.items()}
        out = orig(cfg, params, cache, token, pos, **kw)
        for k, v in saved.items():
            cache[k][:, :, slot] = v
        return out
    return decode_step


def altered(orig, decode: bool):
    def entry(*a, **kw):
        out = orig(*a, **kw)
        if decode:
            return out[0].roll(1, -1), out[1]
        return out.roll(1, -1)
    return entry


FAULTS = {
    "lm_prefill": {"half_batch": ("prefill", half_batch_prefill),
                "answer_altered": ("prefill", lambda f: altered(f, False))},
    "lm_decode": {"state_unchanged": ("decode_step", state_unchanged),
               "half_batch": ("decode_step", half_batch_decode),
               "token_altered": ("decode_step", lambda f: altered(f, True))},
}
CASES = [(c, f) for c in CELLS
         for f in FAULTS[bench.traffic(bench.cell(bench.benchmark(), c)["traffic"])["kind"]]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small, cell):
    line = run_small(small, cell)["line"]
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["failed"] == 0
    assert line["attempted"] > 0 and set(line["checks"]) == set(
        bench.limits(cell, small[1])["numbers"])


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(small, cell, fault, monkeypatch):
    from repro_torch.models import transformer
    name, wrap = FAULTS[kind_of(small, cell)][fault]
    monkeypatch.setattr(transformer, name, wrap(getattr(transformer, name)))
    line = run_small(small, cell)["line"]
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small, cell):
    res = run_small(small, cell, control=True)
    spec = bench.limits(cell, small[1])["numbers"]
    ok, table = check.verdict(res["extra"]["control_items"], spec)
    assert not ok, table
