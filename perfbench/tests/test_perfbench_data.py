"""The benchmark's data and arithmetic: BENCHMARK.json against its rules,
the files it names, traffic that repeats for a seed, the counts of
operations and bytes by hand at the published widths, and a run that fails
without a card."""
import os
import re
import subprocess
import sys

import pytest
import torch

from perfbench.harness import bench, check, counts, traffic

HERE = bench.HERE
ROOT = bench.ROOT
B = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in B["end_to_end"]}
CELLS = [w["name"] for w in B["workloads"]]


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["perfbench"] and 1 <= B["run_seconds"] <= 51
    assert all(line_ok(w) for w in B["command"]) and len(B["command"]) <= 32
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024
    for p in HERE.rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.fullmatch(r"[A-Za-z0-9_./\-]+", str(p.relative_to(ROOT))), p


def test_names_units_and_lines():
    names = [c["name"] for c in B["configs"]] + CELLS
    metrics = list(E2E) + [m["name"] for m in B["per_layer"]]
    for n in names + metrics:
        assert NAME.match(n), n
    assert len(set(metrics)) == len(metrics) and len(set(names)) == len(names)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line_ok(w["why"]) and NAME.match(w["traffic"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in E2E


def test_every_cell_reports_what_it_must():
    for cell in CELLS:
        e2e = [m["name"] for m in bench.metrics_of(B, cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert bench.metrics_of(B, cell, True), cell


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_each_per_layer_metric_moves_a_metric_of_its_cells(metric):
    m = next(x for x in B["per_layer"] if x["name"] == metric)
    for cell in m["workloads"]:
        assert m["moves"] in [e["name"] for e in bench.metrics_of(B, cell, False)]


def test_every_named_file_is_there():
    for m in B["end_to_end"] + B["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for c in B["configs"]:
        cfg = bench.config(B, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / cfg["reference"]).exists() and cfg["source"] == c["source"]
    for w in B["workloads"]:
        assert hasattr(bench.kind(bench.traffic(w["traffic"])["kind"]), "Cell")
        spec = bench.limits(w["name"])["numbers"]
        assert spec and all(n["limit"] > 0 and n["stat"] in check.STATS
                            for n in spec.values())


def test_run_holds_nothing_of_a_kind():
    """A new kind of cell is a new ``kinds/<kind>.py``: ``run.py`` names no
    kind and imports nothing of the program."""
    from perfbench.tests.test_perfbench_hygiene import imports
    src = (HERE / "run.py").read_text()
    for word in ("prefill", "decode", "transformer"):
        assert word not in src, word
    assert "repro_torch" not in imports(HERE / "run.py")


def test_prefill_schedule_repeats_for_a_seed_and_keeps_the_mix():
    mix = bench.traffic("prefill_mix")
    a = traffic.schedule(mix, 2 ** 33 + 5, 100)
    assert a == traffic.schedule(mix, 2 ** 33 + 5, 100)
    assert a != traffic.schedule(mix, 7, 100)
    for i in range(0, 100, 10):                  # every block: 5 / 3 / 2
        block = a[i:i + 10]
        assert sorted(set(block)) == [(2, 8192), (4, 4096), (8, 2048)]
        assert [block.count(s) for s in ((8, 2048), (4, 4096), (2, 8192))] == [5, 3, 2]
    assert all(r * s == mix["tokens_per_call"] for r, s in a)


def test_inputs_repeat_for_a_seed():
    mix = dict(bench.traffic("prefill_mix"), pool_calls=2, tokens_per_call=64)
    p = traffic.prompt_pool(mix, 1000, 3, "cpu")
    assert torch.equal(p, traffic.prompt_pool(mix, 1000, 3, "cpu"))
    assert not torch.equal(p, traffic.prompt_pool(mix, 1000, 4, "cpu"))
    a = traffic.fill_layer((2, 8, 2, 4), 9, "k", 1, 5, "cpu")
    assert torch.equal(a, traffic.fill_layer((2, 8, 2, 4), 9, "k", 1, 5, "cpu"))
    assert not torch.equal(a, traffic.fill_layer((2, 8, 2, 4), 9, "v", 1, 5, "cpu"))
    assert (a[:, 5:] == 0).all() and (a[:, :5] != 0).all()
    assert torch.equal(traffic.first_tokens(100, 4, 2 ** 40, "cpu"),
                       traffic.first_tokens(100, 4, 2 ** 40, "cpu"))


def test_prefix_positions_of_a_ring():
    pos, slot = traffic.prefix_positions(30720, 4096)
    assert pos[0] == 26624 and pos[-1] == 30719 and len(pos) == 4096
    assert sorted(slot) == list(range(4096)) and slot[0] == 2048
    pos, slot = traffic.prefix_positions(30720, 32768)
    assert (pos == slot).all() and len(pos) == 30720


def model(name):
    return bench.config(B, name)["model"]


def test_prefill_counts_by_hand():
    mx = model("mixtral-8x7b")
    # attention 4096 * 128 * (32 + 32 + 8 + 8), two of eight SwiGLU experts,
    # the router
    mlayer = 4096 * 128 * 80 + 2 * 3 * 4096 * 14336 + 4096 * 8
    assert counts.token_flops(mx) == 2 * 8 * mlayer == 6_308_757_504
    pairs = 8192 * 8193 // 2                     # causal: no window
    assert counts.pairs(8192, None) == pairs
    assert counts.prefill_flops(mx, 2, 8192) == (
        2 * 8192 * 6_308_757_504 + 4 * 2 * 32 * 128 * pairs * 8 + 2 * 2 * 4096 * 32000)
    # a window binds past its length
    assert counts.pairs(8192, 4096) == 4096 * 4097 // 2 + 4096 * 4096
    assert counts.pairs(2048, 4096) == 2048 * 2049 // 2


def test_k3_bound_by_hand():
    mx = model("mixtral-8x7b")
    peak = bench.peaks("NVIDIA H100 80GB HBM3")
    flops = 4 * 4 * 32 * 128 * (4096 * 4097 // 2)
    n_bytes = 2 * 2 * 4 * 4096 * 128 * 40
    assert counts.k3_bound_s(mx, 4, 4096, peak) == pytest.approx(
        8 * max(flops / 989e12, n_bytes / 3.35e12))
    assert flops / 989e12 > n_bytes / 3.35e12        # operations bound it


def test_decode_counts_by_hand():
    mx = model("mixtral-8x7b")
    assert counts.param_bytes(mx) == 4 * 11_872_309_248
    mix = bench.traffic("decode_30k")
    # 80% of 85 GB less the fp32 parameters and a wave's bf16 casts (one
    # layer's weights, all experts, and the unembedding), over one
    # session's bf16 cache of 32,768 slots and one layer's fp32 K/V copies
    kv = 32768 * 8 * 128
    casts = 2 * (4096 * 128 * 80 + 8 * 3 * 4096 * 14336 + 4096 * 8 + 2 * 4096
                 + 32000 * 4096)
    per = 2 * 2 * 8 * kv + 2 * 4 * kv
    assert traffic.decode_batch(mix, mx) == int((0.8 * 85e9 - 4 * 11_872_309_248
                                                 - casts) // per) == 12
    # a wave at position 30,720: 30,721 positions read, one written; of the
    # experts those 12 tokens are expected to choose
    e = 8 * (1 - (6 / 8) ** 12)
    assert counts.distinct_experts(mx, 12) == pytest.approx(e)
    cache = 2 * 2 * 8 * 12 * (30721 + 1) * 8 * 128
    layer = 4096 * 128 * 80 + e * 3 * 4096 * 14336 + 4096 * 8 + 2 * 4096
    weights = 8 * layer + 4096 + 12 * 4096 + 4096 * 32000
    assert counts.decode_wave_bytes(mx, 12, 30721) == pytest.approx(
        cache + 4 * weights + 4 * 12 * 32000)
    assert counts.decode_wave_flops(mx, 12, 30721) == (
        12 * 6_308_757_504 + 4 * 12 * 32 * 128 * 30721 * 8 + 2 * 12 * 4096 * 32000)


def test_run_without_a_card_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for where in (ROOT, tmp_path):
        if where == tmp_path:       # a checkout of the benchmark alone
            import shutil
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(HERE, tmp_path / "perfbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                            CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                           cwd=where, env=env, capture_output=True, text=True,
                           timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""
