"""``prefill_32k`` through the port's cell plans against ``repro`` on the CPU,
and ``chip_smoke.py``'s prefill cells of phase 20 (their batch cut, their
peak gate and their plain-route gate) on the CPU at the smoke configs.

The plans run at a scaled cell, ``[2, 256]``: four times mixtral-smoke's
64-position window, so its prefill masks keys past the window, which no
other CPU test of a prefill does.  Tolerances: the dense archs compute in
bf16, their logits within 3% of the largest |logit| as in
``tests/test_torch_transformer.py``; the MoE archs compute in fp32
(``COMPUTE_DTYPE`` set in both packages), so that a router near-tie routes
alike in both, and their logits lie within 1e-5 of the largest |logit|, as
``tests/test_torch_moe.py`` holds decode.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.layers as jl
import repro.models.transformer as jt
import repro_torch.models.layers as tl
import repro_torch.models.transformer as tt
from repro.configs import get_config as jget
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_test_mesh

DENSE = ["qwen3-0.6b", "gemma-2b", "starcoder2-7b"]
MOE = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
LOGIT_RTOL, FP32_RTOL = 3e-2, 1e-5
SEQ, BATCH = 256, 2
H100_BYTES = 85_017_493_504      # an H100 80GB HBM3's total_memory


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fp32_compute(monkeypatch):
    """Both packages computing in float32 where they compute in bf16."""
    for mod in (jl, jt):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tl, tt):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (its ``main`` is not run)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_prefill(arch_id, seq=SEQ, batch=BATCH):
    """The arch at its smoke config with ``prefill_32k`` scaled to
    ``[batch, seq]``."""
    a = get_config(arch_id)
    cell = ShapeCell("prefill_32k", "prefill", {"seq": seq, "batch": batch})
    return dataclasses.replace(a, model=a.smoke, shapes=(cell,))


def _plan_vs_reference(arch_id, rtol):
    arch = _smoke_prefill(arch_id)
    cfg = arch.model
    jp = jt.init_params(cfg, jax.random.PRNGKey(0))
    params = tt.stack_layers(tt.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu"))
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    exp = np.asarray(jt.prefill(cfg, jp, jnp.asarray(toks)), np.float32)
    plan = specs.build_cell(arch, arch.shapes[0],
                            make_test_mesh((1, 1), device="cpu"))
    args = (params, torch.from_numpy(toks))
    assert [(p, tuple(x.shape), x.dtype) for p, x in specs.tree_paths(args)] \
        == [(p, tuple(x.shape), x.dtype)
            for p, x in specs.tree_paths(plan.args)]
    got = plan.fn(*args)
    assert got.dtype == torch.float32 and got.shape == (BATCH, cfg.vocab)
    err = np.abs(got.numpy() - exp).max()
    assert err <= rtol * np.abs(exp).max(), (err, np.abs(exp).max())


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_plan_matches_reference(arch):
    """The port's ``prefill`` plan at ``[2, 256]`` on carried parameters
    against the reference's ``transformer.prefill``, in bf16."""
    _plan_vs_reference(arch, LOGIT_RTOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_plan_matches_reference_in_fp32(fp32_compute, arch):
    """The MoE archs' ``prefill`` plan at ``[2, 256]`` in fp32 against the
    reference's: mixtral-smoke's 64-position window masks three quarters
    of the last queries' keys, and each row routes under its own per-row
    capacity."""
    assert get_config(arch).smoke.window in (None, SEQ // 4)
    _plan_vs_reference(arch, FP32_RTOL)


@pytest.mark.parametrize("arch", ["gemma-2b", "starcoder2-7b", "mixtral-8x7b",
                                  "llama4-scout-17b-a16e"])
def test_prefill_cut_is_the_largest_batch_that_fits(cs, arch):
    """``prefill_cut`` at each phase-20 prefill cell's full width on an
    H100's memory: the reckoned need at the cut batch fits in ``TRAIN_FIT``
    of the card and one sequence more does not (or the batch is the
    cell's 32), at phase 15's depth for the MoE archs (full depth for the
    dense ones), and the cut plan's meta trace holds exactly the fp32
    parameters and the cut batch's tokens."""
    assert arch in cs.PREFILL_ARCHS
    n_layers = dict(cs.DECODE_RUNS)[arch]
    cut_arch, cut = cs.prefill_cut(get_config(arch), n_layers, H100_BYTES)
    b, gb = cut["batch"], cut["gb_by_batch"]
    assert 1 <= b <= cut["full_batch"] == 32 and gb[b] <= cut["limit_gb"]
    assert b == cut["full_batch"] or gb[b + 1] > cut["limit_gb"]
    cfg = cut_arch.model
    assert cfg.n_layers == (n_layers or get_config(arch).model.n_layers)
    assert dataclasses.replace(cfg, n_layers=0) == dataclasses.replace(
        get_config(arch).model, n_layers=0)
    assert cut_arch.shapes[0].params == {"seq": 32768, "batch": b}
    rec = dryrun.run_cell(cut_arch, "prefill_32k",
                          make_test_mesh((1, 1), device="meta"), "1x1")
    assert rec["ok"], rec.get("error")
    params = 4 * (tt.param_count(cfg) + cs.uncounted_params(cfg))
    assert rec["argument_size_in_bytes"] == params + 4 * b * 32768
    assert rec["output_size_in_bytes"] == 4 * b * cfg.vocab


def test_prefill_cut_takes_a_shallower_depth_or_raises(cs):
    """Where one sequence does not fit at the asked depth, ``prefill_cut``
    takes the deepest depth at which it does; where it does not fit at one
    layer, it raises."""
    arch = get_config("mixtral-8x7b")
    per_seq = max(cs.prefill_seq_bytes(arch.model, 32768).values())

    def need(n):
        return sum(cs.lm_fixed_bytes(
            dataclasses.replace(arch.model, n_layers=n))) + per_seq

    card = int(need(6) / cs.TRAIN_FIT) + 1
    assert need(7) > cs.TRAIN_FIT * card
    cut_arch, cut = cs.prefill_cut(arch, 8, card)
    assert (cut["layers"], cut["asked_layers"], cut["batch"]) == (6, 8, 1)
    assert cut_arch.model.n_layers == 6
    with pytest.raises(AssertionError, match="one sequence at one layer"):
        cs.prefill_cut(arch, 8, int(need(1) / cs.TRAIN_FIT) - 1)


def test_prefill_seq_bytes_counts_each_phase_from_the_shapes(cs):
    """The per-sequence reckoning of a prefill layer, by hand at
    llama4-scout's full width (GShard capacity 2,560 a row at 32,768
    positions, top-1 of 16) and qwen3-0.6b's (qk-norm): bf16 residuals and
    activations, fp32 norm and rope temporaries."""
    s = 32768
    cfg = get_config("llama4-scout-17b-a16e").model
    d, f, e = 5120, 8192, 16
    sd, sq, sk, slots = s * d, s * 40 * 128, s * 8 * 128, e * 2560
    got = cs.prefill_seq_bytes(cfg, s)
    assert got["norm"] == 18 * sd
    assert got["attention"] == 4 * sd + 2 * sq + 4 * sk + 8 * sq + 6 * s * 128
    assert got["ffn"] == 8 * sd + 2 * s * d + 2 * (slots + 1) * d + max(
        6 * slots * f + 2 * slots * d, 4 * slots * f + 2 * slots * d + 4 * s * d)
    q = get_config("qwen3-0.6b").model
    got = cs.prefill_seq_bytes(q, s)
    sd, sq, sk = s * 1024, s * 16 * 128, s * 8 * 128
    assert got["attention"] == 4 * sd + 2 * sq + 4 * sk + 12 * sq
    assert got["ffn"] == 8 * sd + 6 * s * 3072


@pytest.mark.parametrize("arch", ["starcoder2-7b", "mixtral-8x7b",
                                  "llama4-scout-17b-a16e"])
def test_prefill_vs_plain_glue_on_the_cpu(cs, arch):
    """Phase 20's plain-route gate at a smoke config with the CPU on both
    routes: equal logits, and for an MoE arch every (token, choice)
    decision of the plain route's own routing equal to the replayed one;
    logits moved past ``LOGIT_RTOL`` fail it."""
    cfg = get_config(arch).smoke
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, SEQ)))
    res = cs.prefill_vs_plain(ops, cfg, params, tokens)
    assert res["dlogit"] == 0.0 and res["largest_logit"] > 0
    if cfg.moe_experts:
        assert res["routing"]["differ"] == 0
        assert res["routing"]["decisions"] == \
            SEQ * cfg.moe_top_k * cfg.n_layers
        assert len(res["drops_by_layer"]) == cfg.n_layers
    else:
        logits = tt.prefill(cfg, params, tokens)
        with pytest.raises(AssertionError, match="differs from the plain"):
            cs.prefill_vs_plain(ops, cfg, params, tokens,
                                logits + LOGIT_RTOL * 2 * logits.abs().max())


def test_prefill_checks_peak_gate_on_the_cpu(cs, monkeypatch):
    """Phase 20's gates past ``run_plan_on_card``'s, on the CPU at
    llama4-smoke's scaled cell (the card's clocks and memory counters
    stubbed): the plain route at matched routing on the first layer, the
    timed calls, and the peak gate, which passes at the reckoning plus the
    allowed transient and fails just past it."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    arch, cut = cs.prefill_cut(_smoke_prefill("llama4-scout-17b-a16e", batch=3),
                               None, 10 ** 9)
    assert cut["batch"] == 3
    plan = specs.build_cell(arch, arch.shapes[0],
                            make_test_mesh((1, 1), device="cpu"))
    args = (cs.stacked_params(arch.model, "cpu"), torch.from_numpy(
        np.random.default_rng(0).integers(
            0, arch.model.vocab, (3, SEQ), dtype=np.int32)))
    allowed = cs.PREFILL_TRANSIENT_GB[arch.arch_id]
    reckoned = cut["gb_by_batch"][3]
    arg_gb = sum(x.numel() * x.element_size()
                 for _, x in specs.tree_paths(args)) / 1e9
    other, base = 1.5, 1.5 + arg_gb

    def res(peak):
        return {"peak_gb": peak, "peak_above_args_gb": peak - base,
                "arg_bytes": arg_gb * 1e9}

    out = cs.prefill_checks(arch, cut, plan, args,
                            res(other + reckoned + allowed - 1e-6), "cpu")
    assert abs(out["other_gb"] - other) < 1e-9
    assert abs(out["transient_gb"] - allowed) < 1e-5
    assert out["vs_plain"]["dlogit"] == 0.0 and out["vs_plain"]["layers"] == 1
    assert out["vs_plain"]["routing"]["differ"] == 0
    assert len(out["call_ms"]) == cs.PREFILL_TIMED
    assert out["tokens_per_s"] > 0 and "busy" not in out
    with pytest.raises(AssertionError, match="over the reckoning"):
        cs.prefill_checks(arch, cut, plan, args,
                          res(other + reckoned + allowed + 1e-3), "cpu")
