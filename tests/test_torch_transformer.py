"""The port's transformer and decode engine against ``repro``'s, on the smoke
configs of the LM archs (dense, and the MoE archs' parameters, prefill and
decode; ``tests/test_torch_moe.py`` holds the rest of MoE), with the
reference's parameters carried across by ``params_from_numpy``.

Tolerance for logits: 3% of the largest |logit|.  Both sides compute in
bf16 with fp32 norms and softmax and round at the same places, but their
bf16 matmuls sum in another order, so a value may round one bf16 step
(2**-8 relative) apart and the step carries through the layers; the
measured gap is 0.8-1.3% of the largest |logit| at these configs.  The KV
cache is held to the same rule: past the first layer its entries carry the
same propagated steps.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as jt
from repro.serving import DecodeEngine as JEngine, Request as JRequest
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt
from repro_torch.serving import DecodeEngine, Request

DENSE = ["qwen3-0.6b", "gemma-2b", "starcoder2-7b"]
MOE = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
LOGIT_RTOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(cfg, seed=0):
    jp = jt.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, tt.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _close(got, exp):
    exp = np.asarray(exp, np.float32)
    err = np.abs(got.float().numpy() - exp).max()
    assert err <= LOGIT_RTOL * np.abs(exp).max(), (err, np.abs(exp).max())


def test_port_configs_equal_reference_configs():
    for arch in DENSE + MOE:
        a, b = jget(arch), get_config(arch)
        assert dataclasses.asdict(a.model) == dataclasses.asdict(b.model)
        assert dataclasses.asdict(a.smoke) == dataclasses.asdict(b.smoke)
        assert [c.name for c in a.shapes] == [c.name for c in b.shapes]


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_params_round_trip_and_count(arch):
    cfg = jget(arch).smoke
    jp, tp = _carried(cfg)
    tree = jax.tree.map(np.asarray, jp)
    back = tt.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert tt.param_count(cfg) == jt.param_count(cfg)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_prefill_and_decode_match_reference(arch):
    cfg = jget(arch).smoke
    jp, tp = _carried(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    exp = jt.prefill(cfg, jp, jnp.asarray(toks))
    got = tt.prefill(cfg, tp, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
    _close(got, exp)

    jc = jt.init_cache(cfg, 2, 32)
    tc = tt.init_cache(cfg, 2, 32, device="cpu")
    step = jax.jit(lambda p, c, t, pos: jt.decode_step(cfg, p, c, t, pos))
    for pos in range(10):
        exp, jc = step(jp, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        got, tc = tt.decode_step(cfg, tp, tc,
                                 torch.from_numpy(toks[:, pos]).long(), pos)
        _close(got, exp)
    for name in ("k", "v"):
        _close(tc[name], jc[name])


def _tiny():
    cfg = get_config("qwen3-0.6b").smoke
    return cfg, tt.init_params(cfg, torch.Generator().manual_seed(0))


def test_engine_serves_all_requests():
    cfg, params = _tiny()
    eng = DecodeEngine(cfg, params, batch_slots=3, max_seq=64, device="cpu")
    for r in range(5):
        eng.submit(Request(rid=r, prompt=[1 + r, 2 + r], max_new=4))
    done = eng.run()
    assert len(done) == 5
    assert all(len(r.out) == 4 for r in done)


def test_greedy_decode_matches_prefill_argmax():
    """The engine's first generated token == argmax of the prefill logits."""
    cfg, params = _tiny()
    prompt = [3, 17, 42]
    expected = int(torch.argmax(
        tt.prefill(cfg, params, torch.tensor([prompt]))[0]))
    eng = DecodeEngine(cfg, params, batch_slots=1, max_seq=32, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new=1))
    done = eng.run()
    assert done[0].out[0] == expected


def test_swa_ring_buffer_engine():
    """A dense smoke config with ``window=64``: the engine works past the
    window length on a 64-slot ring cache."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").smoke, window=64)
    params = tt.init_params(cfg, torch.Generator().manual_seed(1))
    eng = DecodeEngine(cfg, params, batch_slots=1, max_seq=3 * cfg.window,
                       device="cpu")
    assert eng.cache["k"].shape[2] == cfg.window
    eng.submit(Request(rid=0, prompt=[5, 6, 7], max_new=cfg.window + 8))
    done = eng.run()
    assert len(done) == 1 and len(done[0].out) == cfg.window + 8
    assert all(0 <= t < cfg.vocab for t in done[0].out)


def _engines_agree(arch):
    """Both engines, the same carried parameters and requests (two
    generations over two slots), greedy at seed 0: identical tokens."""
    cfg = jget(arch).smoke
    jp, tp = _carried(cfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, rng.integers(2, 6)).tolist()
               for _ in range(4)]
    jeng = JEngine(cfg, jp, batch_slots=2, max_seq=32)
    teng = DecodeEngine(cfg, tp, batch_slots=2, max_seq=32, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=6))
        teng.submit(Request(rid=i, prompt=p, max_new=6))
    jout = {r.rid: r.out for r in jeng.run()}
    tout = {r.rid: r.out for r in teng.run()}
    assert len(tout) == 4 and tout == jout


def test_greedy_tokens_equal_reference_engine():
    """qwen3-smoke's engine against the reference's (``_engines_agree``)."""
    _engines_agree("qwen3-0.6b")


@pytest.mark.parametrize("arch", ["starcoder2-7b", "gemma-2b"])
def test_dense_engine_tokens_equal_reference_engine(arch):
    """The same for starcoder2-smoke (LayerNorm, GELU, untied, a GQA group
    of 3) and gemma-smoke (MQA, GeGLU, tied): identical greedy tokens."""
    _engines_agree(arch)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its ``main`` is not run)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_chip_smoke_param_check_counts_every_leaf(arch):
    """``chip_smoke.check_param_count`` on each smoke config: every leaf's
    elements less ``uncounted_params`` (qk-norm scales, the final norm,
    LayerNorm biases) equal the reference's ``param_count``; starcoder2's
    2 x 2 layer norms and final norm leave 6 x 96 elements out."""
    smoke = _chip_smoke()
    cfg = get_config(arch).smoke
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    n = smoke.check_param_count(cfg, params, jt.param_count(jget(arch).smoke))
    assert n - smoke.uncounted_params(cfg) == tt.param_count(cfg)
    if arch == "starcoder2-7b":
        assert smoke.uncounted_params(cfg) == 6 * cfg.d_model == 576
    with pytest.raises(AssertionError):
        smoke.check_param_count(cfg, params, tt.param_count(cfg) + 1)


@pytest.mark.parametrize("arch,depth", [
    ("qwen3-0.6b", 28), ("gemma-2b", 18), ("starcoder2-7b", 17),
    ("mixtral-8x7b", 2), ("llama4-scout-17b-a16e", 1)])
def test_chip_smoke_depth_cut(arch, depth):
    """``chip_smoke.depth_cut`` at an H100's 85.0 GB: the deepest depth whose
    donated AdamW step fits in 80% of it (4 fp32 copies of the parameters
    and the update's three fp32 slices of ``ADAMW_SLICE`` elements), the
    full width kept, and the reckoning up to the first depth that does not
    (gemma-2b and qwen3-0.6b at full depth)."""
    from repro_torch.training.optimizer import ADAMW_SLICE

    smoke = _chip_smoke()
    cfg, cut = smoke.depth_cut(arch, 85_000_000_000)
    full = get_config(arch).model
    assert cfg.n_layers == depth and cut["copies"] == 4
    assert dataclasses.replace(cfg, n_layers=full.n_layers) == full
    assert cut["gb_by_depth"][depth] <= cut["limit_gb"] == 68.0
    if depth < full.n_layers:
        assert cut["gb_by_depth"][depth + 1] > 68.0
    assert cut["gb_by_depth"][depth] == pytest.approx(
        (16 * tt.param_count(cfg) + 12 * ADAMW_SLICE) / 1e9)


def test_sampling_draws_from_the_generator():
    cfg, params = _tiny()
    outs = []
    for _ in range(2):
        eng = DecodeEngine(cfg, params, batch_slots=2, max_seq=16,
                           temperature=1.0, device="cpu",
                           generator=torch.Generator().manual_seed(7))
        eng.submit(Request(rid=0, prompt=[1, 2], max_new=5))
        outs.append(eng.run()[0].out)
    assert outs[0] == outs[1] and all(0 <= t < cfg.vocab for t in outs[0])
