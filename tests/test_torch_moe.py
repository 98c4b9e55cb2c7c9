"""The port's MoE layer and the two MoE archs (``mixtral-8x7b``: top-2 of 8,
window 4096; ``llama4-scout-17b-a16e``: top-1 of 16) against ``repro`` on
the CPU, at their smoke configs, with the reference's parameters carried
across.

Tolerances:
- bf16 compute (the models as they run): the layer's output at the layer
  tolerances of ``tests/test_torch_layers.py`` (2**-7 relative plus 2e-2
  absolute), its aux loss within 2**-7 relative; logits within 3% of the
  largest |logit| as in ``tests/test_torch_transformer.py``.  A router
  near-tie may route one token differently in the two packages' bf16
  sums; the engine, decode-window and launcher comparisons over many
  tokens therefore run in fp32 compute.
- fp32 compute (``COMPUTE_DTYPE`` set to float32 in both packages): the
  routing (gate indices, kept slots, dispatch slots, dropped tokens)
  exactly, the gates and router probabilities within 1e-6, the layer's
  output and aux within 1e-5, ``loss_fn``, every gradient leaf and the
  launcher's losses within 1e-5 relative, decode logits within 1e-5 of the
  largest |logit|, greedy tokens identical.
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
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.serving import DecodeEngine as JEngine, Request as JRequest
from repro_torch.launch import dryrun, specs
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch import train as ttrain
from repro_torch.serving import DecodeEngine, Request
from repro_torch.training.optimizer import value_and_grad

MOE = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2e-2
LOGIT_RTOL, FP32_RTOL = 3e-2, 1e-5


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


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _bf16(a):
    """numpy values rounded to bf16 once, so both sides start equal."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _moe_params(cfg, kind=None, seed=0):
    jp = jl.moe_init(jax.random.PRNGKey(seed), cfg.d_model, cfg.d_ff,
                     cfg.moe_experts, kind or cfg.mlp)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _kw(cfg, kind=None):
    return dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                kind=kind or cfg.mlp)


def _x(cfg, b=2, s=24, seed=1):
    return _bf16(np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)))


def _jax_routing(p, x, *, n_experts, top_k, capacity_factor=1.25):
    """The reference's routing recomputed in jnp, line for line as
    ``repro/models/layers.py:383-403`` computes it inside ``moe_apply``
    (router einsum, softmax, ``lax.top_k``, renormalised gates; per-row
    capacity, the exclusive cumsum of the one-hot, ``keep`` and the
    dispatch slot ``dest`` with its drop sentinel; the gates zeroed where
    dropped, ``:409-410``)."""
    cd = jl.COMPUTE_DTYPE
    b, s, d = x.shape
    tk = s * top_k
    xc = x.astype(cd)
    logits = jnp.einsum("bsd,de->bse", xc,
                        p["router"].astype(cd)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    cap = max(1, -(-int(capacity_factor * s * top_k) // n_experts))
    onehot = jax.nn.one_hot(gate_idx, n_experts, dtype=jnp.int32)
    flat = onehot.reshape(b, tk, n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat)
    pos = jnp.sum(pos * flat, axis=-1)
    idx_flat = gate_idx.reshape(b, tk)
    keep = pos < cap
    dest = jnp.where(keep, idx_flat * cap + pos, n_experts * cap)
    gates = gate_vals.reshape(b, tk).astype(cd)
    gates = jnp.where(keep, gates, 0)
    return {"probs": probs, "gate_idx": gate_idx, "gates": gates,
            "keep": keep, "dest": dest, "cap": cap}


def _same_routing(r, jr):
    assert r.cap == jr["cap"]
    np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(jr["gate_idx"]))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(jr["keep"]))
    np.testing.assert_array_equal(r.dest.numpy(), np.asarray(jr["dest"]))
    np.testing.assert_allclose(_np(r.probs), _np(jr["probs"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(_np(r.gates), _np(jr["gates"]), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_moe_init_has_the_reference_keys_shapes_and_scales(kind):
    cfg = jget("mixtral-8x7b").smoke
    jp, _ = _moe_params(cfg, kind)
    tp = tl.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff,
                     cfg.moe_experts, kind)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32
        assert abs(float(tp[k].std()) / float(jnp.std(jp[k])) - 1) < 0.1, k


@pytest.mark.parametrize("arch,kind", [("mixtral-8x7b", None),
                                       ("llama4-scout-17b-a16e", None),
                                       ("mixtral-8x7b", "gelu")])
def test_moe_apply_matches_reference_in_bf16(arch, kind):
    cfg = jget(arch).smoke
    jp, tp = _moe_params(cfg, kind)
    x = _x(cfg)
    jo, ja = jl.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), **_kw(cfg, kind))
    to, ta = tl.moe_apply(tp, torch.from_numpy(x).bfloat16(), **_kw(cfg, kind))
    assert to.dtype == torch.bfloat16 and ta.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), rtol=BF16_RTOL, atol=BF16_ATOL)
    assert abs(float(ta) - float(ja)) <= BF16_RTOL * abs(float(ja))


@pytest.mark.parametrize("arch", MOE)
def test_routing_matches_reference_exactly_in_fp32(fp32_compute, arch):
    """Gate indices, kept slots, dispatch slots and dropped tokens equal
    the reference's; the layer's output and aux within 1e-5."""
    cfg = jget(arch).smoke
    jp, tp = _moe_params(cfg)
    x = np.random.default_rng(2).normal(size=(3, 40, cfg.d_model)).astype(np.float32)
    jr = _jax_routing(jp, jnp.asarray(x), n_experts=cfg.moe_experts,
                      top_k=cfg.moe_top_k)
    r = tl.moe_route(tp["router"], torch.from_numpy(x),
                     n_experts=cfg.moe_experts, top_k=cfg.moe_top_k)
    _same_routing(r, jr)
    jo, ja = jl.moe_apply(jp, jnp.asarray(x), **_kw(cfg))
    to, ta = tl.moe_apply(tp, torch.from_numpy(x), **_kw(cfg))
    np.testing.assert_allclose(_np(to), _np(jo), rtol=FP32_RTOL, atol=FP32_RTOL)
    assert abs(float(ta) - float(ja)) <= FP32_RTOL * abs(float(ja))


@pytest.mark.parametrize("arch", MOE)
def test_exact_ties_pick_the_lowest_experts_as_lax_top_k(fp32_compute, arch):
    """A zero router makes every probability 1/E: ``lax.top_k`` picks
    experts ``0..k-1`` for every token, and so does the port."""
    cfg = jget(arch).smoke
    jp, tp = _moe_params(cfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(3).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    jr = _jax_routing(jp, jnp.asarray(x), n_experts=cfg.moe_experts,
                      top_k=cfg.moe_top_k)
    r = tl.moe_route(tp["router"], torch.from_numpy(x),
                     n_experts=cfg.moe_experts, top_k=cfg.moe_top_k)
    want = np.broadcast_to(np.arange(cfg.moe_top_k), (2, 16, cfg.moe_top_k))
    np.testing.assert_array_equal(np.asarray(jr["gate_idx"]), want)
    _same_routing(r, jr)
    jo, ja = jl.moe_apply(jp, jnp.asarray(x), **_kw(cfg))
    to, ta = tl.moe_apply(tp, torch.from_numpy(x), **_kw(cfg))
    np.testing.assert_allclose(_np(to), _np(jo), rtol=FP32_RTOL, atol=FP32_RTOL)
    assert abs(float(ta) - float(ja)) <= FP32_RTOL * abs(float(ja))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_capacity_overflow_drops_the_same_tokens(fp32_compute, capacity_factor):
    """A router that sends every token to expert 0 first (and, by ties,
    expert 1 second) overflows both queues: the tokens past ``cap`` in
    each row are dropped, the same ones as the reference's, and their
    slots contribute nothing."""
    cfg = jget("mixtral-8x7b").smoke
    jp, tp = _moe_params(cfg)
    router = np.zeros((cfg.d_model, cfg.moe_experts), np.float32)
    router[:, 0] = 1.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.abs(np.random.default_rng(4).normal(
        size=(2, 24, cfg.d_model))).astype(np.float32) + 0.1
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
              capacity_factor=capacity_factor)
    jr = _jax_routing(jp, jnp.asarray(x), **kw)
    r = tl.moe_route(tp["router"], torch.from_numpy(x), **kw)
    _same_routing(r, jr)
    dropped = int((~r.keep).sum())
    assert dropped == 2 * 2 * (24 - r.cap) > 0
    assert (r.dest[~r.keep] == cfg.moe_experts * r.cap).all()
    assert (r.gates[~r.keep] == 0).all()
    jo, ja = jl.moe_apply(jp, jnp.asarray(x), kind=cfg.mlp, **kw)
    to, ta = tl.moe_apply(tp, torch.from_numpy(x), kind=cfg.mlp, **kw)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=FP32_RTOL, atol=FP32_RTOL)
    assert abs(float(ta) - float(ja)) <= FP32_RTOL * abs(float(ja))


@pytest.mark.parametrize("arch", MOE)
def test_given_gate_idx_replays_the_routing(arch):
    """``moe_apply(gate_idx=...)`` with the layer's own choices gives the
    same output and aux bitwise, and another choice is honoured."""
    cfg = jget(arch).smoke
    _, tp = _moe_params(cfg)
    x = torch.from_numpy(_x(cfg)).bfloat16()
    r = tl.moe_route(tp["router"], x, n_experts=cfg.moe_experts,
                     top_k=cfg.moe_top_k)
    out, aux = tl.moe_apply(tp, x, **_kw(cfg))
    out2, aux2 = tl.moe_apply(tp, x, gate_idx=r.gate_idx, **_kw(cfg))
    assert torch.equal(out, out2) and torch.equal(aux, aux2)
    other = (r.gate_idx + 1) % cfg.moe_experts
    r2 = tl.moe_route(tp["router"], x, n_experts=cfg.moe_experts,
                      top_k=cfg.moe_top_k, gate_idx=other)
    assert torch.equal(r2.gate_idx, other)
    assert torch.equal(r2.probs, r.probs)


@pytest.mark.parametrize("arch", MOE)
def test_decode_shape_never_drops(arch):
    """At one position a row's capacity is 1 and its top-k experts are
    distinct, so a decode step keeps every choice."""
    cfg = jget(arch).smoke
    _, tp = _moe_params(cfg)
    x = torch.from_numpy(_x(cfg, b=5, s=1)).bfloat16()
    r = tl.moe_route(tp["router"], x, n_experts=cfg.moe_experts,
                     top_k=cfg.moe_top_k)
    assert r.cap == 1 and bool(r.keep.all())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _carried(cfg, seed=0):
    jp = jt.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, tt.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _close(got, exp, rtol=LOGIT_RTOL):
    exp = np.asarray(exp, np.float32)
    err = np.abs(_np(got) - exp).max()
    assert err <= rtol * np.abs(exp).max(), (err, np.abs(exp).max())


@pytest.mark.parametrize("arch", MOE)
def test_param_counts_match_reference(arch):
    """``param_count`` and ``active_param_count`` of the full configs (and
    the smoke configs) equal the reference's; a dense arch's active count
    is its count."""
    for cfg in (jget(arch).model, jget(arch).smoke):
        assert tt.param_count(cfg) == jt.param_count(cfg)
        assert tt.active_param_count(cfg) == jt.active_param_count(cfg)
        assert tt.active_param_count(cfg) < tt.param_count(cfg)
    dense = jget("qwen3-0.6b").model
    assert tt.active_param_count(dense) == tt.param_count(dense)


@pytest.mark.parametrize("arch", MOE)
def test_params_carry_the_expert_stacks_across(arch):
    """``params_from_numpy``/``params_to_numpy`` round-trip the reference's
    tree, the router ``[L, D, E]`` and expert stacks ``[L, E, ·, ·]``
    included; the port's own init builds the same tree."""
    cfg = jget(arch).smoke
    jp, tp = _carried(cfg)
    tree = jax.tree.map(np.asarray, jp)
    back = tt.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert tree["layers"]["moe"]["w_gate"].shape == (
        cfg.n_layers, cfg.moe_experts, cfg.d_model, cfg.d_ff)
    own = tt.params_to_numpy(tt.init_params(cfg, torch.Generator().manual_seed(0)))
    assert jax.tree.structure(own) == jax.tree.structure(tree)
    assert [a.shape for a in jax.tree.leaves(own)] == \
        [a.shape for a in jax.tree.leaves(tree)]


def _tokens(cfg, batch, seq, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _loss_and_grads(cfg, seq, batch=2):
    jp, tp = _carried(cfg)
    b = _tokens(cfg, batch, seq)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jt.loss_fn(cfg, p, bb)))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = value_and_grad(
        lambda p, bb: tt.loss_fn(cfg, p, bb), tp,
        {k: torch.from_numpy(v) for k, v in b.items()})
    return (float(jloss), jax.tree.map(np.asarray, jgrads), float(loss),
            tt.params_to_numpy(grads))


def _fro(got, exp):
    return float(np.linalg.norm(got - exp) / max(np.linalg.norm(exp), 1e-30))


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_jax_in_fp32(fp32_compute, arch):
    """``loss_fn`` (``nll + 0.01 · aux``) and every gradient leaf, the
    router and the expert stacks included, within 1e-5 of
    ``jax.value_and_grad`` of the reference's; at 128 positions mixtral's
    64-position window masks."""
    cfg = jget(arch).smoke
    jloss, jgrads, loss, grads = _loss_and_grads(cfg, 128)
    assert abs(loss - jloss) <= FP32_RTOL * abs(jloss), (loss, jloss)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             jax.tree.leaves(grads)):
        assert g.shape == jg.shape and np.abs(jg).max() > 0
        assert _fro(g, jg) <= FP32_RTOL, (jax.tree_util.keystr(path),
                                          _fro(g, jg))


@pytest.mark.parametrize("arch", MOE)
def test_loss_carries_the_aux_term(arch):
    """The port's loss is the mean cross-entropy plus 0.01 x the layers'
    summed aux, which is nonzero for an MoE config."""
    cfg = jget(arch).smoke
    _, tp = _carried(cfg)
    b = {k: torch.from_numpy(v) for k, v in _tokens(cfg, 2, 64).items()}
    with torch.no_grad():
        hidden, aux = tt._backbone(cfg, tp, b["tokens"])
        nll = tt._chunk_loss(hidden, b["targets"], tt._unembed(cfg, tp)) / 128
        loss = tt.loss_fn(cfg, tp, b)
    assert float(aux) > 0.5 * cfg.n_layers
    assert float(loss) == float(nll + 0.01 * aux)


def test_decode_past_the_window_matches_reference(fp32_compute):
    """mixtral-smoke (window 64) decoding 80 positions into a cache of
    ``3 · window`` (a 64-slot ring): every position's logits within 1e-5
    of the largest |logit| of the reference's ``decode_step`` on the same
    tokens.  In fp32, since in bf16 one of these 80 positions (57) meets a
    router near-tie that the two packages' bf16 sums break apart."""
    cfg = jget("mixtral-8x7b").smoke
    jp, tp = _carried(cfg)
    n = cfg.window + 16
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, n)).astype(np.int32)
    jc = jt.init_cache(cfg, 1, 3 * cfg.window, dtype=jnp.float32)
    tc = tt.init_cache(cfg, 1, 3 * cfg.window, dtype=torch.float32,
                       device="cpu")
    assert tc["k"].shape[2] == cfg.window == jc["k"].shape[2]
    step = jax.jit(lambda p, c, t, pos: jt.decode_step(cfg, p, c, t, pos))
    for pos in range(n):
        exp, jc = step(jp, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        got, tc = tt.decode_step(cfg, tp, tc,
                                 torch.from_numpy(toks[:, pos]).long(), pos)
        _close(got, exp, rtol=FP32_RTOL)


def test_decode_past_2_19_at_head_dim_128_matches_reference(fp32_compute):
    """mixtral-smoke at head dim 128 (``dataclasses.replace`` in both
    packages: RoPE's table at ``(128, 1e6)``, as mixtral-8x7b's) decoding
    80 positions from 524,224 into a 64-slot ring, as ``long_500k``'s waves
    do near 2**19: every position's logits within 1e-5 of the largest
    |logit| of the reference's ``decode_step``."""
    jcfg = dataclasses.replace(jget("mixtral-8x7b").smoke, head_dim=128)
    cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke, head_dim=128)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    start, n = 524_224, cfg.window + 16
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (1, n)).astype(np.int32)
    jc = jt.init_cache(jcfg, 1, 3 * cfg.window, dtype=jnp.float32)
    tc = tt.init_cache(cfg, 1, 3 * cfg.window, dtype=torch.float32,
                       device="cpu")
    assert tc["k"].shape[2:] == (cfg.window, cfg.n_kv, 128)
    step = jax.jit(lambda p, c, t, pos: jt.decode_step(jcfg, p, c, t, pos))
    for i in range(n):
        exp, jc = step(jp, jc, jnp.asarray(toks[:, i]), jnp.int32(start + i))
        got, tc = tt.decode_step(cfg, tp, tc,
                                 torch.from_numpy(toks[:, i]).long(), start + i)
        _close(got, exp, rtol=FP32_RTOL)


def test_engine_serves_past_the_window():
    """The reference's ``test_swa_ring_buffer_engine`` on the port:
    mixtral-smoke's engine generates ``window + 8`` tokens on a 64-slot
    ring."""
    cfg = jget("mixtral-8x7b").smoke
    params = tt.init_params(cfg, torch.Generator().manual_seed(1))
    eng = DecodeEngine(cfg, params, batch_slots=1, max_seq=3 * cfg.window,
                       device="cpu")
    eng.submit(Request(rid=0, prompt=[5, 6, 7], max_new=cfg.window + 8))
    done = eng.run()
    assert len(done) == 1 and len(done[0].out) == cfg.window + 8
    assert all(0 <= t < cfg.vocab for t in done[0].out)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_tokens_equal_reference_engine(fp32_compute, arch):
    """Both engines, the same carried parameters and requests (two
    generations over two slots), greedy: identical tokens.  In fp32
    compute (the caches stay bf16): in bf16, router near-ties that the two
    packages' sums break apart change a token within a few waves."""
    cfg = jget(arch).smoke
    jp, tp = _carried(cfg)
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


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_serve_launcher_matches_reference(fp32_compute, arch, monkeypatch,
                                          capsys):
    """``launch.serve --arch <moe arch> --device cpu`` on the reference's
    seeded parameters serves the reference launcher's tokens (8 requests
    over 4 slots, 12 new tokens each; fp32 compute, as above)."""
    cfg = jget(arch).smoke
    _, tp = _carried(cfg)
    exp = jserve.main(["--arch", arch])
    ref_line = capsys.readouterr().out.strip()
    monkeypatch.setattr(tserve.transformer, "init_params", lambda c, gen: tp)
    got = tserve.main(["--arch", arch, "--device", "cpu"])
    line = capsys.readouterr().out.strip()
    assert {r.rid: r.out for r in got} == {r.rid: r.out for r in exp}
    assert line.startswith(ref_line.split(" in ")[0]) and line.endswith("on cpu")


@pytest.mark.parametrize("arch", MOE)
def test_train_launcher_matches_reference(fp32_compute, arch, tmp_path,
                                          monkeypatch, capsys):
    """``launch.train --arch <moe arch> --device cpu`` on the reference's
    seeded parameters: the reference launcher's loss (aux term included)
    at every step within 1e-5, the first within 1 of ln(vocab) (the untied
    unembedding gives logits of unit scale, ~0.5 above it).  In fp32
    compute: in bf16 a router near-tie moves a token's expert, and a
    llama4-smoke loss by up to 3.6e-3 relative."""
    cfg = jget(arch).smoke
    _, tp = _carried(cfg)
    args = ["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "64"]
    monkeypatch.setattr(ttrain.transformer, "init_params", lambda c, gen: tp)
    jout = jtrain.main(args + ["--ckpt", str(tmp_path / "j.npz")])
    ref_line = capsys.readouterr().out.strip()
    out = ttrain.main(args + ["--device", "cpu", "--ckpt",
                              str(tmp_path / "t.npz")])
    line = capsys.readouterr().out.strip()
    jl_, tl_ = ([h["loss"] for h in o["history"]] for o in (jout, out))
    assert len(tl_) == 3 and abs(tl_[0] - np.log(cfg.vocab)) < 1.0
    np.testing.assert_allclose(tl_, jl_, rtol=FP32_RTOL)
    assert line.startswith(ref_line.split(" loss=")[0]) and line.endswith("on cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ttrain.get_config(arch).smoke)


# ---------------------------------------------------------------------------
# chip_smoke.py's decode cells (phase 20) on the CPU at the smoke configs
# ---------------------------------------------------------------------------

H100_BYTES = 85_017_493_504      # an H100 80GB HBM3's total_memory


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (its ``main`` is not run)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_decode(arch_id):
    """The arch at its smoke config with ``decode_32k`` cut to ``[3, 256]``
    (``long_500k`` keeps its length and batch 1)."""
    a = get_config(arch_id)
    cells = (ShapeCell("decode_32k", "decode", {"seq": 256, "batch": 3}),
             ShapeCell("long_500k", "long_decode", {"seq": 524288, "batch": 1}))
    return dataclasses.replace(a, model=a.smoke, shapes=cells)


@pytest.mark.parametrize("arch,cell", [
    ("qwen3-0.6b", "decode_32k"), ("gemma-2b", "decode_32k"),
    ("starcoder2-7b", "decode_32k"), ("mixtral-8x7b", "decode_32k"),
    ("mixtral-8x7b", "long_500k"), ("llama4-scout-17b-a16e", "decode_32k")])
def test_decode_cut_is_the_largest_batch_that_fits(cs, arch, cell):
    """``decode_cut`` at each phase-20 cell's full width on an H100's
    memory: the reckoned need at the cut batch fits in ``TRAIN_FIT`` of the
    card and one sequence more does not (or the batch is the cell's), and
    the cut plan's meta trace holds exactly the fp32 parameters, the bf16
    cache of the cut batch, its tokens and the position."""
    from repro_torch.models import transformer

    n_layers = dict(cs.DECODE_RUNS)[arch]
    cut_arch, cut = cs.decode_cut(get_config(arch), cell, n_layers, H100_BYTES)
    b, gb = cut["batch"], cut["gb_by_batch"]
    assert 1 <= b <= cut["full_batch"] and gb[b] <= cut["limit_gb"]
    assert b == cut["full_batch"] or gb[b + 1] > cut["limit_gb"]
    cfg = cut_arch.model
    assert cfg.n_layers == (n_layers or get_config(arch).model.n_layers)
    assert cfg.d_model == get_config(arch).model.d_model
    rec = dryrun.run_cell(cut_arch, cell, make_test_mesh((1, 1), device="meta"),
                          "1x1")
    assert rec["ok"], rec.get("error")
    c = transformer.cache_len(cfg, cut_arch.shapes[0].params["seq"])
    cache = 2 * 2 * cfg.n_layers * b * c * cfg.n_kv * cfg.head_dim
    params = 4 * (transformer.param_count(cfg) + cs.uncounted_params(cfg))
    assert rec["argument_size_in_bytes"] == params + cache + 4 * b + 4


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama4-scout-17b-a16e"])
def test_decode_plan_mask_check_on_the_cpu(cs, arch):
    """Phase 20's mask gate at a smoke config on the CPU: the ``decode_32k``
    plan cut to ``[3, 256]`` with the cache filled from the plan's seed; a
    wave 64 positions before the last, then every slot past it refilled
    from another seed and the wave again: bitwise equal logits.  Refilling
    the slots before it moves them, so the check reads the cache."""
    from repro_torch.models import transformer

    cut_arch, cut = cs.decode_cut(_smoke_decode(arch), "decode_32k", None,
                                  10 ** 9)
    assert cut["batch"] == 3
    plan = specs.build_cell(cut_arch, cut_arch.shapes[0],
                            make_test_mesh((1, 1), device="cpu"))
    args, _ = cs.decode_plan_args(
        cut_arch, cs.stacked_params(cut_arch.model, "cpu"), 1, "cpu")
    assert cs._tree_sig(args) == cs._tree_sig(plan.args)
    pos = int(args[3]) - 64
    rec = cs.decode_mask_check(plan, args, pos)
    assert rec == {"pos": pos, "refilled_slots": 64, "bitwise": True}
    p = torch.tensor(pos, dtype=torch.int32)
    before, _ = plan.fn(args[0], args[1], args[2], p)
    cs.fill_cache(args[1], 7, start=0)
    after, _ = transformer.decode_step(
        cut_arch.model, transformer.unstack_layers(args[0]), args[1], args[2], p)
    assert not torch.equal(before, after)


def test_decode_card_vs_cpu_glue_at_the_ring(cs):
    """Phase 20's card-against-CPU gate at mixtral-smoke's ``long_500k``
    (``[1, 524288]``, a 64-slot ring), run with the CPU on both sides: the
    8 waves at the last positions (slots 56-63) equal, the host copy's
    waves replaying the first side's expert choices, none apart."""
    cut_arch, _ = cs.decode_cut(_smoke_decode("mixtral-8x7b"), "long_500k",
                                None, 10 ** 9)
    args, tokens = cs.decode_plan_args(
        cut_arch, cs.stacked_params(cut_arch.model, "cpu"), cs.LONG_WAVES,
        "cpu")
    last = int(args[3])
    positions = list(range(last - cs.LONG_WAVES + 1, last + 1))
    assert [p % cut_arch.model.window for p in positions] == list(range(56, 64))
    res = cs.decode_card_vs_cpu(cut_arch.model, args[0], args[1], tokens,
                                positions, "cpu")
    assert res["layers"] == 1 and res["rows"] == 1
    assert [w["pos"] for w in res["waves"]] == positions
    assert all(w["max_abs_diff"] == 0.0 for w in res["waves"])
    assert res["routing"]["differ"] == 0
    assert res["routing"]["decisions"] == cs.LONG_WAVES * cut_arch.model.moe_top_k


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-7b",
                                  "mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_decode_wave_bytes_counts_what_a_wave_reads(cs, arch):
    """Phase 20's byte bound at a smoke config on the CPU, a wave of one
    row (one token): the bf16 cache, its written slot and the fp32 logits,
    every fp32 weight once, except that an untied embedding table gives one
    row and each MoE layer its ``moe_top_k`` chosen experts (one row routes
    to ``top_k`` distinct experts), recorded by ``layer_routes``."""
    from repro_torch.models import transformer

    cfg = get_config(arch).smoke
    params = cs.stacked_params(cfg, "cpu")
    cache = transformer.init_cache(cfg, 1, 256, device="cpu")
    token = torch.tensor([5], dtype=torch.int32)
    per = transformer.unstack_layers(params)
    with cs.layer_routes(tl, per) as tape:
        transformer.decode_step(cfg, per, cache, token, 255)
    got = cs.decode_wave_bytes(cfg, params, cache, token,
                               tape if cfg.moe_experts else None)
    c = cache["k"].shape[2]
    cache_bytes = 2 * 2 * cfg.n_layers * c * cfg.n_kv * cfg.head_dim
    exp = cache_bytes + cache_bytes // c + 4 * cfg.vocab
    for path, x in specs.tree_paths(params):
        n = x.numel()
        if path == "['embed']" and not cfg.tie_embeddings:
            n = cfg.d_model
        elif "['moe']" in path and "router" not in path:
            n = n // cfg.moe_experts * cfg.moe_top_k
        exp += 4 * n
    assert got == exp
    assert all(r[0].gate_idx.unique().numel() == cfg.moe_top_k
               for r in tape.routes)


def test_rope_card_vs_cpu_glue_on_the_cpu(cs):
    """Phase 20's RoPE gate run with the CPU on both sides: every arch's
    head dim and theta at ``ROPE_ENDS``, each difference 0."""
    for arch in dict(cs.DECODE_RUNS):
        res = cs.rope_card_vs_cpu(get_config(arch).model, "cpu")
        assert res == {end: 0.0 for end in cs.ROPE_ENDS}
