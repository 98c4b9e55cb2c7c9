"""The port's LM training path against ``repro``'s on the CPU: the
transformer's chunked-loss ``loss_fn`` and every gradient leaf against
``jax.value_and_grad`` of the reference's, the differentiable attention
entry (``ops.flash_attention_heads``, backward ``ref.attention_vjp_ref``)
against ``jax.vjp`` of the reference's ``layers._chunked_attention``, and
``launch.train --arch qwen3-0.6b`` against the reference's launcher, with
the reference's parameters carried across by ``params_from_numpy``.

Tolerances:
- bf16 compute (the models as they run): the loss within 1e-4 relative,
  each gradient leaf within 5e-2 relative Frobenius error.  Both sides
  round to bf16 at the same places but their bf16 matmuls sum in another
  order, and a value one bf16 step (2**-8) apart carries through the
  backward; the measured gaps are at most 8.5e-6 (loss) and 2.3e-2
  (leaves) at these configs.
- starcoder2-smoke's bf16 loss (untied, logits of unit scale) within
  ``UNTIED_LOSS_RTOL`` = 3e-4: twice the reference's own bf16-to-fp32 gap
  at that config (see the constant).
- fp32 compute (``COMPUTE_DTYPE`` set to float32 in both packages): the
  loss and each leaf within 1e-5 relative; the measured gaps are below
  1.6e-6, so the casts, the remat and the chunked loss add nothing beyond
  fp32 summation order.
- the attention backward: fp32 within 1e-5 of each gradient's largest
  magnitude (atol) plus 1e-5 relative; bf16 within 1.6e-2 of it, about two
  bf16 steps (both sides compute in fp32 and round each gradient once).
- the launcher's losses within 1e-4 relative; a run cut by the preemption
  flag and resumed equals a straight one bitwise.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.layers as jlayers
import repro.models.transformer as jt
import repro_torch.models.layers as tlayers
import repro_torch.models.transformer as tt
from repro.configs import get_config as jget
from repro.launch import train as jtrain
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import loop
from repro_torch.training.optimizer import tree_leaves, value_and_grad

LOSS_RTOL, GRAD_FRO = 1e-4, 5e-2          # bf16 compute
FP32_RTOL = 1e-5                          # fp32 compute
ATTN_TOL = {np.float32: 1e-5, "bfloat16": 1.6e-2}


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
    for mod in (jlayers, jt):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tlayers, tt):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def _carried(cfg, seed=0):
    jp = jt.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, tt.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _tokens(cfg, batch, seq, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _loss_and_grads(cfg, seq, batch=2):
    """(reference loss, reference grads as numpy, port loss, port grads
    stacked like the reference's) on the same tokens and parameters."""
    jp, tp = _carried(cfg)
    b = _tokens(cfg, batch, seq)
    chunk = min(512, seq)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jt.loss_fn(cfg, p, bb, xent_chunk=chunk)))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = value_and_grad(
        lambda p, bb: tt.loss_fn(cfg, p, bb, xent_chunk=chunk), tp,
        {k: torch.from_numpy(v) for k, v in b.items()})
    return (float(jloss), jax.tree.map(np.asarray, jgrads), float(loss),
            tt.params_to_numpy(grads))


def _fro(got, exp):
    return float(np.linalg.norm(got - exp) / max(np.linalg.norm(exp), 1e-30))


@pytest.mark.parametrize("arch,seq", [("qwen3-0.6b", 128), ("gemma-2b", 128),
                                      ("qwen3-0.6b", 512)])
def test_loss_and_grads_match_jax(arch, seq):
    """qwen3-smoke (GQA, qk-norm, SwiGLU) and gemma-smoke (MQA, GeGLU),
    both 2 layers with tied embeddings (one ``embed`` leaf fed by the
    gather and the unembed), in bf16: at 512 the loss runs one 512-long
    chunk.  Every leaf, ``embed`` included, is compared."""
    cfg = jget(arch).smoke
    assert cfg.n_layers == 2 and cfg.tie_embeddings
    jloss, jgrads, loss, grads = _loss_and_grads(cfg, seq)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             jax.tree.leaves(grads)):
        assert g.shape == jg.shape and np.abs(jg).max() > 0
        assert _fro(g, jg) <= GRAD_FRO, (jax.tree_util.keystr(path),
                                         _fro(g, jg))


@pytest.mark.parametrize("arch,seq", [("qwen3-0.6b", 640), ("gemma-2b", 128)])
def test_loss_and_grads_match_jax_in_fp32(fp32_compute, arch, seq):
    """The same with both packages computing in fp32: the remat, the
    chunked loss and the attention backward match to fp32 summation order.
    At 640 the loss, as the reference's, sums ``640 // 512`` chunks over
    ``B·S``, and the attention backward runs two query blocks."""
    cfg = jget(arch).smoke
    jloss, jgrads, loss, grads = _loss_and_grads(cfg, seq)
    assert abs(loss - jloss) <= FP32_RTOL * abs(jloss), (loss, jloss)
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             jax.tree.leaves(grads)):
        assert _fro(g, jg) <= FP32_RTOL, (jax.tree_util.keystr(path),
                                          _fro(g, jg))


# starcoder2-smoke's loss in bf16: its untied unembedding (scale 1/sqrt(d))
# gives logits of unit scale where the tied configs' sit near 0, so the loss
# reads the bf16 hidden states more strongly.  The reference's own bf16 loss
# sits up to 1.48e-4 from its fp32 loss at this config (seeds 0-2, seq 128),
# so two bf16 implementations may sit twice that apart; measured 1.18e-4
# (seq 128) and 6.7e-5 (seq 512) (scripts/lm_bf16_spread.py)
UNTIED_LOSS_RTOL = 3e-4


@pytest.mark.parametrize("compute,seq", [("bf16", 128), ("bf16", 512),
                                         ("fp32", 640)])
def test_untied_layernorm_loss_and_grads_match_jax(request, compute, seq):
    """starcoder2-smoke (LayerNorm with a bias in every norm, a plain GELU
    MLP, untied embeddings, GQA 6 q / 2 kv): the loss and every leaf
    against ``jax.value_and_grad``, ``unembed`` and each norm's ``bias``
    included; leaves within ``GRAD_FRO`` in bf16, loss and leaves within
    ``FP32_RTOL`` with both packages computing in fp32."""
    if compute == "fp32":
        request.getfixturevalue("fp32_compute")
    cfg = jget("starcoder2-7b").smoke
    assert cfg.n_layers == 2 and not cfg.tie_embeddings
    assert (cfg.norm, cfg.mlp) == ("layernorm", "gelu")
    jloss, jgrads, loss, grads = _loss_and_grads(cfg, seq)
    loss_tol, leaf_tol = ((UNTIED_LOSS_RTOL, GRAD_FRO) if compute == "bf16"
                          else (FP32_RTOL, FP32_RTOL))
    assert abs(loss - jloss) <= loss_tol * abs(jloss), (loss, jloss)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    paths = []
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             jax.tree.leaves(grads)):
        paths.append(jax.tree_util.keystr(path))
        assert g.shape == jg.shape and np.abs(jg).max() > 0, paths[-1]
        assert _fro(g, jg) <= leaf_tol, (paths[-1], _fro(g, jg))
    assert "['unembed']" in paths and "['final_norm']['bias']" in paths
    assert {"['layers']['attn_norm']['bias']",
            "['layers']['mlp_norm']['bias']"} <= set(paths)


def test_loss_runs_one_checkpointed_chunk_at_a_time(monkeypatch):
    """``loss_fn`` computes ``S // xent_chunk`` chunks of logits, each
    ``[B, chunk, V]``, and no ``[B, S, V]`` tensor; the backward recomputes
    each chunk (and each layer) once."""
    cfg = jget("qwen3-0.6b").smoke
    _, tp = _carried(cfg)
    b = {k: torch.from_numpy(v) for k, v in _tokens(cfg, 2, 256).items()}
    shapes, layer_calls = [], []
    chunk_loss, layer_fwd = tt._chunk_loss, tt._layer_fwd

    def spy_chunk(h, t, w):
        shapes.append(tuple(h.shape[:2]) + (w.shape[1],))
        return chunk_loss(h, t, w)

    def spy_layer(*a, **kw):
        layer_calls.append(1)
        return layer_fwd(*a, **kw)

    monkeypatch.setattr(tt, "_chunk_loss", spy_chunk)
    monkeypatch.setattr(tt, "_layer_fwd", spy_layer)
    loss, _ = value_and_grad(
        lambda p, bb: tt.loss_fn(cfg, p, bb, xent_chunk=64), tp, b)
    assert shapes == [(2, 64, cfg.vocab)] * 8       # 4 forward, 4 recomputed
    assert len(layer_calls) == 2 * cfg.n_layers
    with torch.no_grad():
        assert float(tt.loss_fn(cfg, tp, b, xent_chunk=64)) == float(loss)


# ---------------------------------------------------------------------------
# the attention Function against jax.vjp of the reference's plain path
# ---------------------------------------------------------------------------

ATTN_CASES = [(512, True, None), (512, True, 128), (640, True, 100),
              (640, False, None)]


def _attention_case(s, dtype, seed):
    rng = np.random.default_rng(seed)
    b, hq, hkv, dh = 1, 4, 2, 16
    q = rng.normal(size=(b, hq, s, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    do = rng.normal(size=(b, hq, s, dh)).astype(np.float32)
    jd = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    td = torch.float32 if dtype == np.float32 else torch.bfloat16
    jx = [jnp.asarray(a, jd) for a in (q, k, v, do)]
    tx = [torch.from_numpy(a).to(td) for a in (q, k, v, do)]
    return jx, tx


def _jax_vjp(causal, window, q, k, v, do):
    """``(out, (dq, dk, dv))`` of the reference's chunked attention."""
    def fn(a, b_, c, d):
        out, vjp = jax.vjp(lambda x, y, z: jlayers._chunked_attention(
            x, y, z, causal=causal, window=window), a, b_, c)
        return out, vjp(d)
    return jax.jit(fn)(q, k, v, do)


def _close_grad(got, exp, tol, what):
    got = got.float().numpy()
    exp = np.asarray(exp, np.float32)
    scale = float(np.abs(exp).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, exp, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("s,causal,window", ATTN_CASES)
def test_attention_function_backward_matches_jax_vjp(s, causal, window, dtype):
    """``ops.flash_attention_heads`` (its plain forward on the CPU) with 4
    query heads over 2 KV heads: forward and the three gradients against
    ``jax.vjp`` of ``layers._chunked_attention`` (causal, windowed, and
    non-causal; at 640 the backward runs a 512- and a 128-query block)."""
    (jq, jk, jv, jdo), (q, k, v, do) = _attention_case(s, dtype, s + (window or 0))
    jout, jgrads = _jax_vjp(causal, window, jq, jk, jv, jdo)
    leaves = [t.transpose(1, 2).contiguous().requires_grad_(True)
              for t in (q, k, v)]
    out = ops.flash_attention_heads(*leaves, causal=causal, window=window)
    assert out.dtype == q.dtype
    tol = ATTN_TOL[dtype]
    _close_grad(out.detach().transpose(1, 2), jout, tol, "forward")
    grads = torch.autograd.grad(out, leaves, do.transpose(1, 2))
    for name, g, jg in zip("qkv", grads, jgrads):
        assert g.dtype == q.dtype
        _close_grad(g.transpose(1, 2), jg, tol, f"d{name}")


@pytest.mark.parametrize("q_chunk", [64, 100])
def test_attention_vjp_ref_query_blocks(q_chunk):
    """``ref.attention_vjp_ref`` gives the same gradients whatever its query
    block (each block recomputes only the keys it can see, causal and
    window bounds included), against ``jax.vjp`` in fp32."""
    s, window = 640, 96
    (jq, jk, jv, jdo), (q, k, v, do) = _attention_case(s, np.float32, 7)
    _, jgrads = _jax_vjp(True, window, jq, jk, jv, jdo)
    grads = ref.attention_vjp_ref(q, k, v, do, causal=True, window=window,
                                  q_chunk=q_chunk)
    for name, g, jg in zip("qkv", grads, jgrads):
        _close_grad(g, jg, ATTN_TOL[np.float32], f"d{name}")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--steps", "3", "--batch", "2", "--seq", "64"]


def test_lm_launcher_matches_reference(tmp_path, monkeypatch, capsys):
    """``launch.train --arch qwen3-0.6b --device cpu`` on the reference's
    seeded parameters: the reference launcher's loss at every step, the
    first near ln(vocab), and the same printed line."""
    cfg = jget("qwen3-0.6b").smoke
    _, tp = _carried(cfg)
    monkeypatch.setattr(ttrain.transformer, "init_params", lambda c, gen: tp)
    jout = jtrain.main(["--arch", "qwen3-0.6b", *LAUNCH,
                        "--ckpt", str(tmp_path / "j.npz")])
    ref_line = capsys.readouterr().out.strip()
    out = ttrain.main(["--arch", "qwen3-0.6b", *LAUNCH, "--device", "cpu",
                       "--ckpt", str(tmp_path / "t.npz")])
    line = capsys.readouterr().out.strip()
    jl = [h["loss"] for h in jout["history"]]
    tl = [h["loss"] for h in out["history"]]
    assert len(tl) == 3 and abs(tl[0] - np.log(cfg.vocab)) < 0.5
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert line.startswith(ref_line.split(" loss=")[0]) and line.endswith("on cpu")


def test_lm_launcher_preempted_then_resumed_is_bitwise(tmp_path):
    """``main --steps 4`` straight == 2 steps of ``setup``'s pieces cut by
    the preemption flag, then ``main`` resumed from that checkpoint: every
    parameter, optimizer state and loss bitwise."""
    args = ["--arch", "qwen3-0.6b", "--steps", "4", "--batch", "2", "--seq",
            "64", "--device", "cpu"]
    straight = ttrain.main(args + ["--ckpt", str(tmp_path / "s.npz")])
    s = ttrain.setup("qwen3-0.6b", steps=4, batch=2, seq=64, device="cpu",
                     ckpt=str(tmp_path / "r.npz"))
    pre = ckpt.PreemptionHandler()
    cut = loop.run(s.loop, s.opt, s.loss, s.init, s.stream, device="cpu",
                   preemption=pre, hooks=[
                       lambda step, stats: setattr(pre, "preempted", step == 1)])
    assert [h["step"] for h in cut["history"]] == [0, 1]
    resumed = ttrain.main(args + ["--ckpt", str(tmp_path / "r.npz")])
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in straight["history"]][2:]
    for a, b in zip(tree_leaves([straight["params"], straight["opt_state"]]),
                    tree_leaves([resumed["params"], resumed["opt_state"]])):
        assert torch.equal(a, b)


def test_serving_paths_build_no_graph():
    """``prefill`` and ``backbone`` stay under ``torch.no_grad`` (the
    serving paths launch what they launched before training landed)."""
    cfg = jget("qwen3-0.6b").smoke
    _, tp = _carried(cfg)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    toks = torch.from_numpy(_tokens(cfg, 1, 16)["tokens"])
    assert not tt.prefill(cfg, tp, toks).requires_grad
    assert not tt.backbone(cfg, tp, toks)[0].requires_grad
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ttrain.get_config("qwen3-0.6b").smoke)
