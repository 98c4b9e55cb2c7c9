"""The port's xDeepFM training path against ``repro``'s on the CPU: the
loss and every gradient leaf (the dense table gradient included) against
``jax.value_and_grad`` of the reference's ``loss_fn``; K4's gathered entry
(``ops.segment_matmul_gathered``, backward ``ref.segment_gathered_vjp_ref``)
against ``jax.vjp`` of the reference's ``embedding_bag``; K5's entry
(``ops.cin_layer``, backward ``ref.cin_layer_vjp_ref``) against ``jax.vjp``
of the reference's einsum CIN layer with its relu; and ``launch.train
--arch xdeepfm`` against the reference's launcher.  The reference's
parameters are carried across by ``params_from_numpy``.

Tolerances: 1e-5 relative plus 1e-5 of the leaf's largest magnitude
(absolute), as ``tests/test_torch_gnn.py`` holds the GNN gradients.  Both
sides compute the same float32 math and only sum in another order; the
largest gap measured on the model's leaves is 4e-7 of the leaf's scale.
The launcher's losses within 1e-5 relative; a run cut by the preemption
flag and resumed equals a straight one bitwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import train as jtrain
from repro.models import recsys as jr
from repro_torch.data.synthetic import ClickStream
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.models import recsys as tr
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import loop
from repro_torch.training.optimizer import tree_leaves, value_and_grad

RTOL = ATOL = 1e-5
CFG = jget("xdeepfm").smoke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    jp = jr.init_params(CFG, jax.random.PRNGKey(0))
    return jp, tr.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _close(got, exp, what):
    got = got.detach().float().numpy()
    exp = np.asarray(exp, np.float32)
    np.testing.assert_allclose(
        got, exp, rtol=RTOL, atol=ATOL * max(float(np.abs(exp).max()), 1e-30),
        err_msg=what)


@pytest.mark.parametrize("rows,seed", [(64, 3), (257, 11)])
def test_loss_and_grads_match_jax(carried, rows, seed):
    """Every leaf of ``jax.grad`` of the reference's loss: the dense
    ``[n_sparse · vocab, D]`` table gradient (single-hot gathers and the
    multi-hot mean bags), the wide weights, the three CIN weights through
    K5's Function, the MLP and the bias."""
    jp, tp = carried
    nb = ClickStream(CFG, rows, seed=seed).next()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jr.loss_fn(CFG, p, b)))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, grads = value_and_grad(lambda p, b: tr.loss_fn(CFG, p, b), tp,
                                 tr.batch_to_torch(nb, "cpu"))
    _close(loss, jloss, "loss")
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    leaves = tree_leaves(grads)
    assert len(paths) == len(leaves) == len(tree_leaves(tp))
    for (path, jg), g in zip(paths, leaves):
        assert tuple(g.shape) == jg.shape, jax.tree_util.keystr(path)
        _close(g, jg, jax.tree_util.keystr(path))
    table = leaves[[jax.tree_util.keystr(p) for p, _ in paths].index("['table']")]
    assert table.shape == tp["table"].shape and bool((table != 0).any())


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_embedding_bag_function_matches_jax_vjp(mode):
    """K4's gathered entry, declared sorted as the model calls it in mean
    mode: forward and the table's gradient against ``jax.vjp`` of
    ``recsys.embedding_bag``; bag ids past the last bag give nothing, and
    empty bags divide by 1."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, size=120).astype(np.int32)
    seg = np.sort(rng.integers(0, 40, size=120)).astype(np.int32)
    seg[-5:] = 37                      # at or past the 37 bags: dropped
    cot = rng.normal(size=(37, 6)).astype(np.float32)
    jout, vjp = jax.vjp(lambda t: jr.embedding_bag(
        t, jnp.asarray(idx), jnp.asarray(seg), 37, mode=mode), jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_(True)
    out = ops.segment_matmul_gathered(t, torch.from_numpy(idx),
                                      torch.from_numpy(seg), 37,
                                      ids_sorted=True, mean=mode == "mean")
    _close(out, jout, "forward")
    (grad,) = torch.autograd.grad(out, t, torch.from_numpy(cot))
    _close(grad, jgrad, "table gradient")
    dropped = np.setdiff1d(idx[seg >= 37], idx[seg < 37])
    assert not grad.numpy()[dropped].any()


def test_segment_gathered_vjp_ref_drops_out_of_range():
    """Negative indices count from the end (as ``take_rows_ref`` reads
    them), indices outside ``[-R, R)`` and ids outside ``[0, N)`` add
    nothing; the gradient is dense, in the table's dtype."""
    g = torch.arange(1.0, 7.0).reshape(3, 2)
    idx = torch.tensor([0, -1, 9, 2, 1], dtype=torch.int32)
    seg = torch.tensor([0, 0, 1, 2, 3], dtype=torch.int32)
    grad = ref.segment_gathered_vjp_ref(g, (4, 2), idx, seg, mean=False)
    exp = torch.zeros(4, 2)
    exp[0] += g[0]
    exp[3] += g[0]
    exp[2] += g[2]
    assert torch.equal(grad, exp)
    mean = ref.segment_gathered_vjp_ref(g, (4, 2), idx, seg, mean=True)
    assert torch.equal(mean[0], g[0] / 2) and torch.equal(mean[2], g[2])
    assert ref.segment_gathered_vjp_ref(g.half(), (4, 2), idx, seg,
                                        mean=False).dtype == torch.float16


@pytest.mark.parametrize("chunk", [None, 3])
def test_cin_function_matches_jax_vjp(chunk, monkeypatch):
    """K5's entry: forward and the three gradients against ``jax.vjp`` of
    ``relu(einsum('bhd,bmd,ohm->bod'))`` (relu's gradient 0 at 0), with
    the backward's batch chunk at its default (the whole batch here) and
    at 3 rows."""
    rng = np.random.default_rng(2)
    b, h, m, d, o = 10, 7, 5, 6, 9
    xk = rng.normal(size=(b, h, d)).astype(np.float32)
    x0 = rng.normal(size=(b, m, d)).astype(np.float32)
    w = rng.normal(size=(o, h, m)).astype(np.float32)
    cot = rng.normal(size=(b, o, d)).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, c, e: jax.nn.relu(
        jnp.einsum("bhd,bmd,ohm->bod", a, c, e)), *map(jnp.asarray, (xk, x0, w)))
    jgrads = vjp(jnp.asarray(cot))
    if chunk is not None:
        monkeypatch.setattr(ref, "CIN_VJP_CHUNK_BYTES", 4 * d * h * m * chunk)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (xk, x0, w)]
    out = ops.cin_layer(*leaves)
    _close(out, jout, "forward")
    assert bool((out == 0).any()) and bool((out > 0).any())
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for name, g, jg in zip(("xk", "x0", "w"), grads, jgrads):
        _close(g, jg, f"d{name}")


def test_first_cin_layer_sums_both_uses_of_x0():
    """Layer 1 reads x0 as both operands: its gradient is the sum of the
    two, as ``jax.grad`` gives it."""
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(6, 5, 4)).astype(np.float32)
    w = rng.normal(size=(3, 5, 5)).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jax.nn.relu(
        jnp.einsum("bhd,bmd,ohm->bod", a, a, jnp.asarray(w)))))(jnp.asarray(x0))
    x = torch.from_numpy(x0).requires_grad_(True)
    (g,) = torch.autograd.grad(ops.cin_layer(x, x, torch.from_numpy(w)).sum(), x)
    _close(g, jg, "dx0")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_recsys_launcher_matches_reference(carried, tmp_path, monkeypatch,
                                           capsys):
    """``launch.train --arch xdeepfm --device cpu`` on the reference's
    seeded parameters: the reference launcher's loss at every step and the
    same printed line."""
    jp, tp = carried
    monkeypatch.setattr(ttrain.recsys, "init_params", lambda c, gen: tp)
    args = ["--arch", "xdeepfm", "--steps", "4", "--batch", "32"]
    jout = jtrain.main(args + ["--ckpt", str(tmp_path / "j.npz")])
    ref_line = capsys.readouterr().out.strip()
    out = ttrain.main(args + ["--device", "cpu", "--ckpt",
                              str(tmp_path / "t.npz")])
    line = capsys.readouterr().out.strip()
    jl = [h["loss"] for h in jout["history"]]
    tl = [h["loss"] for h in out["history"]]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert line.startswith(ref_line.split(" loss=")[0]) and line.endswith("on cpu")


def test_recsys_launcher_preempted_then_resumed_is_bitwise(tmp_path):
    """``main --steps 6`` straight == 3 steps of ``setup``'s pieces cut by
    the preemption flag, then ``main`` resumed from that checkpoint: every
    parameter, optimizer state and loss bitwise."""
    args = ["--arch", "xdeepfm", "--steps", "6", "--device", "cpu"]
    straight = ttrain.main(args + ["--ckpt", str(tmp_path / "s.npz")])
    s = ttrain.setup("xdeepfm", steps=6, device="cpu",
                     ckpt=str(tmp_path / "r.npz"))
    pre = ckpt.PreemptionHandler()
    cut = loop.run(s.loop, s.opt, s.loss, s.init, s.stream, device="cpu",
                   preemption=pre, hooks=[
                       lambda step, stats: setattr(pre, "preempted", step == 2)])
    assert [h["step"] for h in cut["history"]] == [0, 1, 2]
    resumed = ttrain.main(args + ["--ckpt", str(tmp_path / "r.npz")])
    assert [h["step"] for h in resumed["history"]] == [3, 4, 5]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in straight["history"]][3:]
    for a, b in zip(tree_leaves([straight["params"], straight["opt_state"]]),
                    tree_leaves([resumed["params"], resumed["opt_state"]])):
        assert torch.equal(a, b)


def test_serve_and_retrieval_build_no_graph(carried):
    """``serve`` and ``retrieval_score`` stay under ``torch.no_grad``."""
    _, tp = carried
    params = {k: v for k, v in tp.items()}
    params["table"] = tp["table"].clone().requires_grad_(True)
    b = tr.batch_to_torch(ClickStream(CFG, 4, seed=1).next(), "cpu")
    assert not tr.serve(CFG, params, b).requires_grad
    assert tr.forward(CFG, params, b).requires_grad
