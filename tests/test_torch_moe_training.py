"""MoE training in the port against ``repro`` on the CPU: the expert
block's mesh branches differentiated, a train step of each MoE smoke
config run from its cell plan on a ``(2, 8)`` mesh, the layer-keyed
routing replay that ``chip_smoke.py`` holds the card's MoE steps with, and
the MoE train launcher's restart.

- The expert block's gradients (``x``, the router, ``w_gate``, ``w_up``,
  ``w_down``) of ``sum(y · ct) + aux`` on a ``(2, 8)`` mesh against
  ``jax.value_and_grad`` through the reference's branch in a 16-device
  subprocess, fp32 compute in both packages: the model-sharded branch
  (4 experts on a model axis of 8: the reference's ``shard_map`` with its
  ``psum`` over ``model``) and expert parallelism (8 experts), top-2, each with
  the batch split over ``data`` (2 rows) and replicated (3 rows); the
  output and every gradient within 1e-5 of the leaf's largest magnitude,
  the loss within 1e-5 of its terms' summed magnitude.
- ``launch/specs.py``'s train plan of ``mixtral-8x7b``'s and
  ``llama4-scout-17b-a16e``'s smoke configs on a tiny train cell at a CPU
  ``(2, 8)`` mesh (mixtral's layers take the model-sharded branch,
  llama4's expert parallelism): the step's loss and each gradient leaf
  it hands AdamW, in the plan's stacked layout, within 1e-5 (relative,
  relative Frobenius) of ``jax.value_and_grad`` of the reference's
  ``loss_fn`` in fp32 compute.
- ``chip_smoke.layer_routes`` under the per-layer remat: each layer is
  called twice (its forward, then its recompute in the backward, in
  reverse layer order), the recompute routes as the forward did, a
  replay of a run's own routing gives bitwise its loss and gradients, and
  a recompute that routes differently is counted.
- ``launch.train`` of each MoE smoke config preempted after 2 steps and
  resumed to 4, bitwise equal to 4 straight steps.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

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
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import loop
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import adamw_init, tree_leaves, value_and_grad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
FP32_RTOL = 1e-5
TRAIN_TINY = ShapeCell("train_tiny", "train", {"batch": 4, "seq": 32})


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
def smoke():
    """``chip_smoke.py`` as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fro(got, exp):
    return float(np.linalg.norm(got - exp) / max(np.linalg.norm(exp), 1e-30))


# ---------------------------------------------------------------------------
# the expert block's mesh branches, differentiated
# ---------------------------------------------------------------------------

_GRAD_REF = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
import repro.models.layers as jl
from repro.launch.mesh import make_test_mesh
jl.COMPUTE_DTYPE = jnp.float32
d, s = 128, 16
rng = np.random.default_rng(3)
mesh = make_test_mesh((2, 8), ("data", "model"))
out = {}
for name, e, f, k in (("model-sharded", 4, 256, 2), ("expert-parallel", 8, 192, 2)):
    p = {"router": rng.normal(size=(d, e)).astype(np.float32) * 0.5,
         "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) / d ** 0.5,
         "w_up": rng.normal(size=(e, d, f)).astype(np.float32) / d ** 0.5,
         "w_down": rng.normal(size=(e, f, d)).astype(np.float32) / f ** 0.5}
    out.update({f"{name}/p/{k2}": v for k2, v in p.items()})
    for b in (2, 3):
        x = rng.normal(size=(b, s, d)).astype(np.float32)
        ct = rng.normal(size=(b, s, d)).astype(np.float32)

        def loss(p, x, ct=ct, e=e, k=k):
            y, aux = jl.moe_apply(p, x, n_experts=e, top_k=k, kind="swiglu")
            return jnp.sum(y.astype(jnp.float32) * ct) + aux, y

        fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
        with mesh:
            (val, y), (gp, gx) = fn({k2: jnp.asarray(v) for k2, v in p.items()},
                                    jnp.asarray(x))
        tag = f"{name}/{b}"
        out.update({f"{tag}/x": x, f"{tag}/ct": ct, f"{tag}/loss": np.asarray(val),
                    f"{tag}/y": np.asarray(y, np.float32),
                    f"{tag}/grad/x": np.asarray(gx)})
        out.update({f"{tag}/grad/{k2}": np.asarray(v) for k2, v in gp.items()})
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def branch_ref(tmp_path_factory):
    """The reference's outputs and gradients through its branches, from a
    16-device subprocess (jax's device count is fixed at its start)."""
    path = tmp_path_factory.mktemp("branch_grads") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=16",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _GRAD_REF, str(path)], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    return dict(np.load(path))


@pytest.mark.slow
@pytest.mark.parametrize("batch", ["2", "3"])   # split over data, replicated
# top-2 on both branches: at top-1 the renormalised gate is p / p = 1, whose
# gradient is 0, so the router's leaf would hold only each package's
# rounding of that cancellation (the plan test below holds llama4's top-1)
@pytest.mark.parametrize("branch,n_experts,top_k", [("model-sharded", 4, 2),
                                                    ("expert-parallel", 8, 2)])
def test_branch_gradients_match_reference(fp32_compute, branch_ref, branch,
                                          n_experts, top_k, batch):
    """``moe_apply``'s output, ``sum(y · ct) + aux`` and its gradient with
    respect to ``x`` and every expert leaf on a ``(2, 8)`` mesh, against
    ``jax.value_and_grad`` through the reference's branch, within 1e-5 of
    each leaf's largest magnitude (the loss, a sum of terms that cancel,
    within 1e-5 of its terms' summed magnitude); mixtral-like 4 experts take the
    model-sharded branch (``shard_map``, ``psum`` over ``model``), 8 take
    expert parallelism."""
    ref = {k.split("/", 1)[1]: v for k, v in branch_ref.items()
           if k.startswith(branch + "/")}
    names = ["router", "w_down", "w_gate", "w_up"]
    mesh = tmesh.make_test_mesh((2, 8), device="cpu")
    assert (n_experts % mesh.shape["model"] == 0) == (branch == "expert-parallel")
    leaves = [torch.tensor(ref[f"{batch}/x"]).requires_grad_(True)] + [
        torch.tensor(ref[f"p/{k}"]).requires_grad_(True) for k in names]
    y, aux = tl.moe_apply(dict(zip(names, leaves[1:])), leaves[0],
                          n_experts=n_experts, top_k=top_k, kind="swiglu",
                          mesh=mesh)
    terms = y.float() * torch.tensor(ref[f"{batch}/ct"])
    loss = terms.sum() + aux
    grads = torch.autograd.grad(loss, leaves)
    want = ref[f"{batch}/y"]
    assert np.abs(y.detach().numpy() - want).max() <= FP32_RTOL * np.abs(want).max()
    # a sum of terms that cancel: held to the scale of its terms
    scale = float((terms.abs().sum() + aux).detach())
    assert abs(float(loss.detach()) - float(ref[f"{batch}/loss"])) <= FP32_RTOL * scale
    for name, g in zip(["x", *names], grads):
        want = ref[f"{batch}/grad/{name}"]
        scale = np.abs(want).max()
        assert g.shape == want.shape and scale > 0
        assert np.abs(g.numpy() - want).max() <= FP32_RTOL * scale, name


# ---------------------------------------------------------------------------
# a train step of each MoE smoke config from its cell plan
# ---------------------------------------------------------------------------

def _paired(jtree, ttree, path=""):
    """(path, reference leaf, port leaf) of two nested dicts of the same
    keys."""
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(ttree), path
        return [x for k in sorted(jtree)
                for x in _paired(jtree[k], ttree[k], f"{path}/{k}")]
    return [(path, np.asarray(jtree), ttree.detach().numpy())]


@pytest.mark.slow
@pytest.mark.parametrize("arch", MOE)
def test_plan_train_step_matches_jax_grad_in_fp32(fp32_compute, arch,
                                                  monkeypatch):
    """The train plan's step on a ``(2, 8)`` CPU mesh: its loss and the
    gradient it hands AdamW, leaf by leaf in the stacked layout, within
    1e-5 of the reference's ``loss_fn`` under ``jax.value_and_grad`` on
    the same parameters and batch (no mesh there: the branches equal it)."""
    a = get_config(arch)
    cfg = a.smoke
    plan = tspecs.build_lm_cell(dataclasses.replace(a, model=cfg,
                                                    shapes=(TRAIN_TINY,)),
                                TRAIN_TINY, tmesh.make_test_mesh((2, 8), device="cpu"))
    assert plan.mesh_program == (cfg.moe_experts % 8 != 0)
    jcfg = jget(arch).smoke
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    stacked = tt.stack_layers(tt.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu"))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    # the plan's step donates (adamw_update_), whose clipping scales the
    # gradients in place: a copy is recorded
    seen, update = [], opt_lib.adamw_update_

    def recorded(c, grads, state, params):
        seen.append(opt_lib.tree_map(torch.clone, grads))
        return update(c, grads, state, params)

    monkeypatch.setattr(opt_lib, "adamw_update_", recorded)
    _, new_o, stats = plan.fn(stacked, adamw_init(stacked), {
        "tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)})
    assert len(seen) == 1 and int(new_o["step"]) == 1
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(jcfg, p, b)))(
            jp, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    assert abs(float(stats["loss"]) - float(jloss)) <= FP32_RTOL * abs(float(jloss))
    pairs = _paired(jgrads, seen[0])
    assert any("/moe/" in p for p, _, _ in pairs)
    for path, jg, g in pairs:
        assert g.shape == jg.shape and np.abs(jg).max() > 0, path
        assert _fro(g, jg) <= FP32_RTOL, (path, _fro(g, jg))


# ---------------------------------------------------------------------------
# the layer-keyed routing replay under the remat
# ---------------------------------------------------------------------------

def _model(arch, b=2, s=64, seed=0):
    cfg = get_config(arch).smoke
    params = tt.init_params(cfg, torch.Generator().manual_seed(seed))
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (b, s + 1)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return cfg, params, batch, lambda p, bb: tt.loss_fn(cfg, p, bb)


@pytest.mark.parametrize("arch", MOE)
def test_layer_keyed_replay_under_remat_is_bitwise(smoke, arch):
    """Free routing: every layer called twice (forward, recompute) and its
    recompute routing as its forward did.  Replaying those choices in both
    calls gives bitwise the free run's loss and gradients, and each
    layer's own choices are the free run's."""
    cfg, params, batch, loss_fn = _model(arch)
    with smoke.layer_routes(tl, params) as free:
        loss_f, grads_f = value_and_grad(loss_fn, params, batch)
    assert free.calls == [2] * cfg.n_layers
    assert [int(d) for d in free.recompute_differ] == [0] * cfg.n_layers
    with smoke.layer_routes(tl, params, replay=lambda i, j: free.forward[
            i].gate_idx) as rep:
        loss_r, grads_r = value_and_grad(loss_fn, params, batch)
    assert rep.calls == [2] * cfg.n_layers
    assert [int(d) for d in rep.recompute_differ] == [0] * cfg.n_layers
    for a, b in zip(rep.forward, free.forward):
        assert torch.equal(a.gate_idx, b.gate_idx)
        assert torch.equal(a.probs, b.probs)
    assert torch.equal(loss_r, loss_f)
    for a, b in zip(tree_leaves(grads_r), tree_leaves(grads_f)):
        assert torch.equal(a, b)


def test_layer_routes_count_a_recompute_that_routes_differently(smoke,
                                                                monkeypatch):
    """A recompute whose routing moves (here its tokens routed in reverse
    order) passes ``checkpoint``'s shape checks; ``layer_routes`` counts
    its differing decisions in every layer."""
    cfg, params, batch, loss_fn = _model("mixtral-8x7b")
    calls, route = [0], tl.moe_route

    def moved(router, x, **kw):
        calls[0] += 1
        if calls[0] > cfg.n_layers:             # the recomputes
            x = x.flip(1)
        return route(router, x, **kw)

    monkeypatch.setattr(tl, "moe_route", moved)
    with smoke.layer_routes(tl, params) as seen:
        value_and_grad(loss_fn, params, batch)
    assert seen.calls == [2] * cfg.n_layers
    assert all(int(d) > 0 for d in seen.recompute_differ)


# ---------------------------------------------------------------------------
# the MoE train launcher's restart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_launcher_preempted_then_resumed_is_bitwise(arch, tmp_path):
    """``main --steps 4`` straight == 2 steps of ``setup``'s pieces cut by
    the preemption flag, then ``main`` resumed from that checkpoint: every
    parameter (router and expert stacks included), optimizer state and
    loss bitwise."""
    args = ["--arch", arch, "--steps", "4", "--batch", "2", "--seq", "64",
            "--device", "cpu"]
    straight = ttrain.main(args + ["--ckpt", str(tmp_path / "s.npz")])
    s = ttrain.setup(arch, steps=4, batch=2, seq=64, device="cpu",
                     ckpt=str(tmp_path / "r.npz"))
    pre = ckpt.PreemptionHandler()
    cut = loop.run(s.loop, s.opt, s.loss, s.init, s.stream, device="cpu",
                   preemption=pre, hooks=[
                       lambda step, stats: setattr(pre, "preempted", step == 1)])
    assert [h["step"] for h in cut["history"]] == [0, 1]
    saved = ckpt.restore(str(tmp_path / "r.npz"))["params"]["layers"]
    assert sorted(saved[0]["moe"]) == ["router", "w_down", "w_gate", "w_up"]
    resumed = ttrain.main(args + ["--ckpt", str(tmp_path / "r.npz")])
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in straight["history"]][2:]
    for a, b in zip(tree_leaves([straight["params"], straight["opt_state"]]),
                    tree_leaves([resumed["params"], resumed["opt_state"]])):
        assert torch.equal(a, b)
