"""Donation in the port's train steps: ``optimizer.adamw_update_`` and
the train plans' ``make_train_step(..., donate=True)``.

- ``adamw_update_`` writes the new parameters, ``mu``, ``nu`` and ``step``
  into the tensors it is given, bitwise equal to ``adamw_update`` (over
  slices of ``ADAMW_SLICE`` elements, forced small here), within
  ``OPT_RTOL`` / ``OPT_ATOL`` of the reference's ``adamw_update``, every
  leaf keeping its ``data_ptr``; ``adamw_update`` writes nothing it is
  given (each tensor's ``_version`` unchanged).
- Each train plan (``specs.build_cell`` at ``make_test_mesh((1, 1))`` on
  the CPU, smoke configs, inputs from a seed): the dense LMs, both MoE
  archs, the four GNN archs on ``full_graph_sm`` and xDeepFM's
  ``train_batch``.  Its ``fn`` updates arguments 0 and 1 in place and
  equals the returning step of the same loss bitwise over 2 steps
  (``chip_smoke.donated_vs_returning``, the card's same-bits gate).
- qwen3's smoke train cell: the donating plan step against the
  reference's plan step jitted with ``donate_argnums=(0, 1)``, both
  computing in fp32, at the LM tests' fp32 bound (1e-5 relative
  Frobenius).
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jl
import repro.models.transformer as jt
import repro_torch.models.layers as tl
import repro_torch.models.transformer as tt
from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.training import optimizer as opt
from repro_torch.training.optimizer import tree_leaves

OPT_RTOL, OPT_ATOL = 1e-6, 1e-7      # tests/test_torch_training.py's
FP32_RTOL = 1e-5                     # the LM tests' fp32 bound
TRAIN_TINY = ShapeCell("train_tiny", "train", {"batch": 4, "seq": 32})
LM_ARCHS = ["qwen3-0.6b", "gemma-2b", "starcoder2-7b", "mixtral-8x7b",
            "llama4-scout-17b-a16e"]
GNN_ARCHS = ["gcn-cora", "gin-tu", "meshgraphnet", "dimenet"]
FULL_GRAPH_SM = ShapeCell("full_graph_sm", "full_graph",
                          {"n_nodes": 60, "n_edges": 150, "d_feat": 8})
RECSYS_TRAIN = ShapeCell("train_batch", "train_batch", {"batch": 256})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (its ``main`` is not run)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(rng, scale=1.0):
    return {"b": [rng.normal(size=(3,)).astype(np.float32) * scale,
                  rng.normal(size=(2, 9)).astype(np.float32) * scale],
            "a": rng.normal(size=(4, 5)).astype(np.float32) * scale}


def _torch(tree):
    return opt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _clone(tree):
    return opt.tree_map(torch.clone, tree)


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# adamw_update_
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps,clip", [(1, 1.0), (5, 1.0), (5, None)])
def test_adamw_update_matches_reference(monkeypatch, steps, clip):
    """In place, bitwise equal to ``adamw_update`` and within the
    reference's tolerances of ``repro``'s, slices of 7 elements (so the
    18- and 20-element leaves split mid-row), every leaf at its storage."""
    monkeypatch.setattr(opt, "ADAMW_SLICE", 7)
    rng = np.random.default_rng(steps)
    kw = dict(lr=0.05, warmup_steps=2, total_steps=10, clip_norm=clip)
    cfg, jcfg = opt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    p0 = _tree(rng)
    tp = _torch(p0)
    ts = opt.adamw_init(tp)
    rp, rs = _clone(tp), _clone(ts)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.adamw_init(jp)
    ptrs = [x.data_ptr() for x in tree_leaves((tp, ts))]
    for _ in range(steps):
        g = _tree(rng, scale=3.0)
        got_p, got_s, stats = opt.adamw_update_(cfg, _torch(g), ts, tp)
        assert got_p is tp and got_s is ts
        rp, rs, rstats = opt.adamw_update(cfg, _torch(g), rs, rp)
        jp, js, jstats = jopt.adamw_update(jcfg, jax.tree.map(jnp.asarray, g),
                                           js, jp)
        _equal_trees((tp, ts), (rp, rs))
        for k in ("grad_norm", "lr"):
            assert torch.equal(stats[k], rstats[k]), k
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=OPT_RTOL, atol=OPT_ATOL)
    assert [x.data_ptr() for x in tree_leaves((tp, ts))] == ptrs
    assert int(ts["step"]) == steps
    for g, e in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=OPT_RTOL,
                                   atol=OPT_ATOL)


def test_adamw_update_in_place_takes_strided_and_shared_gradients():
    """A transposed parameter (updated whole, not sliced), an expanded
    gradient and one gradient tensor handed for two leaves (as autograd
    may hand it) all give ``adamw_update``'s bits under clipping; the
    shared gradient is scaled into new tensors, never written."""
    rng = np.random.default_rng(3)
    cfg = opt.AdamWConfig(lr=0.05, warmup_steps=1, clip_norm=0.5)
    p = {"t": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)).T,
         "u": torch.from_numpy(rng.normal(size=(6,)).astype(np.float32)),
         "v": torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))}
    shared = torch.from_numpy(rng.normal(size=(6,)).astype(np.float32) * 4)

    def grads():
        return {"t": torch.tensor(2.5).expand(3, 5), "u": shared,
                "v": shared}

    ts = opt.adamw_init(p)
    rp, rs = _clone(p), _clone(ts)
    before = shared.clone()
    rp, rs, rstats = opt.adamw_update(cfg, {k: v.clone() for k, v in
                                            grads().items()}, rs, rp)
    _, _, stats = opt.adamw_update_(cfg, grads(), ts, p)
    _equal_trees((p, ts), (rp, rs))
    assert torch.equal(stats["grad_norm"], rstats["grad_norm"])
    assert float(stats["grad_norm"]) > 0.5          # the clip scales
    assert torch.equal(shared, before)


def test_adamw_update_writes_nothing_it_is_given():
    """The returning update leaves its gradients, state and parameters
    unwritten: every tensor's ``_version`` is unchanged."""
    rng = np.random.default_rng(0)
    cfg = opt.AdamWConfig(lr=0.05, warmup_steps=2, clip_norm=1.0)
    p = _torch(_tree(rng))
    s = opt.adamw_init(p)
    g = _torch(_tree(rng, scale=3.0))
    given = tree_leaves((g, s, p))
    versions = [x._version for x in given]
    values = [x.clone() for x in given]
    new_p, new_s, _ = opt.adamw_update(cfg, g, s, p)
    assert [x._version for x in given] == versions
    for x, v in zip(given, values):
        assert torch.equal(x, v)
    assert not any(a is b for a, b in zip(tree_leaves((new_s, new_p)),
                                          tree_leaves((s, p))))


# ---------------------------------------------------------------------------
# every train plan donates
# ---------------------------------------------------------------------------

def _lm_args(arch_id):
    cfg = get_config(arch_id).smoke
    params = tt.stack_layers(tt.init_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    return params, opt.adamw_init(params), batch


PLANS = ([("lm", a) for a in LM_ARCHS] + [("gnn", a) for a in GNN_ARCHS]
         + [("recsys", "xdeepfm")])


@pytest.mark.parametrize("family,arch_id", PLANS)
def test_train_plan_donates_and_equals_returning_step(cs, family, arch_id):
    """The plan's step writes its parameters and optimizer state in place
    (the same tree objects back, every leaf at its storage, the values
    moved) and equals the returning step bitwise over 2 steps."""
    a = get_config(arch_id)
    cell = {"lm": TRAIN_TINY, "gnn": FULL_GRAPH_SM,
            "recsys": RECSYS_TRAIN}[family]
    arch = dataclasses.replace(a, model=a.smoke, shapes=(cell,))
    plan = specs.build_cell(arch, cell, make_test_mesh((1, 1), device="cpu"))
    assert plan.donate_argnums == (0, 1)
    args = (_lm_args(arch_id) if family == "lm"
            else cs._plan_args(arch, cell, plan, "cpu"))
    assert cs._tree_sig(args) == cs._tree_sig(plan.args)
    start = _clone(args[0])
    rec = cs.donated_vs_returning(plan.fn, lambda: args[:2], [args[2]] * 2,
                                  f"{arch_id}/{cell.name}")
    assert rec["bitwise"] and rec["steps"] == 2
    assert all(np.isfinite(rec["losses"]))
    moved = [not torch.equal(x, y) for x, y in zip(tree_leaves(args[0]),
                                                     tree_leaves(start))]
    assert sum(moved) >= len(moved) // 2, moved
    assert int(args[1]["step"]) == 2 and plan.fn.donate


def test_donated_vs_returning_catches_a_differing_step(cs):
    """The same-bits gate fails when the donated step's values differ
    from the returning one's (a step that adds one ulp to a leaf)."""
    a = get_config("qwen3-0.6b")
    arch = dataclasses.replace(a, model=a.smoke, shapes=(TRAIN_TINY,))
    plan = specs.build_cell(arch, TRAIN_TINY, make_test_mesh((1, 1), device="cpu"))
    args = _lm_args("qwen3-0.6b")

    def off(params, opt_state, batch):
        out = plan.fn(params, opt_state, batch)
        w = params["final_norm"]["scale"]
        w[0] = torch.nextafter(w[0], torch.tensor(np.inf))
        return out

    for k in ("loss_fn", "opt_cfg", "compression", "donate"):
        setattr(off, k, getattr(plan.fn, k))
    with pytest.raises(AssertionError, match="differ"):
        cs.donated_vs_returning(off, lambda: args[:2], [args[2]], "qwen3")


# ---------------------------------------------------------------------------
# against the reference's donated plan step
# ---------------------------------------------------------------------------

@pytest.fixture
def fp32_compute(monkeypatch):
    """Both packages computing in float32 where they compute in bf16."""
    for mod in (jl, jt):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (tl, tt):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def _fro(got, exp):
    return float(np.linalg.norm(got - exp) / max(np.linalg.norm(exp), 1e-30))


def test_lm_plan_step_matches_reference_donated_jit(fp32_compute):
    """qwen3's smoke train cell, 2 steps: the port's donating plan step on
    the CPU against the reference's plan step under ``jax.jit(...,
    donate_argnums=(0, 1))`` at ``make_test_mesh((1, 1))``, from the same
    parameters: each loss within 1e-5, every leaf of the parameters, mu
    and nu within 1e-5 relative Frobenius, the step counts equal."""
    arch_id = "qwen3-0.6b"
    a = get_config(arch_id)
    jcfg = jget(arch_id).smoke
    arch = dataclasses.replace(a, model=a.smoke, shapes=(TRAIN_TINY,))
    plan = specs.build_cell(arch, TRAIN_TINY, make_test_mesh((1, 1), device="cpu"))
    jarch = dataclasses.replace(jget(arch_id), model=jcfg)
    jmesh = jmake_test_mesh((1, 1))
    jplan = jspecs.build_lm_cell(jarch, TRAIN_TINY, jmesh)
    assert tuple(jplan.donate_argnums) == plan.donate_argnums == (0, 1)
    jstep = jax.jit(jplan.fn, in_shardings=jplan.in_shardings,
                    out_shardings=jplan.out_shardings,
                    donate_argnums=jplan.donate_argnums)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    params = tt.stack_layers(tt.params_from_numpy(
        a.smoke, jax.tree.map(np.asarray, jp), device="cpu"))
    state, js = opt.adamw_init(params), jopt.adamw_init(jp)
    rng = np.random.default_rng(0)
    for _ in range(2):
        toks, tgts = (rng.integers(0, a.smoke.vocab, (4, 32)).astype(np.int32)
                      for _ in range(2))
        params, state, stats = plan.fn(params, state, {
            "tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)})
        with jmesh:
            jp, js, jstats = jstep(jp, js, {"tokens": jnp.asarray(toks),
                                            "targets": jnp.asarray(tgts)})
        assert abs(float(stats["loss"]) - float(jstats["loss"])) <= \
            FP32_RTOL * abs(float(jstats["loss"]))
    assert int(state["step"]) == int(js["step"]) == 2
    got = tree_leaves((params, state["mu"], state["nu"]))
    exp = jax.tree.leaves((jp, js["mu"], js["nu"]))
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        g, e = g.numpy(), np.asarray(e)
        assert g.shape == e.shape
        assert _fro(g, e) <= FP32_RTOL, _fro(g, e)
