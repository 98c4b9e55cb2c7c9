"""The port's cell plans (``repro_torch.launch.specs``), its production
meshes and sharding annotations (``launch/mesh.py``), and the MoE expert
block's mesh branches (``models/layers.py``), against ``repro`` on the CPU.

- Plans: every leaf of all 36 cells' plans on both production meshes, of
  the same cells on a ``(2, 4)`` test mesh, and of the smoke qwen3 train
  plan there, against the reference's ``build_cell`` in a 512-device
  subprocess: leaf path, shape, dtype, partition spec and shard shape (or
  the shard-shape error), ``donate_argnums`` and the out-shardings' tree,
  all exactly.
- The smoke qwen3 train plan run on a CPU ``(2, 4)`` mesh: its loss within
  0.05 of the reference's (``test_sharded_lm_train_step_runs``' bound)
  and equal to the port's own ``loss_fn`` on the per-layer parameters.
- The expert block's model-sharded branch (mixtral-smoke's 4 experts on a
  model axis of 8) against the reference's ``shard_map`` branch in fp32
  compute (both packages' ``COMPUTE_DTYPE`` patched) within 1e-5 of the
  largest |output|; in bf16 against ``mesh=None`` within ``BRANCH_FRO``
  relative Frobenius error, the bound ``chip_smoke.py`` holds the
  full-width branch to.  The expert-parallel branch (llama4-smoke's 8
  experts on a model axis of 4 or 8) equals ``mesh=None`` bitwise.
- The model-sharded branch with its positions on distinct devices (``cpu:i``,
  as a multi-GPU host cycles them): its row runs and per-device ``d_ff``
  columns by hand, and its result bitwise equal to the one-device placement.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models.transformer as jt
import repro_torch.models.layers as tl
import repro_torch.models.transformer as tt
from repro.configs import get_config as jget
from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core.distributed import ShardMesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.training.optimizer import adamw_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# relative Frobenius error of the model-sharded branch's bf16 output against
# mesh=None.  The branch rounds each d_ff slice's combined partial to bf16
# (2**-9 relative) and sums the model axis's partials in bf16, rounding
# again at every add: over m slices about sqrt(m) * 2**-9 of the output,
# 0.8% at m = 16, against one rounding of the unsplit sum.  Measured here:
# 5.6e-3 at m = 8.
BRANCH_FRO = 2e-2
TRAIN_TINY = ShapeCell("train_tiny", "train", {"batch": 4, "seq": 32})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_py(code: str, devices: int) -> str:
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    return out.stdout


# ---------------------------------------------------------------------------
# meshes and annotations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_production_mesh_shapes(device):
    m1 = tmesh.make_production_mesh(multi_pod=False, device=device)
    assert m1.axis_names == ("data", "model") and len(m1.devices) == 256
    assert m1.shape == {"data": 16, "model": 16}
    m2 = tmesh.make_production_mesh(multi_pod=True, device=device)
    assert m2.axis_names == ("pod", "data", "model") and len(m2.devices) == 512
    assert set(m2.devices) == {torch.device(device)}
    assert tmesh.dp_axes(m1) == ("data",) and tmesh.dp_axes(m2) == ("pod", "data")
    assert tmesh.model_size(m2) == 16
    assert tmesh.replicated(m1).spec == P()
    assert tmesh.named(m2, ("pod", "data"), "model").spec == P(("pod", "data"), "model")


@pytest.mark.parametrize("spec,shape,axes,dsize,want", [
    # layer dim divisible -> sharded there
    (P(None, None, "model"), (32, 1024, 512), ("data",), 16, P("data", None, "model")),
    # layer dim not divisible -> falls to d_model
    (P(None, None, "model"), (28, 1024, 512), ("data",), 16, P(None, "data", "model")),
    # multi-axis dp
    (P(None, "model", None, None), (48, 16, 5120, 8192), ("pod", "data"), 32,
     P(None, "model", ("pod", "data"), None)),
    # nothing divisible -> unchanged
    (P(None), (7,), ("data",), 16, P(None)),
])
def test_fsdp_spec_selection(spec, shape, axes, dsize, want):
    assert tspecs._with_fsdp(spec, shape, axes, dsize) == want


def test_partition_spec_normalises_like_jax():
    assert P(("data",), None) == P("data", None)
    assert P(("pod", "data")) == (("pod", "data"),)
    assert P(None) != P()


def test_shard_shape_divides_and_raises():
    m = tmesh.make_test_mesh((2, 4), device="meta")
    assert tmesh.named(m, "data", "model").shard_shape((4, 8)) == (2, 2)
    assert tmesh.named(m, ("data", "model")).shard_shape((16, 3)) == (2, 3)
    assert tmesh.replicated(m).shard_shape(()) == ()
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.named(m, "data", "model").shard_shape((3, 8))
    with pytest.raises(ValueError, match="more entries"):
        tmesh.named(m, None, None, "model").shard_shape((3,))


@pytest.mark.parametrize("dims", [("dp", None), ("dp", None, "model", None)])
def test_shard_hint_returns_its_input(dims):
    x = torch.arange(16.0).reshape(4, 4)
    assert tl.shard_hint(x, *dims) is x


# ---------------------------------------------------------------------------
# plans against the reference's, leaf for leaf
# ---------------------------------------------------------------------------

_DUMP_REF = r"""
import dataclasses, json, sys
import jax
from jax.tree_util import keystr, tree_flatten_with_path
from repro.configs import REGISTRY, get_config
from repro.configs.base import ShapeCell
from repro.launch.mesh import make_production_mesh, make_test_mesh
from repro.launch.specs import build_cell, build_lm_cell

def spec(s):
    return [list(p) if isinstance(p, tuple) else p for p in s]

def dump(plan):
    args = tree_flatten_with_path(plan.args)[0]
    shards = jax.tree_util.tree_leaves(plan.in_shardings)
    assert len(args) == len(shards)
    leaves = []
    for (path, a), sh in zip(args, shards):
        try:
            shard = list(sh.shard_shape(a.shape))
        except Exception as e:
            shard = "error"
        leaves.append([keystr(path), list(a.shape), str(a.dtype),
                       spec(sh.spec), shard])
    outs = [[keystr(p), spec(sh.spec)]
            for p, sh in tree_flatten_with_path(plan.out_shardings)[0]]
    return {"args": leaves, "out": outs, "donate": list(plan.donate_argnums)}

meshes = {"single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True),
          "test24": make_test_mesh((2, 4), ("data", "model"))}
out = {}
for arch_id, arch in sorted(REGISTRY.items()):
    for cell in arch.cells():
        for name, mesh in meshes.items():
            out[f"{arch_id}/{cell.name}/{name}"] = dump(build_cell(arch, cell, mesh))
arch = get_config("qwen3-0.6b")
smoke = dataclasses.replace(arch, model=arch.smoke)
cell = ShapeCell("train_tiny", "train", {"batch": 4, "seq": 32})
out["qwen3-smoke/train_tiny/test24"] = dump(build_lm_cell(smoke, cell, meshes["test24"]))
json.dump(out, open(sys.argv[1] if len(sys.argv) > 1 else "/dev/stdout", "w"))
"""


def _spec(s):
    return [list(p) if isinstance(p, tuple) else p for p in s]


def _dump(plan) -> dict:
    args = tspecs.tree_paths(plan.args)
    shards = tspecs.tree_paths(plan.in_shardings)
    assert len(args) == len(shards)
    leaves = []
    for (path, a), (_, sh) in zip(args, shards):
        try:
            shard = list(sh.shard_shape(a.shape))
        except ValueError:
            shard = "error"
        leaves.append([path, list(a.shape), str(a.dtype).replace("torch.", ""),
                       _spec(sh.spec), shard])
    outs = [[p, _spec(sh.spec)] for p, sh in tspecs.tree_paths(plan.out_shardings)]
    return {"args": leaves, "out": outs, "donate": list(plan.donate_argnums)}


@pytest.mark.slow
def test_plans_match_reference_leaf_for_leaf(tmp_path):
    path = tmp_path / "ref.json"
    run_py(_DUMP_REF.replace('sys.argv[1] if len(sys.argv) > 1 else "/dev/stdout"',
                             repr(str(path))), devices=512)
    ref = json.loads(path.read_text())
    meshes = {"single": tmesh.make_production_mesh(multi_pod=False, device="meta"),
              "multi": tmesh.make_production_mesh(multi_pod=True, device="meta"),
              "test24": tmesh.make_test_mesh((2, 4), device="meta")}
    got = {}
    for arch_id, arch in sorted(REGISTRY.items()):
        for cell in arch.cells():
            for name, mesh in meshes.items():
                got[f"{arch_id}/{cell.name}/{name}"] = _dump(
                    tspecs.build_cell(arch, cell, mesh))
    arch = get_config("qwen3-0.6b")
    smoke = dataclasses.replace(arch, model=arch.smoke)
    got["qwen3-smoke/train_tiny/test24"] = _dump(
        tspecs.build_lm_cell(smoke, TRAIN_TINY, meshes["test24"]))
    assert sorted(got) == sorted(ref)
    assert len(got) == 36 * 3 + 1
    n_leaves = 0
    for key in ref:
        assert got[key]["donate"] == ref[key]["donate"], key
        assert got[key]["out"] == ref[key]["out"], key
        assert len(got[key]["args"]) == len(ref[key]["args"]), key
        for g, r in zip(got[key]["args"], ref[key]["args"]):
            assert g == r, (key, g, r)
        n_leaves += len(ref[key]["args"])
    assert n_leaves > 9_000


def test_lm_plan_params_are_the_ports_own_init_stacked():
    arch = get_config("mixtral-8x7b")
    smoke = dataclasses.replace(arch, model=arch.smoke)
    plan = tspecs.build_lm_cell(smoke, TRAIN_TINY,
                                tmesh.make_test_mesh((2, 4), device="meta"))
    params = plan.args[0]
    live = tt.stack_layers(tt.init_params(arch.smoke, torch.Generator().manual_seed(0)))
    got = {p: (tuple(t.shape), t.dtype, t.device.type)
           for p, t in tspecs.tree_paths(params)}
    want = {p: (tuple(t.shape), t.dtype, "meta") for p, t in tspecs.tree_paths(live)}
    assert got == want
    assert "['layers']['moe']['w_down']" in got


# ---------------------------------------------------------------------------
# the smoke qwen3 train plan, executed on a CPU mesh
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_sharded_lm_train_step_runs():
    arch = get_config("qwen3-0.6b")
    cfg = arch.smoke
    smoke = dataclasses.replace(arch, model=cfg, shapes=(TRAIN_TINY,))
    mesh = tmesh.make_test_mesh((2, 4), device="cpu")
    plan = tspecs.build_lm_cell(smoke, TRAIN_TINY, mesh)
    jp = jt.init_params(jget(arch.arch_id).smoke, jax.random.PRNGKey(0))
    params = tt.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    stacked = tt.stack_layers(params)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)}
    for (path, a), (_, leaf) in zip(tspecs.tree_paths(plan.args),
                                    tspecs.tree_paths((stacked, adamw_init(stacked), batch))):
        assert (tuple(a.shape), a.dtype) == (tuple(leaf.shape), leaf.dtype), path
    # the plan's step donates: it writes the stacked parameters (whose
    # embedding and final norm are params' own tensors) in place, so the
    # direct loss is taken before it
    with torch.no_grad():
        direct = tt.loss_fn(cfg, params, batch)
    new_p, new_o, stats = plan.fn(stacked, adamw_init(stacked), batch)
    loss = float(stats["loss"])
    ref_loss = float(jt.loss_fn(jget(arch.arch_id).smoke, jp,
                                {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}))
    assert abs(loss - ref_loss) < 0.05, (loss, ref_loss)
    assert loss == float(direct)
    assert new_p is stacked
    assert new_p["layers"]["attn"]["wq"].shape == stacked["layers"]["attn"]["wq"].shape
    assert int(new_o["step"]) == 1


# ---------------------------------------------------------------------------
# the expert block's mesh branches
# ---------------------------------------------------------------------------

_BRANCH_REF = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
import repro.models.layers as jl
from repro.launch.mesh import make_test_mesh
jl.COMPUTE_DTYPE = jnp.float32
d, f, e, k, s = 128, 256, 4, 2, 16
rng = np.random.default_rng(3)
p = {"router": rng.normal(size=(d, e)).astype(np.float32) * 0.5,
     "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) / d ** 0.5,
     "w_up": rng.normal(size=(e, d, f)).astype(np.float32) / d ** 0.5,
     "w_down": rng.normal(size=(e, f, d)).astype(np.float32) / f ** 0.5}
mesh = make_test_mesh((2, 8), ("data", "model"))
out = {"params": {k2: v.tolist() for k2, v in p.items()}}
for b in (2, 3):
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    fn = jax.jit(lambda p, x: jl.moe_apply(p, x, n_experts=e, top_k=k, kind="swiglu"))
    with mesh:
        y, aux = fn({k2: jnp.asarray(v) for k2, v in p.items()}, jnp.asarray(x))
    out[str(b)] = {"x": x.tolist(), "y": np.asarray(y, np.float32).tolist(),
                   "aux": float(aux)}
json.dump(out, open(sys.argv[1] if len(sys.argv) > 1 else "/dev/stdout", "w"))
"""


@pytest.mark.slow
def test_model_sharded_branch_matches_reference_shard_map(tmp_path, monkeypatch):
    path = tmp_path / "branch.json"
    run_py(_BRANCH_REF.replace('sys.argv[1] if len(sys.argv) > 1 else "/dev/stdout"',
                               repr(str(path))), devices=16)
    ref = json.loads(path.read_text())
    monkeypatch.setattr(tl, "COMPUTE_DTYPE", torch.float32)
    p = {k: torch.tensor(v) for k, v in ref["params"].items()}
    mesh = tmesh.make_test_mesh((2, 8), device="cpu")
    for b in ("2", "3"):       # batch split over data, and replicated
        x = torch.tensor(ref[b]["x"])
        y, aux = tl.moe_apply(p, x, n_experts=4, top_k=2, kind="swiglu", mesh=mesh)
        want = np.asarray(ref[b]["y"], np.float32)
        scale = np.abs(want).max()
        assert np.abs(y.numpy() - want).max() <= 1e-5 * scale, b
        assert abs(float(aux) - ref[b]["aux"]) <= 1e-5 * abs(ref[b]["aux"])
        y0, _ = tl.moe_apply(p, x, n_experts=4, top_k=2, kind="swiglu")
        assert np.abs(y.numpy() - y0.numpy()).max() <= 1e-5 * scale, b


def _moe_layer(cfg, b, s, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = tl.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.mlp)
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    return p, x


@pytest.mark.parametrize("shape", [(1, 8), (2, 8), (3, 8), (2, 16)])
def test_model_sharded_branch_bf16_vs_no_mesh(shape):
    cfg = get_config("mixtral-8x7b").smoke            # 4 experts, d_ff 256
    p, x = _moe_layer(cfg, 4, 64)
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, kind=cfg.mlp)
    y0, aux0 = tl.moe_apply(p, x, **kw)
    y, aux = tl.moe_apply(p, x, mesh=tmesh.make_test_mesh(shape, device="cpu"), **kw)
    assert y.dtype == y0.dtype == torch.bfloat16 and y.shape == y0.shape
    err = float((y.float() - y0.float()).norm() / y0.float().norm())
    assert 0 < err <= BRANCH_FRO, err
    assert torch.equal(aux, aux0)


@pytest.mark.parametrize("shape", [(1, 4), (2, 8)])
def test_expert_parallel_branch_is_the_single_call(shape):
    cfg = get_config("llama4-scout-17b-a16e").smoke   # 8 experts
    p, x = _moe_layer(cfg, 2, 32, seed=1)
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, kind=cfg.mlp)
    y0, _ = tl.moe_apply(p, x, **kw)
    y, _ = tl.moe_apply(p, x, mesh=tmesh.make_test_mesh(shape, device="cpu"), **kw)
    assert torch.equal(y, y0)


# A multi-GPU host cycles the positions over its cards (R6), so positions
# sit on different devices: the branch then groups each run of data rows
# on the same devices, and each device's d_ff columns.  ``cpu:i`` are
# distinct devices to that grouping (and to ``psum``) that all compute on
# the CPU, so the CPU runs a host of ``n`` cards' placement.  Cases:
# (mesh shape, visible devices, batch, [(lo, hi, {device: columns})]).
_R0 = {0: [0, 3, 6], 1: [1, 4, 7], 2: [2, 5]}   # 8 columns over 3 devices
_R1 = {2: [0, 3, 6], 0: [1, 4, 7], 1: [2, 5]}   # positions 8..15 of the same
_PLACEMENTS = [
    ((1, 8), 3, 2, [(0, 2, _R0)]),
    ((2, 8), 2, 4, [(0, 4, {0: [0, 2, 4, 6], 1: [1, 3, 5, 7]})]),
    ((2, 8), 3, 4, [(0, 2, _R0), (2, 4, _R1)]),
    ((2, 8), 3, 3, [(0, 3, _R0)]),             # 3 rows do not split over 2
    ((4, 8), 16, 4, [(i, i + 1, {j + 8 * (i % 2): [j] for j in range(8)})
                     for i in range(4)]),
    ((4, 8), 16, 8, [(2 * i, 2 * i + 2, {j + 8 * (i % 2): [j] for j in range(8)})
                     for i in range(4)]),
]


def _cycled_mesh(shape, n_visible):
    return ShardMesh([torch.device("cpu", i % n_visible)
                      for i in range(int(np.prod(shape)))], ("data", "model"), shape)


@pytest.mark.parametrize("shape,n_visible,b,want", _PLACEMENTS)
def test_row_runs_on_distinct_devices(shape, n_visible, b, want):
    runs = tl._row_runs(tl._position_grid(_cycled_mesh(shape, n_visible)), b)
    got = [(lo, hi, {d.index: [j for j, x in enumerate(devs) if x == d]
                     for d in dict.fromkeys(devs)}) for lo, hi, devs in runs]
    assert got == want


@pytest.mark.parametrize("shape,n_visible,b,want", _PLACEMENTS)
def test_model_sharded_branch_split_over_devices(shape, n_visible, b, want,
                                                  monkeypatch):
    """The branch with its positions on distinct devices: each call gets
    its run's batch rows and exactly its device's ``d_ff`` columns of every
    expert weight, and the joined result equals the one-device placement
    (every position on the CPU: one call) bitwise."""
    cfg = get_config("mixtral-8x7b").smoke            # 4 experts, d_ff 256
    p, x = _moe_layer(cfg, b, 32, seed=4)
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, kind=cfg.mlp)
    y1, aux1 = tl.moe_apply(p, x, mesh=tmesh.make_test_mesh(shape, device="cpu"), **kw)
    calls, block = [], tl._expert_block

    def recorded(r, xc, w, **k):
        calls.append((xc, w, k["slices"]))
        return block(r, xc, w, **k)

    monkeypatch.setattr(tl, "_expert_block", recorded)
    y, aux = tl.moe_apply(p, x, mesh=_cycled_mesh(shape, n_visible), **kw)
    assert torch.equal(y, y1) and torch.equal(aux, aux1)
    e, m = cfg.moe_experts, shape[1]
    f = cfg.d_ff // m
    cols = {"w_gate": p["w_gate"].reshape(e, cfg.d_model, m, f),
            "w_up": p["w_up"].reshape(e, cfg.d_model, m, f),
            "w_down": p["w_down"].reshape(e, m, f, cfg.d_model)}
    xc, got = x.to(torch.bfloat16), []
    for xs, w, slices in calls:
        lo = next(i for i in range(b) if torch.equal(xs, xc[i:i + len(xs)]))
        js = [next(j for j in range(m) if torch.equal(
            w["w_up"][:, :, t], cols["w_up"][:, :, j])) for t in range(slices)]
        assert torch.equal(w["w_gate"], cols["w_gate"][:, :, js])
        assert torch.equal(w["w_down"], cols["w_down"][:, js])
        got.append((lo, lo + len(xs), js))
    assert sorted(got) == sorted((lo, hi, c) for lo, hi, by_dev in want
                                 for c in by_dev.values())


def test_model_sharded_branch_differentiable():
    cfg = get_config("mixtral-8x7b").smoke
    p, x = _moe_layer(cfg, 2, 16)
    mesh = tmesh.make_test_mesh((2, 8), device="cpu")
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, kind=cfg.mlp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    y, aux = tl.moe_apply(leaves, x, mesh=mesh, **kw)
    (y.float().square().mean() + aux).backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all()
               for v in leaves.values())


# ---------------------------------------------------------------------------
# decode with the position as a device tensor
# ---------------------------------------------------------------------------

def test_decode_step_takes_a_tensor_position():
    cfg = get_config("mixtral-8x7b").smoke            # window 64: a ring
    params = tt.init_params(cfg, torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab, (3, 70), generator=torch.Generator().manual_seed(3))
    caches = [tt.init_cache(cfg, 3, 70, device="cpu") for _ in range(2)]
    for pos in range(70):
        a, _ = tt.decode_step(cfg, params, caches[0], toks[:, pos], pos)
        b, _ = tt.decode_step(cfg, params, caches[1], toks[:, pos],
                              torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(a, b), pos
    assert torch.equal(caches[0]["k"], caches[1]["k"])
