"""The port's dry-run (``repro_torch.launch.dryrun``) and the kernels' meta
route (``kernels/ops.py``), on the CPU.

- Meta route: every kernel entry (K1-K5, the autograd Functions and their
  backwards included), given ``meta`` tensors, returns the shapes and
  dtypes its CPU call returns on the same shapes, and computes nothing; a
  device other than cpu, cuda or meta still raises, as do mixed devices.
- ``run_cell`` on the production single-pod mesh for every cell kind at
  each family's smoke config, and ``qwen3-0.6b/prefill_32k`` at full
  config: ``argument_size_in_bytes`` equals the sum of the shard bytes of
  the plan's arguments, and ``matmul_flops`` equals the hand count below,
  exactly.  The counts are what ``torch.utils.flop_counter`` counts: 2 ·
  m · n · k a matrix product, K3 as 4 · B · Hq · Dh · (pairs inside its
  band), K5 as its GEMM.  A train step counts each layer's forward, its
  recomputation (the remat; non-reentrant ``checkpoint`` stops once the
  last saved tensor is rebuilt, so a dense layer's MLP down projection is
  not recomputed), and the backward's two products per product whose
  input needs a gradient (one where only the weight does), plus the plain
  attention backward's five products a query block.
- ``main``: files, summary and the ``N/N cells traced`` line.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as tl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SINGLE = make_production_mesh(device="meta")


# ---------------------------------------------------------------------------
# the meta route
# ---------------------------------------------------------------------------

def _cpu_inputs():
    g = torch.Generator().manual_seed(0)
    bm = torch.randint(-2**31, 2**31 - 1, (9, 4), generator=g, dtype=torch.int32)
    eu = torch.randint(0, 9, (13,), generator=g, dtype=torch.int32)
    ev = torch.randint(0, 9, (13,), generator=g, dtype=torch.int32)
    alive = torch.rand(13, generator=g) < 0.7
    rows = torch.randint(-2**31, 2**31 - 1, (13, 4), generator=g, dtype=torch.int32)
    q = torch.randn(2, 40, 4, 16, generator=g).to(torch.bfloat16)
    kv = torch.randn(2, 40, 2, 16, generator=g).to(torch.bfloat16)
    msg = torch.randn(20, 5, generator=g)
    ids = torch.sort(torch.randint(0, 6, (20,), generator=g)).values.to(torch.int32)
    idx = torch.randint(0, 30, (20,), generator=g, dtype=torch.int32)
    table = torch.randn(30, 5, generator=g)
    xk = torch.randn(3, 4, 5, generator=g)
    x0 = torch.randn(3, 6, 5, generator=g)
    w = torch.randn(7, 4, 6, generator=g)
    return dict(bm=bm, eu=eu, ev=ev, alive=alive, rows=rows, q=q, k=kv,
                v=kv.clone(), msg=msg, ids=ids, idx=idx, table=table, xk=xk,
                x0=x0, w=w)


ENTRIES = {
    "bitmap_support": lambda t: ops.bitmap_support(t["rows"], t["rows"]),
    "bitmap_support slab": lambda t: ops.bitmap_support(
        t["rows"], t["rows"], row_offset=2, row_count=5, word_offset=1, word_count=2),
    "bitmap_support_gathered": lambda t: ops.bitmap_support_gathered(
        t["bm"], t["eu"], t["ev"]),
    "peel_wave": lambda t: ops.peel_wave(t["rows"], t["rows"], t["alive"], 4),
    "peel_wave slab": lambda t: ops.peel_wave(t["rows"], t["rows"], t["alive"], 4,
                                              row_offset=3, row_count=6),
    "peel_wave_gathered": lambda t: ops.peel_wave_gathered(
        t["bm"], t["eu"], t["ev"], t["alive"], 3),
    "flash_attention": lambda t: ops.flash_attention(
        t["q"][:, :, 0], t["k"][:, :, 0], t["v"][:, :, 0], causal=True, window=8),
    "flash_attention_heads": lambda t: ops.flash_attention_heads(
        t["q"], t["k"], t["v"], causal=True, window=None),
    "segment_matmul": lambda t: ops.segment_matmul(t["msg"], t["ids"], 6),
    "segment_sum": lambda t: ops.segment_sum(t["msg"], t["ids"], 6),
    "segment_matmul_gathered": lambda t: ops.segment_matmul_gathered(
        t["table"], t["idx"], t["ids"], 6),
    "segment_matmul_gathered mean sorted": lambda t: ops.segment_matmul_gathered(
        t["table"], t["idx"], t["ids"], 6, ids_sorted=True, mean=True),
    "cin_layer": lambda t: ops.cin_layer(t["xk"], t["x0"], t["w"]),
}


def _sig(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), o.dtype) for o in outs]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_meta_route_returns_the_cpu_shapes(entry):
    cpu = _cpu_inputs()
    meta = {k: v.to("meta") for k, v in cpu.items()}
    got = ENTRIES[entry](meta)
    assert all(o.device.type == "meta" for o in (got if isinstance(got, tuple) else (got,)))
    assert _sig(got) == _sig(ENTRIES[entry](cpu))


@pytest.mark.parametrize("entry,inputs", [
    ("flash_attention_heads", ("q", "k", "v")),
    ("segment_sum", ("msg",)),
    ("segment_matmul_gathered mean sorted", ("table",)),
    ("cin_layer", ("xk", "x0", "w")),
])
def test_meta_route_backwards_return_the_cpu_shapes(entry, inputs):
    sigs = []
    for dev in ("cpu", "meta"):
        t = {k: v.to(dev) for k, v in _cpu_inputs().items()}
        for name in inputs:
            t[name] = t[name].float().requires_grad_(True) if name in "qkv" \
                else t[name].requires_grad_(True)
        out = ENTRIES[entry](t)
        grads = torch.autograd.grad(out.float().sum(), [t[n] for n in inputs])
        assert all(g.device.type == dev for g in grads)
        sigs.append(_sig(tuple(grads)))
    assert sigs[0] == sigs[1]


def test_other_devices_still_raise():
    xpu = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.segment_matmul(xpu, xpu, 3)
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.bitmap_support(xpu, xpu)
    with pytest.raises(ValueError, match="different devices"):
        ops.cin_layer(torch.zeros(1, 2, 3, device="meta"), torch.zeros(1, 2, 3),
                      torch.zeros(2, 2, 2))
    with pytest.raises(NotImplementedError):     # the operators are meta-only
        torch.ops.repro_torch.cin_layer(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3),
                                        torch.zeros(2, 2, 2))


@pytest.mark.parametrize("s,causal,window", [
    (1, True, None), (37, True, None), (37, True, 5), (37, False, None),
    (37, False, 5), (300, True, 64)])
def test_k3_pairs_count_the_band(s, causal, window):
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    band = np.ones((s, s), bool)
    if causal:
        band &= q >= k
    if window is not None:
        band &= (q - k) < window
    assert ops.attention_pairs(s, s, causal, window) == int(band.sum())


# ---------------------------------------------------------------------------
# run_cell: bytes and hand-counted matmul flops
# ---------------------------------------------------------------------------

def _pairs(s, window):
    return ops.attention_pairs(s, s, True, window)


def _lm_layer(cfg, b, s):
    """One layer's forward matrix products at ``[b, s]`` tokens (attention
    excluded): the projections and the MLP or the MoE's router and
    experts."""
    t, d, dh = b * s, cfg.d_model, cfg.head_dim
    attn = 2 * t * d * dh * (2 * cfg.n_heads + 2 * cfg.n_kv)
    n_mat = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    if cfg.moe_experts:
        cap = tl.moe_capacity(s, cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity)
        mlp = (2 * t * d * cfg.moe_experts
               + n_mat * 2 * b * cfg.moe_experts * cap * d * cfg.d_ff)
    else:
        mlp = n_mat * 2 * t * d * cfg.d_ff
    return attn + mlp


def _k3(cfg, b, s):
    return 4 * b * cfg.n_heads * cfg.head_dim * _pairs(s, cfg.window)


def count_prefill(cfg, b, s):
    """Layers (K3 at s >= 512), then the last position's logits."""
    return (cfg.n_layers * (_lm_layer(cfg, b, s) + _k3(cfg, b, s))
            + 2 * b * cfg.d_model * cfg.vocab)


def count_decode(cfg, b, c):
    """One token a row against a cache of ``c``: the layers, the fp32
    decode attention (scores and values over every slot), the logits."""
    attn = 4 * b * cfg.n_heads * cfg.head_dim * c
    return cfg.n_layers * (_lm_layer(cfg, b, 1) + attn) + 2 * b * cfg.d_model * cfg.vocab


def count_lm_train(cfg, b, s):
    """A dense model's step (s >= 512, no window): each layer forward,
    recomputed without its last product, and backward (two products each);
    K3 forward and recomputed; the plain attention backward's five
    products over each 512-query block's visible keys; the cross-entropy's
    chunks forward, recomputed and backward (two)."""
    t = b * s
    down = 2 * t * cfg.d_ff * cfg.d_model
    vjp = 10 * b * cfg.n_heads * cfg.head_dim * sum(
        512 * hi for hi in range(512, s + 1, 512))
    layer = 4 * _lm_layer(cfg, b, s) - down + 2 * _k3(cfg, b, s) + vjp
    return cfg.n_layers * layer + 4 * 2 * t * cfg.d_model * cfg.vocab


def count_gcn_train(cfg, n, d_in):
    """x @ w a layer; backward the weight's product, and the input's from
    the second layer on (the features need no gradient)."""
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return sum(2 * n * a * c * (2 if i == 0 else 3)
               for i, (a, c) in enumerate(zip(dims, dims[1:])))


def _xdeepfm_products(cfg, b):
    """Forward products of ``recsys.forward`` at batch ``b``, split as
    (dense projections, K5 layers, the rest: CIN output and MLP)."""
    d, m = cfg.embed_dim, cfg.n_sparse + 1
    dense = 2 * b * cfg.n_dense * d + 2 * b * cfg.n_dense
    hs = [m] + list(cfg.cin_layers)
    cin = [2 * b * o * h * m * d for h, o in zip(hs, hs[1:])]
    dims = [m * d] + list(cfg.mlp_dims) + [1]
    rest = 2 * b * sum(cfg.cin_layers) + sum(
        2 * b * a * c for a, c in zip(dims, dims[1:]))
    return dense, cin, rest


def count_xdeepfm_serve(cfg, b):
    dense, cin, rest = _xdeepfm_products(cfg, b)
    return dense + sum(cin) + rest


def count_xdeepfm_train(cfg, b):
    """Forward; backward: the dense projections' weights only, K5's plain
    backward (``dw``, ``T = dz · w`` and two batched products, each over
    ``B · D`` rows), two products for the CIN output and each MLP layer."""
    dense, cin, rest = _xdeepfm_products(cfg, b)
    d, m = cfg.embed_dim, cfg.n_sparse + 1
    hs = [m] + list(cfg.cin_layers)
    vjp = sum(2 * 2 * b * d * o * h * m + 2 * 2 * b * d * h * m
              for h, o in zip(hs, hs[1:]))
    return 2 * dense + sum(cin) + vjp + 3 * rest


def _smoke(arch_id):
    arch = get_config(arch_id)
    return dataclasses.replace(arch, model=arch.smoke)


def _cell(arch, kind):
    return next(c for c in arch.cells() if c.kind == kind)


def _check(rec, arch, cell, want_flops):
    assert rec["ok"], rec.get("traceback")
    plan = specs.build_cell(arch, cell, SINGLE)
    total = 0
    for sh, leaf in specs.sharded_leaves(plan.in_shardings, plan.args):
        total += int(np.prod(sh.shard_shape(leaf.shape))) * leaf.element_size()
    assert rec["argument_size_in_bytes"] == total > 0
    assert rec["matmul_flops"] == want_flops
    assert rec["output_size_in_bytes"] > 0
    assert set(rec["no_counterpart"]) >= {
        "temp_size_in_bytes", "generated_code_size_in_bytes", "bytes_accessed",
        "transcendentals", "collectives", "*_exact"}


@pytest.mark.parametrize("arch_id,kind", [
    ("qwen3-0.6b", "train"), ("qwen3-0.6b", "prefill"), ("qwen3-0.6b", "decode"),
    ("mixtral-8x7b", "prefill"), ("mixtral-8x7b", "long_decode")])
def test_run_cell_lm_smoke(arch_id, kind):
    arch = _smoke(arch_id)
    cfg, cell = arch.model, _cell(arch, kind)
    b, s = cell.params["batch"], cell.params["seq"]
    want = {"train": lambda: count_lm_train(cfg, b, s),
            "prefill": lambda: count_prefill(cfg, b, s),
            "decode": lambda: count_decode(cfg, b, min(s, cfg.window or s)),
            "long_decode": lambda: count_decode(cfg, b, cfg.window)}[kind]()
    rec = dryrun.run_cell(arch, cell.name, SINGLE, "single")
    _check(rec, arch, cell, want)
    # mixtral-smoke's 4 experts do not divide the 16-way model axis
    assert rec["mesh_program"] == (arch_id == "mixtral-8x7b")


def test_run_cell_qwen3_prefill_32k_full_config():
    arch = get_config("qwen3-0.6b")
    cell = _cell(arch, "prefill")
    rec = dryrun.run_cell("qwen3-0.6b", cell.name, SINGLE, "single")
    _check(rec, arch, cell, count_prefill(arch.model, 32, 32768))
    assert rec["outputs"] == [[32, arch.model.vocab], "float32"]
    # the logits [32, V] fp32 sharded (data, model)
    assert rec["output_size_in_bytes"] == 32 * arch.model.vocab * 4 // 256


@pytest.mark.parametrize("kind", ["full_graph", "minibatch", "batched_graphs"])
def test_run_cell_gcn_smoke(kind):
    arch = _smoke("gcn-cora")
    cell = _cell(arch, kind)
    batch, _, d_in = specs._gnn_batch_structs(arch, cell)
    n = batch["node_feat"].shape[0]
    rec = dryrun.run_cell(arch, cell.name, SINGLE, "single")
    _check(rec, arch, cell, count_gcn_train(arch.model, n, d_in))
    assert rec["outputs"][2] == {"grad_norm": [[], "float32"],
                                 "lr": [[], "float32"], "loss": [[], "float32"]}


@pytest.mark.parametrize("kind", ["train_batch", "serve", "retrieval"])
def test_run_cell_xdeepfm_smoke(kind):
    arch = _smoke("xdeepfm")
    cfg, cell = arch.model, _cell(arch, kind)
    b = cell.params["batch"]
    want = {"train_batch": lambda: count_xdeepfm_train(cfg, b),
            "serve": lambda: count_xdeepfm_serve(cfg, b),
            # one query's field embeddings (the dense projection); the
            # candidates' dot is a matrix-vector product, which
            # flop_counter does not count
            "retrieval": lambda: 2 * b * cfg.n_dense * cfg.embed_dim}[kind]()
    rec = dryrun.run_cell(arch, cell.name, SINGLE, "single")
    _check(rec, arch, cell, want)


def test_main_writes_records_and_summary(tmp_path, capsys):
    dryrun.main(["--arch", "gcn-cora", "--mesh", "both", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "8/8 cells traced" in out and out.count("[OK]") == 8
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert len(summary) == 8 and all(r["ok"] for r in summary)
    rec = json.loads((tmp_path / "gcn-cora__full_graph_sm__multi.json").read_text())
    assert rec["trace_s"] == 0.0          # the single mesh's trace reused
    assert rec["matmul_flops"] == summary[0]["matmul_flops"]
