"""The plain reference against the port's own prefill and decode at small
widths on the CPU, with the port's compute dtype patched to fp32 so that
both compute the same equations at one precision."""
import copy

import pytest
import torch

from perfbench.harness import bench, model, traffic
from perfbench.reference.decoder import Decoder, fp32_exact

SMALL = {
    # the reference's equations at small widths, each against the port: a
    # dense model with LayerNorm and a GELU MLP, GQA with a group of 3;
    # mixtral's experts as configured (none dropped), RMSNorm, SwiGLU; and
    # the experts with a capacity tight enough to drop, under a 64-position
    # window
    "dense-layernorm-gelu": dict(n_layers=2, d_model=96, n_heads=6, n_kv=2,
                                 head_dim=16, d_ff=384, vocab=512, norm="layernorm",
                                 mlp="gelu", moe_experts=0),
    "mixtral-8x7b": dict(n_layers=2, d_model=128, n_heads=4, n_kv=2,
                         head_dim=32, d_ff=256, vocab=512, moe_experts=4,
                         moe_capacity=2.0),
    "moe-drops-window": dict(n_layers=2, d_model=128, n_heads=4, n_kv=2,
                             head_dim=32, d_ff=256, vocab=512, moe_experts=4,
                             window=64, moe_capacity=0.75),
}
TOL = 2e-5      # fp32 on both sides, sums in other orders


def small(name: str) -> dict:
    cfg = copy.deepcopy(bench.load_json(bench.HERE / "configs" / "mixtral-8x7b.json"))
    cfg["model"].update(SMALL[name])
    return cfg


@pytest.fixture
def fp32_port(monkeypatch):
    from repro_torch.models import layers, transformer
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)
    return transformer


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_prefill_matches_port(name, fp32_port):
    cfg = small(name)
    m = cfg["model"]
    params = model.make_params(cfg, 7, "cpu")
    tokens = torch.randint(0, m["vocab"], (3, 160), generator=torch.Generator().manual_seed(1))
    got = fp32_port.prefill(model.port_config(cfg), params, tokens)
    dec = Decoder(m, params)
    with fp32_exact():
        for r in range(tokens.shape[0]):
            row = dec.forward_row(tokens[r], compare="last")
            assert rel(got[r], row.logits[0]) < TOL


@pytest.mark.parametrize("name", sorted(SMALL))
def test_decode_matches_port(name, fp32_port):
    cfg = small(name)
    m = cfg["model"]
    port = model.port_config(cfg)
    params = model.make_params(cfg, 11, "cpu")
    seq, start, b, n = 256, 100, 3, 12
    cache = fp32_port.init_cache(port, b, seq, dtype=torch.float32, device="cpu")
    traffic.fill_cache(cache, 5, start)
    slots = cache["k"].shape[2]
    fed = torch.randint(0, m["vocab"], (n, b), generator=torch.Generator().manual_seed(2))
    logits = []
    for i in range(n):
        out, _ = fp32_port.decode_step(port, params, cache, fed[i], start + i)
        logits.append(out)
    logits = torch.stack(logits)                                # [n, b, V]
    ppos, pslot = traffic.prefix_positions(start, slots)
    dec = Decoder(m, params)
    for s in range(b):
        def prefix(layer, s=s):
            shape = (b, slots, m["n_kv"], m["head_dim"])
            k, v = (traffic.fill_layer(shape, 5, w, layer, start, "cpu")[s, pslot]
                    for w in ("k", "v"))
            return k, v, torch.as_tensor(ppos)
        with fp32_exact():
            row = dec.forward_row(fed[:, s], start, prefix, compare="all",
                                  per_token_capacity=True)
        assert rel(logits[:, s], row.logits) < TOL
        for li in range(m["n_layers"]):
            at = torch.as_tensor((start + torch.arange(n)) % slots)
            assert rel(cache["k"][li, s, at], row.kv[li][0]) < TOL
            assert rel(cache["v"][li, s, at], row.kv[li][1]) < TOL
