"""The weights a cell serves, made on the device from the seed, in the
port's parameter layout (``repro_torch.models.transformer``: ``embed``,
``layers`` as per-layer dicts, ``final_norm``, ``unembed``).

One fp32 buffer is drawn from a ``torch.Generator`` on the device in one
call and each leaf is a view of it, scaled in place: matrices by the
port's initialiser scales (``1/sqrt(fan_in)``, the router and the
embedding 0.02) with the query projection times ``init.query_gain``, so
that attention picks among positions as a trained model's does rather than
averaging them; norm scales ``1 + norm_jitter · N(0, 1)`` and LayerNorm
biases ``norm_jitter · N(0, 1)``, so that a norm's scale and bias are
checked.  The reference reads the same tensors.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's ``seed``."""
    seed = int(seed)
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(seed < 0)]
    words += [sum(ord(ch) << (8 * (i % 4)) for i, ch in enumerate(str(t)))
              for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def leaves(m: dict) -> list:
    """``(path, shape, kind)`` of every parameter, in the port's layout;
    ``kind`` is the scale of a matrix, or ``"scale"`` / ``"bias"`` of a
    norm."""
    d, dh, L = m["d_model"], m["head_dim"], m["n_layers"]
    hq, hkv, ff = m["n_heads"], m["n_kv"], m["d_ff"]

    def norm(path):
        out = [(path + ("scale",), (d,), "scale")]
        if m["norm"] == "layernorm":
            out.append((path + ("bias",), (d,), "bias"))
        return out

    gated = m["mlp"] in ("swiglu", "geglu")
    out = [(("embed",), (m["vocab"], d), 0.02)]
    for i in range(L):
        lay = ("layers", i)
        out += norm(lay + ("attn_norm",))
        a = lay + ("attn",)
        out += [(a + ("wq",), (d, hq * dh), "query"),
                (a + ("wk",), (d, hkv * dh), 1 / math.sqrt(d)),
                (a + ("wv",), (d, hkv * dh), 1 / math.sqrt(d)),
                (a + ("wo",), (hq * dh, d), 1 / math.sqrt(hq * dh))]
        if m.get("qk_norm"):
            out += [(a + ("q_norm", "scale"), (dh,), "scale"),
                    (a + ("k_norm", "scale"), (dh,), "scale")]
        out += norm(lay + ("mlp_norm",))
        e = m.get("moe_experts") or 0
        f = lay + (("moe",) if e else ("mlp",))
        lead = (e,) if e else ()
        if e:
            out.append((f + ("router",), (d, e), 0.02))
        if gated:
            out.append((f + ("w_gate",), lead + (d, ff), 1 / math.sqrt(d)))
        out += [(f + ("w_up",), lead + (d, ff), 1 / math.sqrt(d)),
                (f + ("w_down",), lead + (ff, d), 1 / math.sqrt(ff))]
    out += norm(("final_norm",))
    if not m.get("tie_embeddings"):
        out.append((("unembed",), (d, m["vocab"]), 1 / math.sqrt(d)))
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """The cell's weights from ``seed`` on ``device`` (see the module's
    docstring)."""
    m, init = cfg["model"], cfg["init"]
    spec = leaves(m)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    params: dict = {"layers": [{} for _ in range(m["n_layers"])]}
    at = 0
    for path, shape, kind in spec:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "scale":
            t.mul_(init["norm_jitter"]).add_(1.0)
        elif kind == "bias":
            t.mul_(init["norm_jitter"])
        elif kind == "query":
            t.mul_(init["query_gain"] / math.sqrt(m["d_model"]))
        else:
            t.mul_(kind)
        node = params
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(key, {})
        node[path[-1]] = t
    return params


def port_config(cfg: dict):
    """The port's ``LMConfig`` of a configuration file."""
    from repro_torch.configs.base import LMConfig

    fields = {f.name for f in dataclasses.fields(LMConfig)}
    m = cfg["model"]
    return LMConfig(name=cfg["name"], **{k: v for k, v in m.items()
                                         if k in fields and k != "name"})
