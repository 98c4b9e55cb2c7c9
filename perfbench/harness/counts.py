"""Operations and bytes from shapes: the yardstick of the roofline and
model-flops metrics.  ``m`` is a configuration's ``model`` section.

Model flops count what the model needs, not what a program computes:
2 per weight a token uses (its own experts only, not GShard's capacity
slots), attention's 4 · pairs · head_dim per query head over the pairs
inside the causal band and the window, and the unembedding where logits
are made.  Norms and elementwise ops are left out.
"""
from __future__ import annotations


def attn_weights(m: dict) -> int:
    """q, k, v and o projections of one layer."""
    return m["d_model"] * m["head_dim"] * 2 * (m["n_heads"] + m["n_kv"])


def ffn_mats(m: dict) -> int:
    return 3 if m["mlp"] in ("swiglu", "geglu") else 2


def ffn_weights(m: dict, experts: float | None = None) -> float:
    """One layer's MLP, or ``experts`` of its experts and the router
    (all of them where ``experts`` is None)."""
    one = ffn_mats(m) * m["d_model"] * m["d_ff"]
    if not m.get("moe_experts"):
        return one
    e = m["moe_experts"] if experts is None else experts
    return e * one + m["d_model"] * m["moe_experts"]


def norm_weights(m: dict) -> int:
    """Elements of one norm."""
    return m["d_model"] * (2 if m["norm"] == "layernorm" else 1)


def token_flops(m: dict) -> int:
    """Matrix flops of one token through the layers (its top-k experts)."""
    k = m["moe_top_k"] if m.get("moe_experts") else None
    return 2 * m["n_layers"] * (attn_weights(m) + ffn_weights(m, k))


def pairs(s: int, window: int | None) -> int:
    """(query, key) pairs of one head inside the causal band, and the
    window, for ``s`` queries over the same ``s`` positions: query ``q``
    sees ``min(q + 1, window)`` keys."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + window * (s - window)


def attn_flops(m: dict, b: int, n_pairs: int) -> int:
    return 4 * b * m["n_heads"] * m["head_dim"] * n_pairs * m["n_layers"]


def prefill_flops(m: dict, b: int, s: int) -> int:
    """Model flops of a prefill call ``[b, s]`` that returns the last
    position's logits."""
    return (b * s * token_flops(m)
            + attn_flops(m, b, pairs(s, m.get("window")))
            + 2 * b * m["d_model"] * m["vocab"])


def k3_bound_s(m: dict, b: int, s: int, peak: dict) -> float:
    """Least time of K3 over a prefill call's layers: per layer the larger
    of its flops at the bf16 peak and its bytes (bf16 q, k, v read once,
    o written once) at the memory peak."""
    fl = 4 * b * m["n_heads"] * m["head_dim"] * pairs(s, m.get("window"))
    by = 2 * 2 * b * s * m["head_dim"] * (m["n_heads"] + m["n_kv"])
    return m["n_layers"] * max(fl / peak["bf16_flops"],
                               by / peak["hbm_bytes_per_s"])


def distinct_experts(m: dict, tokens: int) -> float:
    """Experts a layer is expected to use for ``tokens`` tokens routed
    uniformly at top-k."""
    e, k = m["moe_experts"], m["moe_top_k"]
    return e * (1.0 - (1.0 - k / e) ** tokens)


def decode_wave_flops(m: dict, b: int, valid: int) -> int:
    """Model flops of one decode wave: ``b`` tokens, each attending to
    ``valid`` cached positions (its own included)."""
    return (b * token_flops(m) + attn_flops(m, b, valid)
            + 2 * b * m["d_model"] * m["vocab"])


def decode_wave_bytes(m: dict, b: int, valid: int) -> float:
    """Bytes one decode wave must move at the least: the bf16 K and V of
    the ``valid`` positions read once and the new slot written, the fp32
    weights read once (of the embedding only ``b`` rows; of the experts
    those the wave is expected to choose), the fp32 logits written."""
    L, kv = m["n_layers"], m["n_kv"] * m["head_dim"]
    cache = 2 * 2 * L * b * (valid + 1) * kv
    e = distinct_experts(m, b) if m.get("moe_experts") else None
    layer = attn_weights(m) + ffn_weights(m, e) + 2 * norm_weights(m)
    weights = (L * layer + norm_weights(m) + b * m["d_model"]
               + (0 if m.get("tie_embeddings") else m["d_model"] * m["vocab"]))
    return cache + 4 * weights + 4 * b * m["vocab"]


def roofline_s(flops: float, n_bytes: float, peak: dict) -> tuple:
    """(least seconds, which bound) of work at the card's peaks."""
    t_ops, t_bytes = flops / peak["bf16_flops"], n_bytes / peak["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def param_bytes(m: dict) -> int:
    """fp32 bytes of every parameter (qk-norm scales included)."""
    layer = attn_weights(m) + ffn_weights(m) + 2 * norm_weights(m)
    if m.get("qk_norm"):
        layer += 2 * m["head_dim"]
    emb = m["vocab"] * m["d_model"] * (1 if m.get("tie_embeddings") else 2)
    return 4 * (m["n_layers"] * layer + norm_weights(m) + emb)


def decode_batch(m: dict, rule: dict, seq: int) -> int:
    """The batch that fits ``rule["share"]`` of ``rule["card_bytes"]``:
    the fp32 parameters, a wave's bf16 weight casts (one layer's weights
    and the unembedding), and per sequence its bf16 cache beside the fp32
    copies of one layer's K and V that the decode attention makes."""
    L = m["n_layers"]
    slots = min(seq, m["window"]) if m.get("window") else seq
    kv = slots * m["n_kv"] * m["head_dim"]
    layer = attn_weights(m) + ffn_weights(m) + 2 * m["d_model"]
    casts = 2 * (layer + m["vocab"] * m["d_model"])
    per_seq = 2 * 2 * L * kv + 2 * 4 * kv
    free = rule["share"] * rule["card_bytes"] - param_bytes(m) - casts
    return min(rule["max_batch"], int(free // per_seq))
