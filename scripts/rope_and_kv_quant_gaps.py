"""RoPE's frequency table and the int8 KV cache's error at head dim 128.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/rope_and_kv_quant_gaps.py

Prints, on the CPU, the numbers behind ROADMAP §3's entry on RoPE's table and
its R8:

- for each LM config's (head dim, rope_theta): the entries in which a table
  computed with torch's fp32 ``pow`` differs from the reference's, and the
  max |port - reference| of ``rope`` on unit-normal fp32 input at 64
  positions ending at 4,096, 32,767 and 524,287, with that fp32 table and
  with ``layers.rope_freqs`` (float64, rounded once);
- mixtral-smoke at head dim 128 decoding 80 positions from 524,224 in fp32
  in both packages (as ``tests/test_torch_moe.py`` does): the largest
  logit gap over the largest |logit|, with either table;
- ``attend_quant``'s max abs error against fp32 attention on the
  reference's accuracy case (unit-normal K, V, q, ``[2, 32, 2 kv, D]``,
  four query heads) at head dim 16 (seed 0, the reference's test) and at
  head dim 128 (seeds 0-11).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.layers as jl
import repro.models.transformer as jt
import repro_torch.models.layers as tl
import repro_torch.models.transformer as tt
from repro.configs import get_config as jget
from repro_torch.configs import get_config
from repro_torch.serving import kv_quant

LM_ARCHS = ("qwen3-0.6b", "gemma-2b", "starcoder2-7b", "mixtral-8x7b",
            "llama4-scout-17b-a16e")


def fp32_pow_table(half, theta, device):
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_gap(dh, theta, end, table) -> float:
    orig = tl.rope_freqs
    tl.rope_freqs = table
    try:
        x = np.random.default_rng(dh + end).normal(
            size=(64, 2, dh)).astype(np.float32)
        pos = np.arange(end - 63, end + 1, dtype=np.int32)
        exp = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))
        got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        return float(np.abs(got.numpy() - exp).max())
    finally:
        tl.rope_freqs = orig


def decode_gap(table) -> float:
    orig = tl.rope_freqs
    tl.rope_freqs = table
    for mod in (jl, jt):
        mod.COMPUTE_DTYPE = jnp.float32
    for mod in (tl, tt):
        mod.COMPUTE_DTYPE = torch.float32
    try:
        jcfg = dataclasses.replace(jget("mixtral-8x7b").smoke, head_dim=128)
        cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke, head_dim=128)
        jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tt.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
        start, n = 524_224, cfg.window + 16
        toks = np.random.default_rng(6).integers(0, cfg.vocab, (1, n)).astype(np.int32)
        jc = jt.init_cache(jcfg, 1, 3 * cfg.window, dtype=jnp.float32)
        tc = tt.init_cache(cfg, 1, 3 * cfg.window, dtype=torch.float32,
                           device="cpu")
        step = jax.jit(lambda p, c, t, pos: jt.decode_step(jcfg, p, c, t, pos))
        worst = 0.0
        for i in range(n):
            exp, jc = step(jp, jc, jnp.asarray(toks[:, i]), jnp.int32(start + i))
            got, tc = tt.decode_step(cfg, tp, tc,
                                     torch.from_numpy(toks[:, i]).long(), start + i)
            exp = np.asarray(exp)
            worst = max(worst, float(np.abs(got.numpy() - exp).max()
                                     / np.abs(exp).max()))
        return worst
    finally:
        tl.rope_freqs = orig
        for mod in (jl, jt):
            mod.COMPUTE_DTYPE = jnp.bfloat16
        for mod in (tl, tt):
            mod.COMPUTE_DTYPE = torch.bfloat16


def kv_case(dh: int, seed: int) -> float:
    rng = np.random.default_rng(seed)
    b, c, n_kv, hq = 2, 32, 2, 4
    k, v = (torch.from_numpy(rng.normal(size=(b, c, n_kv, dh)).astype(np.float32))
            for _ in range(2))
    q = torch.from_numpy(rng.normal(size=(b, hq, dh)).astype(np.float32))
    (kq, ks), (vq, vs) = kv_quant.quantize_kv(k), kv_quant.quantize_kv(v)
    got = kv_quant.attend_quant(q, {"kq": kq, "ks": ks, "vq": vq, "vs": vs},
                                torch.ones((c,), dtype=torch.bool), n_kv, dh)
    qg = q.reshape(b, n_kv, hq // n_kv, dh)
    w = torch.softmax(torch.einsum("bkgd,bckd->bkgc", qg, k) * dh ** -0.5, -1)
    exp = torch.einsum("bkgc,bckd->bkgd", w, v).reshape(b, hq, dh)
    return float((got - exp).abs().max())


def main() -> None:
    torch.set_num_threads(1)
    seen = set()
    for arch in LM_ARCHS:
        cfg = get_config(arch).model
        key = (cfg.head_dim, cfg.rope_theta)
        if key in seen:
            continue
        seen.add(key)
        half = cfg.head_dim // 2
        ref = np.asarray(cfg.rope_theta ** (
            -jnp.arange(0, half, dtype=jnp.float32) / half))
        off = np.nonzero(fp32_pow_table(half, cfg.rope_theta, "cpu").numpy()
                         != ref)[0].tolist()
        fixed = np.nonzero(tl.rope_freqs(half, cfg.rope_theta, "cpu").numpy()
                           != ref)[0].tolist()
        gaps = {end: (rope_gap(*key, end, fp32_pow_table),
                      rope_gap(*key, end, tl.rope_freqs))
                for end in (4096, 32767, 524287)}
        print(f"{arch} (head dim {key[0]}, theta {key[1]:g}): fp32 pow table "
              f"off in entries {off} of {half}, rope_freqs off in {fixed}; "
              f"max |rope - reference| (fp32 pow, rope_freqs) by last "
              f"position: " + ", ".join(f"{e}: {a:.3g}, {b:.3g}"
                                        for e, (a, b) in gaps.items()))
    print(f"mixtral-smoke at head dim 128 decoding from 524,224 in fp32: "
          f"largest logit gap / largest |logit| {decode_gap(fp32_pow_table):.3g}"
          f" with the fp32 pow table, {decode_gap(tl.rope_freqs):.3g} with "
          f"rope_freqs")
    print(f"attend_quant against fp32 attention: head dim 16 seed 0 "
          f"{kv_case(16, 0):.4g}; head dim 128 seeds 0-11 "
          f"{[round(kv_case(128, s), 4) for s in range(12)]}")


if __name__ == "__main__":
    main()
