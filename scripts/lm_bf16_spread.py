"""How far two bf16 implementations of starcoder2-smoke's loss may sit apart.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_bf16_spread.py

Prints, on the CPU, the numbers behind ``UNTIED_LOSS_RTOL`` in
``tests/test_torch_lm_training.py``: the port's bf16 loss against the
reference's (``repro``) at seq 128 and 512 on the test's parameters and
tokens; each package's own bf16 loss against its fp32 loss (both packages'
``COMPUTE_DTYPE`` set to float32) at seeds 0-2; the share of bf16 GELU
outputs in which ``jax.nn.gelu`` (eight ops, each rounded to bf16, its
constants rounded first) and torch's fused GELU (rounded once) differ; and
the port-reference loss gap again with the port's GELU rounding as jax's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import repro.models.layers as jlayers
import repro.models.transformer as jt
import repro_torch.models.layers as tlayers
import repro_torch.models.transformer as tt
from repro.configs import get_config

CFG = get_config("starcoder2-7b").smoke


def losses(seq: int, seed: int = 0) -> tuple:
    """(reference, port) loss on the same carried parameters and tokens."""
    jp = jt.init_params(CFG, jax.random.PRNGKey(seed))
    tp = tt.params_from_numpy(CFG, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(seed + 1).integers(
        0, CFG.vocab, (2, seq + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    c = min(512, seq)
    jl = jt.loss_fn(CFG, jp, {k: jnp.asarray(v) for k, v in b.items()},
                    xent_chunk=c)
    with torch.no_grad():
        tl = tt.loss_fn(CFG, tp, {k: torch.from_numpy(v) for k, v in b.items()},
                        xent_chunk=c)
    return float(jl), float(tl)


def compute(jdtype, tdtype) -> None:
    for mod in (jlayers, jt):
        mod.COMPUTE_DTYPE = jdtype
    for mod in (tlayers, tt):
        mod.COMPUTE_DTYPE = tdtype


def jax_rounded_gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` as jax computes it in ``x.dtype``."""
    c1 = float(torch.tensor(0.044715, dtype=x.dtype))
    c2 = float(torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype))
    return x * (0.5 * (1.0 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


def main() -> None:
    for seq in (128, 512):
        jl, tl = losses(seq)
        print(f"bf16 seq {seq}: port vs reference loss {abs(tl - jl) / jl:.3g}")
    for seed in range(3):
        compute(jnp.bfloat16, torch.bfloat16)
        jb, tb = losses(128, seed)
        compute(jnp.float32, torch.float32)
        jf, tf = losses(128, seed)
        print(f"seed {seed}: bf16 vs fp32 loss, reference {abs(jb - jf) / jf:.3g},"
              f" port {abs(tb - tf) / tf:.3g}; port vs reference "
              f"{abs(tb - jb) / jb:.3g}")
    compute(jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(0).normal(size=1_000_000).astype(np.float32) * 3
    jg = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x, jnp.bfloat16))
                    .astype(jnp.float32))
    tg = F.gelu(torch.from_numpy(x).bfloat16(), approximate="tanh").float()
    eg = jax_rounded_gelu(torch.from_numpy(x).bfloat16()).float()
    print(f"bf16 GELU outputs differing: torch's fused "
          f"{float((tg.numpy() != jg).mean()):.3g}, jax-rounded "
          f"{float((eg.numpy() != jg).mean()):.3g}")
    tlayers._gelu = jax_rounded_gelu
    for seq in (128, 512):
        jl, tl = losses(seq)
        print(f"bf16 seq {seq}, jax-rounded GELU: port vs reference loss "
              f"{abs(tl - jl) / jl:.3g}")


if __name__ == "__main__":
    main()
