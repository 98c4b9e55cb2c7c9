"""Plain reference of the decoder the port serves (``repro_torch``'s
``models/transformer.py`` and ``models/layers.py``), written from the
layer equations and importing nothing of the port.

It computes in fp32 with TF32 off, one sequence at a time and its
attention one block of queries at a time, so that it fits beside the
weights on the card.  The equations are the port's: embedding rows times
sqrt(d_model); pre-norm layers (LayerNorm with bias, or RMSNorm; eps
``norm_eps``); RoPE on the two halves of each head; grouped-query
attention, causal and, with a window, ``q_pos - k_pos < window``; a GELU
(tanh) MLP, a gated SwiGLU / GeGLU MLP, or top-k experts with the port's
GShard capacity per row; a final norm and the unembedding.

``precision="fp8"`` is the control: every matrix product takes its two
operands rounded to float8 e4m3 (each tensor scaled by its largest
magnitude), the rest in fp32.  ``precision="bf16"`` is a witness of what
bf16 rounding alone does: every matrix product takes its operands rounded
to bf16 and rounds its result to bf16, the rest in fp32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

Q_BLOCK = 512                  # queries a block in the attention
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_exact():
    """Matrix products in full fp32: TF32 off for the block, restored on
    the way out."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor, back in
    fp32."""
    scale = E4M3_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, back in fp32."""
    return x.to(torch.bfloat16).float()


ROUNDING = {"fp32": None, "bf16": to_bf16, "fp8": to_fp8}


@dataclasses.dataclass
class Row:
    """What the reference computed for one sequence: ``logits [m, V]`` of
    the compared positions ``cmp`` (indices into the new tokens) and each
    layer's K and V of the new tokens (``kv[l] = (k, v)``, each
    ``[n, Hkv, Dh]``; kept when every position is compared)."""
    cmp: list
    logits: torch.Tensor
    kv: list


class Decoder:
    """The reference decoder over ``params`` (the port's parameter layout:
    ``embed``, ``layers`` [per-layer dicts], ``final_norm``, ``unembed``),
    sizes in ``cfg`` (the configuration file's ``model`` section)."""

    def __init__(self, cfg: dict, params: dict, precision: str = "fp32"):
        if precision not in ROUNDING:
            raise ValueError(f"precision {precision!r}: one of {list(ROUNDING)}")
        self.cfg, self.params = cfg, params
        self.rnd, self.bf16 = ROUNDING[precision], precision == "bf16"
        self.eps = cfg.get("norm_eps", 1e-6)

    # -- pieces -------------------------------------------------------------
    def r(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product in the reference's precision."""
        return x if self.rnd is None else self.rnd(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = self.r(a.float()) @ self.r(b.float())
        return to_bf16(out) if self.bf16 else out

    def norm(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        if self.cfg["norm"] == "layernorm":
            mu = x.mean(-1, keepdim=True)
            var = (x - mu).square().mean(-1, keepdim=True)
            return (x - mu) * torch.rsqrt(var + self.eps) * p["scale"] + p["bias"]
        ms = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(ms + self.eps) * p["scale"]

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x ``[n, H, Dh]`` at positions ``pos [n]``."""
        half = x.shape[-1] // 2
        exps = -torch.arange(half, dtype=torch.float64) / half
        freqs = (float(self.cfg["rope_theta"]) ** exps).float().to(x.device)
        ang = pos.float()[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def qkv(self, p: dict, z: torch.Tensor, pos: torch.Tensor) -> tuple:
        c = self.cfg
        n, dh = z.shape[0], c["head_dim"]
        q = self.mm(z, p["wq"]).reshape(n, c["n_heads"], dh)
        k = self.mm(z, p["wk"]).reshape(n, c["n_kv"], dh)
        v = self.mm(z, p["wv"]).reshape(n, c["n_kv"], dh)
        if c.get("qk_norm"):
            q, k = self.norm(p["q_norm"], q), self.norm(p["k_norm"], k)
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q, qpos, k, v, kpos) -> torch.Tensor:
        """Softmax attention of ``q [n, Hq, Dh]`` at ``qpos`` over keys ``k,
        v [T, Hkv, Dh]`` at ``kpos`` (causal, and the window).  ->
        ``[n, Hq · Dh]``."""
        c = self.cfg
        n, hq, dh = q.shape
        hkv, win = c["n_kv"], c.get("window")
        g, scale = hq // hkv, dh ** -0.5
        k, v = self.r(k), self.r(v)
        outs = []
        for lo in range(0, n, Q_BLOCK):
            qb = self.r(q[lo:lo + Q_BLOCK].reshape(-1, hkv, g, dh))
            qp = qpos[lo:lo + Q_BLOCK, None]
            s = torch.einsum("qkgd,tkd->qkgt", qb, k) * scale
            ok = kpos[None, :] <= qp
            if win is not None:
                ok &= (qp - kpos[None, :]) < win
            s = torch.where(ok[:, None, None, :], s, float("-inf"))
            w = self.r(torch.softmax(s, -1))
            outs.append(torch.einsum("qkgt,tkd->qkgd", w, v).reshape(-1, hq * dh))
        return torch.cat(outs)

    def mlp(self, p: dict, z: torch.Tensor) -> torch.Tensor:
        kind = self.cfg["mlp"]
        if kind in ("swiglu", "geglu"):
            act = F.silu if kind == "swiglu" else (
                lambda t: F.gelu(t, approximate="tanh"))
            h = act(self.mm(z, p["w_gate"])) * self.mm(z, p["w_up"])
        else:
            h = F.gelu(self.mm(z, p["w_up"]), approximate="tanh")
        return self.mm(h, p["w_down"])

    def route(self, p: dict, z: torch.Tensor) -> tuple:
        """Each token's experts ``idx [n, k]`` (a stable descending sort of
        the router probabilities) and gates (their top-k probabilities
        renormalised)."""
        k = self.cfg["moe_top_k"]
        probs = torch.softmax(self.mm(z, p["router"]), -1)
        idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
        vals = torch.gather(probs, -1, idx)
        return idx, vals / vals.sum(-1, keepdim=True)

    def capacity(self, s: int) -> int:
        c = self.cfg
        e, k = c["moe_experts"], c["moe_top_k"]
        return max(1, -(-int(c["moe_capacity"] * s * k) // e))

    def experts(self, p: dict, z, idx, gates, keep) -> torch.Tensor:
        """Sum over each token's kept experts of gate · expert(z)."""
        out = torch.zeros_like(z)
        for e in range(self.cfg["moe_experts"]):
            rows, cols = torch.nonzero((idx == e) & keep, as_tuple=True)
            if rows.numel() == 0:
                continue
            w = {n: p[n][e] for n in ("w_gate", "w_up", "w_down") if n in p}
            out.index_add_(0, rows, self.mlp(w, z[rows]) * gates[rows, cols, None])
        return out

    def queue_keep(self, idx: torch.Tensor, cap: int) -> torch.Tensor:
        """GShard's queue over the row's token-major slots: ``keep [n, k]``,
        the queue position under ``cap``."""
        n, k = idx.shape
        flat = F.one_hot(idx.reshape(-1), self.cfg["moe_experts"]).to(torch.int64)
        pos = ((torch.cumsum(flat, 0) - flat) * flat).sum(-1).reshape(n, k)
        return pos < cap

    # -- one sequence -------------------------------------------------------
    @torch.no_grad()
    def forward_row(self, tokens: torch.Tensor, pos0: int = 0, prefix=None,
                    compare: str = "last", per_token_capacity: bool = False) -> Row:
        """Run new tokens ``tokens [n]`` at positions ``pos0 ..`` after a
        cached prefix (``prefix(layer) -> (k [P, Hkv, Dh], v, kpos [P])``,
        or None) and return a ``Row``.  ``compare``: ``"last"`` (a
        prefill's answer) or ``"all"`` (each decode step's logits and the
        K and V it wrote).  ``per_token_capacity``: the experts' capacity
        taken a token at a time, as a decode step routes (one position a
        row), else over the row, as a prefill does."""
        c, P = self.cfg, self.params
        dev, n = tokens.device, tokens.shape[0]
        pos = pos0 + torch.arange(n, device=dev)
        cmp = [n - 1] if compare == "last" else list(range(n))
        x = P["embed"][tokens].float() * math.sqrt(c["d_model"])
        kv_keep = []
        for li, lp in enumerate(P["layers"]):
            a = lp["attn"]
            q, k, v = self.qkv(a, self.norm(lp["attn_norm"], x), pos)
            if prefix is not None:
                pk, pv, ppos = prefix(li)
                keys, vals = torch.cat([pk.float(), k]), torch.cat([pv.float(), v])
                kpos = torch.cat([ppos.to(dev), pos])
            else:
                keys, vals, kpos = k, v, pos
            x = x + self.mm(self.attend(q, pos, keys, vals, kpos), a["wo"])
            if compare == "all":
                kv_keep.append((k, v))
            z = self.norm(lp["mlp_norm"], x)
            if not c.get("moe_experts"):
                x = x + self.mlp(lp["mlp"], z)
                continue
            idx, gates = self.route(lp["moe"], z)
            keep = (torch.ones_like(idx, dtype=torch.bool) if per_token_capacity
                    else self.queue_keep(idx, self.capacity(n)))
            x = x + self.experts(lp["moe"], z, idx, gates, keep)
        w = P["unembed"] if "unembed" in P else P["embed"].T
        logits = self.mm(self.norm(P["final_norm"], x[torch.tensor(cmp, device=dev)]), w)
        return Row(cmp, logits, kv_keep)
