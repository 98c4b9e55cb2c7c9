"""Plain PyTorch versions of the kernels (the ground truth they are held to).

Bitmaps are int32 tensors carrying uint32 bits.  Popcount is SWAR on the
words widened to int64 (masks after every shift), so no step depends on
int32 overflow or on an arithmetic right shift.  ``attention_ref``
materialises the ``[BH, Sq, Skv]`` scores in fp32; ``chunked_attention_ref``
(the model's layout) keeps them to one ``[q_chunk, kv_chunk]`` block.
``segment_matmul_ref`` is ``jax.ops.segment_sum`` (ids outside ``[0, n)``
dropped), ``segment_sum_vjp_ref`` its gradient; ``take_rows_ref`` is
``jnp.take`` along rows (negative ids wrap, ids outside ``[-R, R)`` give
NaN rows); ``cin_layer_ref`` is one xDeepFM CIN layer.

The three ``*_vjp_ref`` functions are the backwards of K3, K4's gathered
entry and K5: the same plain code on every device, since the reference
has no backward kernel (``jax.grad`` there differentiates its plain
paths).  Each bounds its memory: ``attention_vjp_ref`` recomputes the
scores one query block at a time, ``cin_layer_vjp_ref`` runs over batch
chunks, ``segment_gathered_vjp_ref`` is one row gather and one scatter.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words holding uint32 bits -> int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def bitmap_support_ref(rows_a: torch.Tensor, rows_b: torch.Tensor) -> torch.Tensor:
    """sup[i] = sum_w popcount(rows_a[i, w] & rows_b[i, w]) as int32 [E]."""
    return popcount32(rows_a & rows_b).sum(1).to(torch.int32)


def _wave(sup: torch.Tensor, alive: torch.Tensor, k):
    alive = alive.to(torch.bool)
    sup = torch.where(alive, sup, 0)
    k = torch.as_tensor(k, dtype=torch.int32, device=sup.device)
    return sup, alive & (sup < k - 2)


def peel_wave_ref(rows_a: torch.Tensor, rows_b: torch.Tensor,
                  alive: torch.Tensor, k):
    """(support, kill-frontier) of the level-k peel wave: support masked to
    0 outside ``alive``, ``kill = alive & (sup < k - 2)``."""
    return _wave(bitmap_support_ref(rows_a, rows_b), alive, k)


def bitmap_support_gathered_ref(bitmap: torch.Tensor, eu: torch.Tensor,
                                ev: torch.Tensor,
                                chunk: int | None = None) -> torch.Tensor:
    """``bitmap_support_ref(bitmap[eu], bitmap[ev])`` gathered in
    ``chunk``-row batches, so the transient is ``[chunk, W]``."""
    e = eu.shape[0]
    step = e if chunk is None or chunk >= e else chunk
    out = [bitmap_support_ref(bitmap[eu[i:i + step].long()],
                              bitmap[ev[i:i + step].long()])
           for i in range(0, e, max(step, 1))]
    return torch.cat(out) if out else eu.new_zeros((0,))


def peel_wave_gathered_ref(bitmap: torch.Tensor, eu: torch.Tensor,
                           ev: torch.Tensor, alive: torch.Tensor, k,
                           chunk: int | None = None):
    """``peel_wave_ref(bitmap[eu], bitmap[ev], alive, k)`` gathered in
    ``chunk``-row batches."""
    return _wave(bitmap_support_gathered_ref(bitmap, eu, ev, chunk), alive, k)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None) -> torch.Tensor:
    """[BH, Sq, Dh] x [BH, Skv, Dh] -> [BH, Sq, Dh], fp32 softmax, output in
    ``q.dtype``; a key is masked where ``q_pos < k_pos`` (causal) or
    ``q_pos - k_pos >= window``.  Every key lies below ``Skv``, so padding
    never reaches the normaliser."""
    sq, dh = q.shape[1], q.shape[2]
    skv = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * dh ** -0.5
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def chunked_attention_ref(q, k, v, *, causal: bool, window: int | None,
                          q_chunk: int = 1024,
                          kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention in plain tensor ops: flash math, O(S·chunk)
    memory.  q: [B, Hq, Sq, Dh]; k/v: [B, Hkv, Skv, Dh] with Hq % Hkv == 0.
    The reference's off-TPU path (``layers._chunked_attention``), loop for
    scan; the model's CPU prefill and K3's plain version in the model's
    layout, reading KV heads in place."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, dh)
    scale = dh ** -0.5
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    nq = -(-sq // qc)
    nk = -(-skv // kc)
    qg = F.pad(qg, (0, 0, 0, nq * qc - sq))
    kp = F.pad(k, (0, 0, 0, nk * kc - skv))
    vp = F.pad(v, (0, 0, 0, nk * kc - skv))
    q_off = skv - sq  # causal offset: query i attends to kv <= i + q_off
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qg[:, :, :, qi * qc:(qi + 1) * qc].float()         # [B,Hkv,G,qc,Dh]
        m_run = torch.full((b, hkv, group, qc), -1e30, device=dev)
        l_run = torch.zeros((b, hkv, group, qc), device=dev)
        o_run = torch.zeros((b, hkv, group, qc, dh), device=dev)
        qpos = qi * qc + torch.arange(qc, device=dev)[:, None] + q_off
        for kj in range(nk):
            kb = kp[:, :, kj * kc:(kj + 1) * kc].float()
            vb = vp[:, :, kj * kc:(kj + 1) * kc].float()
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
            kpos = kj * kc + torch.arange(kc, device=dev)[None, :]
            mask = kpos < skv
            if causal:
                mask = mask & (qpos >= kpos)
            if window is not None:
                mask = mask & ((qpos - kpos) < window)
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(-1)
            o_run = o_run * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb)
            m_run = m_new
        l_run = torch.where(l_run == 0.0, 1.0, l_run)
        outs.append((o_run / l_run[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=3)[:, :, :, :sq]                   # [B,Hkv,G,Sq,Dh]
    return out.reshape(b, hq, sq, dh)


def attention_vjp_ref(q, k, v, do, *, causal: bool, window: int | None,
                      q_chunk: int = 512):
    """Gradients ``(dq, dk, dv)`` of ``chunked_attention_ref`` at the
    output cotangent ``do``, in the same layout (q/do ``[B, Hq, Sq, Dh]``,
    k/v ``[B, Hkv, Skv, Dh]``), each in its input's dtype.

    The scores are recomputed in fp32 one block of ``q_chunk`` queries at
    a time, over the keys that block can see (causal and window bounds),
    with the forward's masks: ``P = softmax(S)``, ``dV += Pᵀ dO``, ``dP =
    dO Vᵀ``, ``dS = P ∘ (dP − rowsum(P ∘ dP))``, then ``dQ = dS K`` and
    ``dK += dSᵀ Q`` (scaled).  ``rowsum(P ∘ dP)`` equals ``rowsum(dO ∘ O)``
    for the unrounded fp32 O; it is taken from the block itself because the
    forward's O was rounded to ``q.dtype``.  A KV head's ``dK``/``dV`` sum
    over its query group, since GQA reads KV heads in place.  No ``[Sq,
    Skv]`` tensor exists beyond one block's ``[q_chunk, Skv]``."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = dh ** -0.5
    dev = q.device
    qg = q.reshape(b, hkv, group, sq, dh)
    dog = do.reshape(b, hkv, group, sq, dh)
    kf, vf = k.float(), v.float()
    dq = torch.zeros((b, hkv, group, sq, dh), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, hkv, skv, dh), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    q_off = skv - sq  # causal offset: query i attends to kv <= i + q_off
    for lo in range(0, sq, max(1, q_chunk)):
        hi = min(lo + q_chunk, sq)
        k_hi = min(skv, hi + q_off) if causal else skv
        k_lo = 0 if window is None else max(0, lo + q_off - window + 1)
        if k_hi <= k_lo:
            continue                       # every key masked: no gradient
        qb = qg[:, :, :, lo:hi].float()                          # [B,Hkv,G,qc,Dh]
        dob = dog[:, :, :, lo:hi].float()
        kb, vb = kf[:, :, k_lo:k_hi], vf[:, :, k_lo:k_hi]
        qpos = torch.arange(lo, hi, device=dev)[:, None] + q_off
        kpos = torch.arange(k_lo, k_hi, device=dev)[None, :]
        mask = kpos < skv
        if causal:
            mask = mask & (qpos >= kpos)
        if window is not None:
            mask = mask & ((qpos - kpos) < window)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
        s = torch.where(mask, s, -1e30)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        del s
        l = p.sum(-1, keepdim=True)
        p = p / torch.where(l == 0.0, 1.0, l)
        dv[:, :, k_lo:k_hi] += torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vb)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del p, dp
        dq[:, :, :, lo:hi] = torch.einsum("bhgqk,bhkd->bhgqd", ds, kb) * scale
        dk[:, :, k_lo:k_hi] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qb) * scale
    return (dq.reshape(b, hq, sq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def segment_matmul_ref(messages: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """``out[s] = sum of messages[i] where seg_ids[i] == s`` -> ``[N, D]``:
    summed in index order in fp32, ids outside ``[0, num_segments)``
    (negative ones too) dropped, cast to ``messages.dtype`` once."""
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(messages.shape[1:]),
                      dtype=torch.float32, device=messages.device)
    out.index_add_(0, seg_ids[keep].long(), messages[keep].float())
    return out.to(messages.dtype)


def segment_sum_vjp_ref(grad_out: torch.Tensor,
                        seg_ids: torch.Tensor) -> torch.Tensor:
    """The gradient of a segment sum with respect to its messages:
    ``grad[i] = grad_out[seg_ids[i]]``, zero where ``seg_ids[i]`` lies
    outside ``[0, N)`` (those messages were dropped) -> ``[E, D]``.  A row
    gather: the backward on every device, since the reference has no
    backward kernel."""
    n = grad_out.shape[0]
    keep = (seg_ids >= 0) & (seg_ids < n)
    rows = grad_out[torch.where(keep, seg_ids, 0).long()]
    return torch.where(keep[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))


def take_rows_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, indices, axis=0)``: a negative id counts from the
    end; an id outside ``[-R, R)`` gives a row of NaN (float tables)."""
    r = table.shape[0]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + r, idx)
    valid = (idx >= 0) & (idx < r)
    rows = table[torch.where(valid, idx, 0)]
    return torch.where(valid.reshape((-1,) + (1,) * (table.dim() - 1)), rows,
                       float("nan"))


def segment_matmul_gathered_ref(table: torch.Tensor, indices: torch.Tensor,
                                seg_ids: torch.Tensor,
                                num_segments: int) -> torch.Tensor:
    """``segment_matmul_ref(take_rows_ref(table, indices), seg_ids, n)``."""
    return segment_matmul_ref(take_rows_ref(table, indices), seg_ids,
                              num_segments)


def segment_mean_gathered_ref(table: torch.Tensor, indices: torch.Tensor,
                              seg_ids: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """The embedding bag's mean: the plain fp32 sum of the gathered rows
    over the plain count of in-range ids, ``max(count, 1)``, cast once."""
    total = segment_matmul_ref(take_rows_ref(table, indices).float(), seg_ids,
                               num_segments)
    ones = torch.ones((seg_ids.shape[0], 1), dtype=torch.float32,
                      device=seg_ids.device)
    count = segment_matmul_ref(ones, seg_ids, num_segments)
    return (total / torch.clamp(count, min=1.0)).to(table.dtype)


def segment_gathered_vjp_ref(grad_out: torch.Tensor, table_shape,
                             indices: torch.Tensor, seg_ids: torch.Tensor,
                             mean: bool) -> torch.Tensor:
    """The table's gradient through K4's gathered entry (the embedding
    bag): each bag's gradient, divided by ``max(count, 1)`` under ``mean``,
    gathered to the bag's rows and added into a dense zero table of
    ``table_shape`` (``jax.grad`` of ``jnp.take`` is dense).  Ids outside
    ``[0, N)`` and indices outside ``[-R, R)`` give nothing; a negative
    index counts from the end, as ``take_rows_ref`` reads it.  The scatter
    is ``index_put_(accumulate=True)``, autograd's indexing backward: it
    sorts its indices on the card, so two calls there give the same bits
    (on the CPU they do in one thread)."""
    n = grad_out.shape[0]
    keep = (seg_ids >= 0) & (seg_ids < n)
    ids = torch.where(keep, seg_ids, 0).long()
    g = grad_out.float()
    if mean:   # the count of in-range ids a bag, with no data-sized shape
        count = torch.zeros((n,), dtype=torch.float32, device=g.device)
        count.index_add_(0, ids, keep.to(torch.float32))
        g = g / torch.clamp(count, min=1.0)[:, None]
    r = table_shape[0]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + r, idx)
    valid = keep & (idx >= 0) & (idx < r)
    rows = torch.where(valid[:, None], g[ids], 0.0)
    grad = torch.zeros(tuple(table_shape), dtype=torch.float32,
                       device=grad_out.device)
    grad.index_put_((torch.where(valid, idx, 0),), rows, accumulate=True)
    return grad.to(grad_out.dtype)


def require_sorted(seg_ids: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the ids are ascending: what a caller
    declares with ``ids_sorted=True`` (on the card, the kernel writes NaN
    instead)."""
    if bool((seg_ids[1:] < seg_ids[:-1]).any()):
        raise ValueError("seg_ids declared sorted but not in ascending order")


def cin_layer_ref(xk: torch.Tensor, x0: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``relu(einsum('bhd,bmd,ohm->bod'))`` in fp32, output in ``xk.dtype``:
    xk ``[B, H, D]``, x0 ``[B, M, D]``, w ``[O, H, M]`` -> ``[B, O, D]``."""
    z = torch.einsum("bhd,bmd,ohm->bod", xk.float(), x0.float(), w.float())
    return torch.relu(z).to(xk.dtype)


#: the largest ``[rows·D, H·M]`` transient ``cin_layer_vjp_ref`` builds
CIN_VJP_CHUNK_BYTES = 1 << 30


def cin_layer_vjp_ref(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor,
                      out: torch.Tensor, g: torch.Tensor):
    """Gradients ``(dxk, dx0, dw)`` of ``cin_layer_ref`` whose output was
    ``out``, at the cotangent ``g``, each in its input's dtype.

    ``g`` is masked by ``out > 0`` (relu's gradient, 0 at 0 as
    ``jax.nn.relu``'s), then in fp32, a chunk of batch rows at a time:
    ``dw[o, h, m] += Σ_{b,d} dz·xk·x0`` (the outer product of the chunk as
    a ``[rows·D, H·M]`` matrix times ``dz``), ``T = dz · w`` as a ``[rows·D,
    H·M]`` matrix, and from it ``dxk[b, h, d] = Σ_m T·x0`` and ``dx0[b, m,
    d] = Σ_h T·xk``.  A chunk is the rows whose outer product fits
    ``CIN_VJP_CHUNK_BYTES``: at 65,536 rows and H = 200, M = 40, D = 10 the
    whole product would be 21 GB."""
    b, h, d = xk.shape
    m, o = x0.shape[1], w.shape[0]
    chunk = max(1, CIN_VJP_CHUNK_BYTES // (4 * d * h * m))
    dz = torch.where(out > 0, g, 0.0).float()
    wf = w.float().reshape(o, h * m)
    dw = torch.zeros((o, h * m), dtype=torch.float32, device=xk.device)
    dxk = torch.empty((b, h, d), dtype=torch.float32, device=xk.device)
    dx0 = torch.empty((b, m, d), dtype=torch.float32, device=xk.device)
    for lo in range(0, b, chunk):
        hi = min(lo + chunk, b)
        xt = xk[lo:hi].float().transpose(1, 2).reshape(-1, h)   # [rows·D, H]
        x0t = x0[lo:hi].float().transpose(1, 2).reshape(-1, m)  # [rows·D, M]
        dzt = dz[lo:hi].transpose(1, 2).reshape(-1, o)          # [rows·D, O]
        outer = (xt[:, :, None] * x0t[:, None, :]).reshape(-1, h * m)
        dw += dzt.T @ outer
        del outer
        t = (dzt @ wf).reshape(-1, h, m)                         # [rows·D, H, M]
        rows = hi - lo
        dxk[lo:hi] = torch.bmm(t, x0t[:, :, None]).reshape(
            rows, d, h).transpose(1, 2)
        dx0[lo:hi] = torch.bmm(xt[:, None, :], t).reshape(
            rows, d, m).transpose(1, 2)
    return (dxk.to(xk.dtype), dx0.to(x0.dtype),
            dw.reshape(o, h, m).to(w.dtype))
