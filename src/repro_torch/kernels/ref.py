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
