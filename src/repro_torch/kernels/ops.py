"""Public wrappers around the port's kernels (the entries of ``repro``'s
``kernels/ops.py``).

Each wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the hand-written kernel (``peel_wave``, ``bitmap_support``,
``flash_attention``, ``segment_matmul``, ``cin``), which raises if it
cannot run; a CPU tensor takes the plain version in ``ref``.  There is no fallback from one to the other.  ``use_kernels(False)``
is the explicit A/B switch that sends every device to the plain version.

Four entries are differentiable, each a ``torch.autograd.Function`` whose
forward is the kernel (the plain version on a CPU tensor or under
``use_kernels(False)``) and whose backward is plain PyTorch, the same code
on every device: the reference has no backward kernel to port.
``segment_sum`` (K4's rows entry, the GNN family's aggregation; backward
``ref.segment_sum_vjp_ref``), ``flash_attention_heads`` (K3; backward
``ref.attention_vjp_ref``), ``segment_matmul_gathered`` (K4's gathered
entry, the embedding bag; backward ``ref.segment_gathered_vjp_ref``) and
``cin_layer`` (K5; backward ``ref.cin_layer_vjp_ref``).  Under
``torch.no_grad`` each launches exactly what its forward launches.

A ``meta`` tensor takes the meta route: the kernel's operator in the
``repro_torch`` namespace (``torch.ops.repro_torch.peel_wave``,
``bitmap_support``, ``flash_attention``, ``segment_sum``, ``cin_layer``),
which has a fake implementation only, so it returns outputs of the kernel's
shapes and dtypes, computes nothing and reads no value.  That is how the
dry-run (``launch/dryrun.py``) traces a step on shapes alone.  K3's and
K5's operators carry flop formulas for ``torch.utils.flop_counter``: K3
counts the (query, key) pairs inside its causal or window band, K5 its
GEMM.  The Functions' backwards run their plain code on meta tensors too.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import ref
from .bitmap_support import bitmap_support_cuda
from .cin import cin_layer_cuda
from .flash_attention import flash_attention_cuda
from .peel_wave import peel_wave_cuda
from .segment_matmul import segment_sum_cuda

_USE_KERNELS = True


def use_kernels(flag: bool) -> None:
    """Route CUDA tensors to the kernels (True, the default) or to the plain
    versions (False) — for A/B timing of the same call."""
    global _USE_KERNELS
    _USE_KERNELS = bool(flag)


def _device(*tensors: torch.Tensor) -> torch.device:
    """The one device of ``tensors``; raises unless it is a CUDA device,
    the CPU or ``meta``."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel or plain path for device {dev}")
    return dev


def _is_meta(*tensors: torch.Tensor) -> bool:
    """True when the call takes the meta route (shapes only)."""
    return _device(*tensors).type == "meta"


def _on_card(*tensors: torch.Tensor) -> bool:
    """True when the call launches a kernel: every tensor on one CUDA device
    and kernels enabled.  CPU tensors take the plain version (meta tensors
    took the meta route before this is asked); any other device raises."""
    return _device(*tensors).type == "cuda" and _USE_KERNELS


# ---------------------------------------------------------------------------
# the meta route: one operator a kernel, a fake implementation only (any
# other device has no implementation and raises)
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("peel_wave(Tensor alive) -> (Tensor, Tensor)")
_LIB.define("bitmap_support(Tensor rows) -> Tensor")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int? window) -> Tensor")
_LIB.define("segment_sum(Tensor rows, Tensor seg_ids, int num_segments) "
            "-> Tensor")
_LIB.define("cin_layer(Tensor xk, Tensor x0, Tensor w) -> Tensor")
_META = torch.ops.repro_torch


@torch.library.register_fake("repro_torch::peel_wave")
def _peel_wave_fake(alive):
    e = (alive.shape[0],)
    return (alive.new_empty(e, dtype=torch.int32),
            alive.new_empty(e, dtype=torch.bool))


@torch.library.register_fake("repro_torch::bitmap_support")
def _bitmap_support_fake(rows):
    return rows.new_empty((rows.shape[0],), dtype=torch.int32)


@torch.library.register_fake("repro_torch::flash_attention")
def _flash_attention_fake(q, k, v, causal, window):
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::segment_sum")
def _segment_sum_fake(rows, seg_ids, num_segments):
    return rows.new_empty((num_segments,) + tuple(rows.shape[1:]))


@torch.library.register_fake("repro_torch::cin_layer")
def _cin_layer_fake(xk, x0, w):
    return xk.new_empty((xk.shape[0], w.shape[0], xk.shape[2]))


def attention_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """The (query, key) pairs of one head that K3's band keeps: query ``i``
    (at position ``i + skv - sq``) sees keys ``<= i + skv - sq`` when
    causal and within ``window`` of it."""
    q = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(q + 1, skv) if causal else np.full(sq, skv, np.int64)
    lo = (np.zeros(sq, np.int64) if window is None
          else np.maximum(q - window + 1, 0))
    return int(np.maximum(hi - lo, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window,
                           out_shape=None, **kwargs) -> int:
    """``Q Kᵀ`` and ``P V`` over the pairs inside the band: 4 · B · Hq ·
    pairs · Dh (q ``[B, Sq, Hq, Dh]``, k ``[B, Skv, Hkv, Dh]``)."""
    b, sq, hq, dh = q_shape
    return 4 * b * hq * dh * attention_pairs(sq, k_shape[1], causal, window)


@register_flop_formula(torch.ops.repro_torch.cin_layer)
def _cin_layer_flops(xk_shape, x0_shape, w_shape, out_shape=None,
                     **kwargs) -> int:
    """K5's GEMM: ``[O, H·M] x [H·M, B·D]``, 2 · B · O · H · M · D."""
    b, h, d = xk_shape
    o, _, m = w_shape
    return 2 * b * o * h * m * d


def _slab(row_offset, row_count, *arrays):
    """Row-block slab selection shared by every bitmap-row entry point:
    rows ``[row_offset, row_offset + row_count)``, the start clamped into
    range as ``lax.dynamic_slice_in_dim`` clamps it.  Views, no copies."""
    if row_count is None:
        return arrays
    start = min(max(int(row_offset), 0), arrays[0].shape[0] - row_count)
    return tuple(a[start:start + row_count] for a in arrays)


def _word_start(word_offset, word_count, width: int) -> int:
    """Clamped start of a word slab (the word-axis twin of ``_slab``)."""
    return min(max(int(word_offset), 0), width - word_count)


def bitmap_support(rows_a, rows_b, row_offset=0, row_count=None,
                   word_offset=0, word_count=None):
    """``sup[i] = popcount(rows_a[i] & rows_b[i]).sum()`` for int32 rows
    ``[E, W]`` (K2's rows entry), over a row block and/or a word slab."""
    rows_a, rows_b = _slab(row_offset, row_count, rows_a, rows_b)
    wo = 0 if word_count is None else _word_start(word_offset, word_count,
                                                  rows_a.shape[1])
    if _is_meta(rows_a, rows_b):
        return _META.bitmap_support(rows_a)
    if _on_card(rows_a, rows_b):
        return bitmap_support_cuda(rows_a, rows_b, word_offset=wo,
                                   word_count=word_count)
    if word_count is not None:
        rows_a = rows_a[:, wo:wo + word_count]
        rows_b = rows_b[:, wo:wo + word_count]
    return ref.bitmap_support_ref(rows_a, rows_b)


def bitmap_support_gathered(bitmap, eu, ev, chunk=None, word_offset=0,
                            word_count=None):
    """Support counts straight from an int32 ``[N, W]`` bitmap and endpoint
    ids (K2's gathered entry, the digest body on the card): no ``[E, W]``
    row gather exists there.
    ``chunk`` bounds the plain version's gather transient to ``[chunk, W]``;
    the kernel needs no chunking.  A word slab gives a partial sum."""
    wo = 0 if word_count is None else _word_start(word_offset, word_count,
                                                  bitmap.shape[1])
    if _is_meta(bitmap, eu, ev):
        return _META.bitmap_support(eu)
    if _on_card(bitmap, eu, ev):
        return bitmap_support_cuda(bitmap, bitmap, eu, ev, word_offset=wo,
                                   word_count=word_count)
    if word_count is not None:
        bitmap = bitmap[:, wo:wo + word_count]
    return ref.bitmap_support_gathered_ref(bitmap, eu, ev, chunk)


def peel_wave(rows_a, rows_b, alive, k, row_offset=0, row_count=None):
    """Fused (support, kill-frontier) of the level-``k`` wave over int32
    rows ``[E, W]`` (K1's rows entry).  Returns ``(sup int32, kill bool)``."""
    rows_a, rows_b, alive = _slab(row_offset, row_count, rows_a, rows_b, alive)
    if _is_meta(rows_a, rows_b, alive):
        return _META.peel_wave(alive)
    if _on_card(rows_a, rows_b, alive):
        return peel_wave_cuda(rows_a, rows_b, alive, k)
    return ref.peel_wave_ref(rows_a, rows_b, alive, k)


def peel_wave_gathered(bitmap, eu, ev, alive, k, chunk=None):
    """K1's gathered entry — the one the bitmap peel engine calls each wave:
    ``peel_wave(bitmap[eu], bitmap[ev], alive, k)`` without building the
    row gathers on the card (the digest body there).  ``chunk`` bounds the
    plain version's gather."""
    if _is_meta(bitmap, eu, ev, alive):
        return _META.peel_wave(alive)
    if _on_card(bitmap, eu, ev, alive):
        return peel_wave_cuda(bitmap, bitmap, alive, k, eu, ev)
    return ref.peel_wave_gathered_ref(bitmap, eu, ev, alive, k, chunk)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """K3 in the reference's layout: q, k, v ``[BH, S, Dh]`` (``Sq == Skv``
    on the card) -> ``[BH, S, Dh]`` in ``q.dtype``."""
    if _is_meta(q, k, v):
        return _META.flash_attention(q.unsqueeze(2), k.unsqueeze(2),
                                     v.unsqueeze(2), causal,
                                     window).squeeze(2)
    if _on_card(q, k, v):
        return flash_attention_cuda(q.unsqueeze(2), k.unsqueeze(2),
                                    v.unsqueeze(2), causal=causal,
                                    window=window).squeeze(2)
    return ref.attention_ref(q, k, v, causal=causal, window=window)


class FlashAttention(torch.autograd.Function):
    """Attention in the model's layout with a gradient.  Forward: K3 (body
    by ``body_for``) when ``kernel`` is set and the tensors are on the card
    with kernels enabled (K3's meta route when they are on ``meta``), else
    ``ref.chunked_attention_ref``.  It saves q,
    k and v; the backward is ``ref.attention_vjp_ref``, which recomputes
    the scores a query block at a time and launches no kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kernel):
        if kernel and _is_meta(q, k, v):
            o = _META.flash_attention(q, k, v, causal, window)
        elif kernel and _on_card(q, k, v):
            o = flash_attention_cuda(q, k, v, causal=causal, window=window)
        else:
            o = ref.chunked_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window).transpose(1, 2)
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window = ctx.mask
        grads = ref.attention_vjp_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            do.transpose(1, 2), causal=causal, window=window)
        return tuple(g.transpose(1, 2) for g in grads) + (None, None, None)


def flash_attention_heads(q, k, v, *, causal: bool = True,
                          window: int | None = None, kernel: bool = True):
    """K3 in the model's layout — the entry the prefill and training paths
    call: q ``[B, S, Hq, Dh]``, k/v ``[B, S, Hkv, Dh]`` (GQA, KV heads read
    in place on the card) -> ``[B, S, Hq, Dh]`` in ``q.dtype``,
    differentiable (``FlashAttention``).  ``kernel=False`` takes the
    chunked plain version on every device (the model's route below 512
    positions)."""
    return FlashAttention.apply(q, k, v, causal, window, kernel)


def segment_matmul(messages, seg_ids, num_segments: int):
    """K4's rows entry, the reference's signature: ``out[s] = Σ messages[i]
    over seg_ids[i] == s`` -> ``[N, D]`` in ``messages.dtype``; int32 ids,
    those outside ``[0, N)`` dropped; summed in index order in fp32."""
    if _is_meta(messages, seg_ids):
        return _META.segment_sum(messages, seg_ids, num_segments)
    if _on_card(messages, seg_ids):
        return segment_sum_cuda(messages, seg_ids, num_segments)
    return ref.segment_matmul_ref(messages, seg_ids, num_segments)


class SegmentSum(torch.autograd.Function):
    """``segment_matmul`` with a gradient: forward K4's rows entry (the
    plain version on a CPU tensor or under ``use_kernels(False)``),
    backward ``grad_messages[i] = grad_out[seg_ids[i]]``, zero for ids
    outside ``[0, N)``.  The ids get no gradient."""

    @staticmethod
    def forward(ctx, messages, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        return segment_matmul(messages.contiguous(), seg_ids, num_segments)

    @staticmethod
    def backward(ctx, grad_out):
        (seg_ids,) = ctx.saved_tensors
        return ref.segment_sum_vjp_ref(grad_out, seg_ids), None, None


def segment_sum(messages, seg_ids, num_segments: int):
    """Differentiable segment sum over messages ``[E, D]`` (fp32 or fp16)
    and int32 ids ``[E]`` -> ``[N, D]`` in ``messages.dtype``: the
    reference's ``jax.ops.segment_sum`` for 2-D data.  On a CUDA tensor it
    launches K4 or raises; it never gives way to ``index_add_``."""
    return SegmentSum.apply(messages, seg_ids, int(num_segments))


def _segment_matmul_gathered(table, indices, seg_ids, num_segments: int,
                             ids_sorted: bool, mean: bool):
    if _is_meta(table, indices, seg_ids):
        return _META.segment_sum(table, seg_ids, num_segments)
    if _on_card(table, indices, seg_ids):
        return segment_sum_cuda(table, seg_ids, num_segments, indices,
                                ids_sorted=ids_sorted, mean=mean)
    if ids_sorted:
        ref.require_sorted(seg_ids)
    if mean:
        return ref.segment_mean_gathered_ref(table, indices, seg_ids,
                                             num_segments)
    return ref.segment_matmul_gathered_ref(table, indices, seg_ids,
                                           num_segments)


class SegmentSumGathered(torch.autograd.Function):
    """K4's gathered entry with a gradient for the table: backward
    ``ref.segment_gathered_vjp_ref``, a dense table gradient.  The indices
    and ids get none."""

    @staticmethod
    def forward(ctx, table, indices, seg_ids, num_segments, ids_sorted, mean):
        ctx.save_for_backward(indices, seg_ids)
        ctx.table_shape, ctx.mean = table.shape, mean
        return _segment_matmul_gathered(table, indices, seg_ids, num_segments,
                                        ids_sorted, mean)

    @staticmethod
    def backward(ctx, grad_out):
        indices, seg_ids = ctx.saved_tensors
        grad = ref.segment_gathered_vjp_ref(grad_out, ctx.table_shape,
                                            indices, seg_ids, ctx.mean)
        return grad, None, None, None, None, None


def segment_matmul_gathered(table, indices, seg_ids, num_segments: int, *,
                            ids_sorted: bool = False, mean: bool = False):
    """K4's gathered entry — the one ``embedding_bag`` calls:
    ``segment_matmul(table[indices], seg_ids, N)`` with the rows read in
    place on the card (``jnp.take`` semantics for the indices).
    ``ids_sorted`` declares the ids ascending, so nothing sorts them (a
    false declaration raises on the CPU and gives all NaN on the card);
    ``mean`` divides each sum by ``max(count, 1)`` in the same call.
    Differentiable in ``table`` (``SegmentSumGathered``)."""
    return SegmentSumGathered.apply(table, indices, seg_ids,
                                    int(num_segments), ids_sorted, mean)


class CinLayer(torch.autograd.Function):
    """K5 with a gradient: it saves its inputs and output, and its backward
    is ``ref.cin_layer_vjp_ref`` (batch-chunked, relu mask from the
    output)."""

    @staticmethod
    def forward(ctx, xk, x0, w):
        if _is_meta(xk, x0, w):
            out = _META.cin_layer(xk, x0, w)
        elif _on_card(xk, x0, w):
            out = cin_layer_cuda(xk, x0, w)
        else:
            out = ref.cin_layer_ref(xk, x0, w)
        ctx.save_for_backward(xk, x0, w, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return ref.cin_layer_vjp_ref(*ctx.saved_tensors, g)


def cin_layer(xk, x0, w):
    """K5: ``relu(einsum('bhd,bmd,ohm->bod', xk, x0, w))`` in fp32 ->
    ``[B, O, D]`` in ``xk.dtype`` (float32 on the card), differentiable
    (``CinLayer``)."""
    return CinLayer.apply(xk, x0, w)
