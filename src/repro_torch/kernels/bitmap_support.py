"""Hopper kernel K2: edge support as AND + popcount of two bitmap rows.

Replaces ``repro/kernels/bitmap_support.py::bitmap_support_kernel`` (the
Pallas kernel over pre-gathered uint32 rows).  The CUDA source is
``csrc/bitmap_popcount.cu``; its note says what bounds it on an H100
(device-memory bytes) and what each of its two bodies does about it.  The
rows entry (``rows_a``/``rows_b`` ``[E, W]``, as the reference takes them)
runs the direct body, which reads each pair once.  The gathered entry
(rows read straight from the ``[N, W]`` bitmap by endpoint ids) runs the
digest body by default: each needed row's nonzero words compacted once a
call, then each slot probes the other row with the entries of its sparser
endpoint.  ``body="direct"`` asks for the direct body by name, for an A/B.
Either takes an optional word slab for partial sums.  Plain version:
``ref.bitmap_support_ref``.
"""
from __future__ import annotations

import torch

from . import _build

#: launches of this kernel since import (reset by callers that count a run)
LAUNCHES = 0
#: the same launches by body
LAUNCHES_BY_BODY = {"digest": 0, "direct": 0}
#: most digest entries a row keeps: only a row with at most this many
#: nonzero words probes the other row of its pair
DIGEST_CAPACITY = 256

def digest_capacity(word_count: int) -> int:
    """Digest entries kept a row for a slab of ``word_count`` words: a row
    with more nonzero words than this is never the probing side."""
    return min(int(word_count), DIGEST_CAPACITY)


def row_pair_args(a: torch.Tensor, b: torch.Tensor, ia, ib, word_offset: int,
                  word_count: int | None):
    """Validate one AND+popcount launch and return ``(a_ptr, b_ptr, stride,
    ia_ptr, ib_ptr, n_rows, n_words)`` for the C entry.

    ``a``/``b``: int32 ``[R, W]`` on the card, rows contiguous.  With
    ``ia``/``ib`` (int32 ``[E]``) row ``ia[i]`` of ``a`` pairs with row
    ``ib[i]`` of ``b``; without them row ``i`` pairs with row ``i``."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name}: need an int32 [R, W] CUDA tensor, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous")
    if a.shape[1] != b.shape[1] or a.device != b.device:
        raise ValueError(f"row widths/devices differ: {tuple(a.shape)} "
                         f"{a.device} vs {tuple(b.shape)} {b.device}")
    w = a.shape[1]
    wc = w - word_offset if word_count is None else word_count
    if word_offset < 0 or wc < 0 or word_offset + wc > w:
        raise ValueError(f"word slab [{word_offset}, {word_offset + wc}) "
                         f"outside [0, {w})")
    if ia is None:
        if a.shape != b.shape:
            raise ValueError(f"row shapes differ: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        n_rows, ia_ptr, ib_ptr = a.shape[0], None, None
    else:
        for name, t in (("eu", ia), ("ev", ib)):
            if (t.device != a.device or t.dtype != torch.int32
                    or t.dim() != 1 or not t.is_contiguous()):
                raise ValueError(f"{name}: need a contiguous int32 [E] tensor "
                                 f"on {a.device}")
        if ia.shape != ib.shape:
            raise ValueError("eu and ev differ in length")
        if ia.numel():
            # one reduction and one host sync for both id ranges
            lo, hi = torch.aminmax(torch.stack((ia, ib)), dim=1)
            lo_a, lo_b, hi_a, hi_b = torch.cat((lo, hi)).tolist()
            for name, lo_, hi_, rows in (("eu", lo_a, hi_a, a.shape[0]),
                                         ("ev", lo_b, hi_b, b.shape[0])):
                if lo_ < 0 or hi_ >= rows:
                    raise ValueError(f"{name}: row id outside [0, {rows})")
        n_rows, ia_ptr, ib_ptr = ia.shape[0], ia.data_ptr(), ib.data_ptr()
    off = word_offset * a.element_size()
    return (a.data_ptr() + off, b.data_ptr() + off, w, ia_ptr, ib_ptr,
            n_rows, wc)


def digest_args(a: torch.Tensor, b: torch.Tensor, ia, word_count: int,
                body: str | None, capacity: int | None):
    """The body a launch runs and, for the digest body, its capacity
    (``digest_capacity(word_count)`` unless given) and a workspace from the
    caching allocator: the digest (8·N·C bytes), then ``nnz`` (4·N), the
    list of slots whose rows are both over the capacity (4·E) and its
    length (4), and ``need`` (N).  Unless ``body`` names one, gathered
    pairs from one bitmap (``a`` and ``b`` the same rows) run the digest
    body and any other pairs the direct body.  Returns ``(body, capacity,
    workspace)``; raises on what the body does not take."""
    one_bitmap = (ia is not None and a.data_ptr() == b.data_ptr()
                  and a.shape == b.shape)
    if body is None:
        body = "digest" if one_bitmap else "direct"
    if body not in LAUNCHES_BY_BODY:
        raise ValueError(f"body {body!r}: not one of {list(LAUNCHES_BY_BODY)}")
    if body == "direct":
        return body, 0, None
    if not one_bitmap:
        raise ValueError("the digest body reads both rows of a pair from one "
                         "bitmap by endpoint ids")
    capacity = digest_capacity(word_count) if capacity is None else int(capacity)
    if capacity < 0:
        raise ValueError(f"capacity {capacity}: need >= 0")
    n, e = a.shape[0], ia.shape[0]
    if e == 0:                    # nothing to launch
        return body, capacity, None
    ws = torch.empty((8 * n * capacity + 5 * n + 4 * e + 4,),
                     dtype=torch.uint8, device=a.device)
    return body, capacity, ws


def bitmap_support_launcher(a: torch.Tensor, b: torch.Tensor, ia=None,
                            ib=None, word_offset: int = 0,
                            word_count: int | None = None,
                            body: str | None = None,
                            capacity: int | None = None):
    """Check a K2 launch and bind its C entry on the current stream.
    Returns ``(body, launch, sup)``: each ``launch()`` enqueues the kernel
    into ``sup`` and raises on a refused launch; it counts nothing."""
    a_p, b_p, stride, ia_p, ib_p, n, nw = row_pair_args(
        a, b, ia, ib, word_offset, word_count)
    body, capacity, ws = digest_args(a, b, ia, nw, body, capacity)
    sup = torch.empty((n,), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = _build.library()
    if body == "digest":
        entry, args = lib.bitmap_support_digest_launch, (
            a_p, stride, a.shape[0], ia_p, ib_p, n, nw, capacity,
            sup.data_ptr(), ws.data_ptr() if ws is not None else None, stream)
    else:
        entry, args = lib.bitmap_support_launch, (
            a_p, b_p, stride, ia_p, ib_p, n, nw, sup.data_ptr(), stream)

    def launch(keep=(a, b, ia, ib, ws)):      # alive while bound
        with torch.cuda.device(a.device):
            _build.check(entry(*args), f"bitmap_support ({body})")
    return body, launch, sup


def bitmap_support_cuda(a: torch.Tensor, b: torch.Tensor, ia=None, ib=None,
                        word_offset: int = 0,
                        word_count: int | None = None,
                        body: str | None = None,
                        capacity: int | None = None) -> torch.Tensor:
    """Launch K2: int32 ``sup[i] = Σ_w popcount(a[ra_i, w] & b[rb_i, w])``
    over words ``[word_offset, word_offset + word_count)``.  ``body`` and
    ``capacity``: see ``digest_args``."""
    global LAUNCHES
    body, launch, sup = bitmap_support_launcher(a, b, ia, ib, word_offset,
                                                word_count, body, capacity)
    if sup.numel() == 0:
        return sup
    launch()
    LAUNCHES += 1
    LAUNCHES_BY_BODY[body] += 1
    return sup
