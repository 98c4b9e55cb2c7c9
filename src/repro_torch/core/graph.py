"""Capacity-bounded dynamic graph state for the truss engine (PyTorch).

Port of ``repro.core.graph``: the same fixed-capacity arrays, sentinels and
slot-assignment rules, so every tensor compares array for array with the
reference.

* ``edges   int32[E_cap, 2]``  canonical (u < v) endpoints; sentinel ``(N, N)``
  on inactive slots.
* ``active  bool[E_cap]``      slot validity.
* ``phi     int32[E_cap]``     truss numbers (paper's ``phi(e)``); 0 inactive.
* ``nbr     int32[N, D_max]``  per-node **sorted** neighbor ids, padded with
  the sentinel ``N`` (sorts last, keeps rows sorted).
* ``eid     int32[N, D_max]``  edge-slot index aligned with ``nbr``.
* ``deg     int32[N]``         current degree.

The adjacency bitmap is **int32** ``[N, W]`` holding the reference's uint32
bits unchanged (torch has no uint32 shift or scatter-add on every device).
Scatter-add-as-OR and subtract-to-clear wrap identically in int32, bit 31
included, because every (edge, direction) owns one distinct bit.

Structural edits (``insert_edge_struct``, ``delete_edge_struct``,
``apply_edge_batch_struct``) and ``update_bitmap`` update their input
tensors **in place** and return them — the port's form of the reference's
buffer donation.  Every other function is pure.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static (hashable) graph capacities — the same fields and properties
    as ``repro.core.graph.GraphSpec``.

    ``n_shards``/``shard_axis``/``partition`` describe the reference's mesh
    geometry; the port runs one device, so only the defaults are driven
    here (the sharded substrate is a later slice), but the fields stay so
    specs compare and hash alike in both packages.
    """

    n_nodes: int
    d_max: int
    e_cap: int
    n_shards: int = 1
    shard_axis: str = "shard"
    partition: str = "replicated"

    def __post_init__(self):
        if self.e_cap % self.n_shards:
            raise ValueError(
                f"e_cap {self.e_cap} must divide into n_shards "
                f"{self.n_shards} row blocks")
        if self.partition not in ("replicated", "nodes"):
            raise ValueError(
                f"unknown bitmap partition {self.partition!r} "
                "(expected 'replicated' or 'nodes')")

    @property
    def n_words(self) -> int:
        """32-bit words per adjacency-bitmap row (padded to uniform
        per-shard word slabs under ``partition='nodes'``)."""
        w = (self.n_nodes + 31) // 32
        if self.partition == "nodes":
            w = -(-w // self.n_shards) * self.n_shards
        return w

    @property
    def word_block(self) -> int:
        """Words of one device's bitmap slab (``n_words`` when replicated)."""
        if self.partition == "nodes":
            return self.n_words // self.n_shards
        return self.n_words

    @property
    def bitmap_bytes_per_device(self) -> int:
        """Resident adjacency-bitmap bytes per device."""
        return self.n_nodes * self.word_block * 4

    @property
    def state_bytes_per_device(self) -> int:
        """Resident ``GraphState`` bytes per device: edge arrays
        (edges/active/phi), node tables (nbr/eid/deg) and the bitmap."""
        e_blk = self.e_cap // self.n_shards
        edge_bytes = e_blk * (2 * 4 + 1 + 4)          # edges, active, phi
        node_bytes = self.n_nodes * (2 * self.d_max * 4 + 4)  # nbr, eid, deg
        return edge_bytes + node_bytes + self.bitmap_bytes_per_device


class GraphState(NamedTuple):
    """Device-resident graph: edge table, activity mask, phi, and CSR-ish
    fixed-width adjacency (``nbr``/``eid``/``deg``), all torch tensors."""

    edges: torch.Tensor   # int32[E_cap, 2]
    active: torch.Tensor  # bool[E_cap]
    phi: torch.Tensor     # int32[E_cap]
    nbr: torch.Tensor     # int32[N, D_max]
    eid: torch.Tensor     # int32[N, D_max]
    deg: torch.Tensor     # int32[N]


_I32 = torch.int32
_STATE_DTYPES = (np.int32, np.bool_, np.int32, np.int32, np.int32, np.int32)


def _state_shapes(spec: GraphSpec):
    n, d, e = spec.n_nodes, spec.d_max, spec.e_cap
    return ((e, 2), (e,), (e,), (n, d), (n, d), (n,))


def empty_state(spec: GraphSpec, device="cuda") -> GraphState:
    """Fresh all-inactive state at the spec's capacities (sentinel = n_nodes)."""
    n, d, e = spec.n_nodes, spec.d_max, spec.e_cap
    return GraphState(
        edges=torch.full((e, 2), n, dtype=_I32, device=device),
        active=torch.zeros((e,), dtype=torch.bool, device=device),
        phi=torch.zeros((e,), dtype=_I32, device=device),
        nbr=torch.full((n, d), n, dtype=_I32, device=device),
        eid=torch.full((n, d), e, dtype=_I32, device=device),
        deg=torch.zeros((n,), dtype=_I32, device=device),
    )


def state_from_numpy(spec: GraphSpec, arrays, device="cuda") -> GraphState:
    """``GraphState`` on ``device`` from six host arrays in field order
    (e.g. a ``repro`` state passed through ``np.asarray``).  Shapes are
    checked against ``spec``; values are taken bit for bit."""
    arrays = tuple(arrays)
    if len(arrays) != len(GraphState._fields):
        raise ValueError(f"expected {len(GraphState._fields)} arrays "
                         f"{GraphState._fields}, got {len(arrays)}")
    out = []
    for name, x, dt, shape in zip(GraphState._fields, arrays, _STATE_DTYPES,
                                  _state_shapes(spec)):
        x = np.ascontiguousarray(np.asarray(x), dtype=dt)
        if not x.flags.writeable:   # e.g. a read-only view of a jax array
            x = x.copy()
        if x.shape != shape:
            raise ValueError(f"{name}: shape {x.shape} != {shape} for {spec}")
        out.append(torch.from_numpy(x).to(device))
    return GraphState(*out)


def state_to_numpy(st: GraphState) -> tuple:
    """Host copies of the six state arrays, in ``GraphState`` field order."""
    return tuple(x.detach().cpu().numpy() for x in st)


def bitmap_from_numpy(bm: np.ndarray, device="cuda") -> torch.Tensor:
    """int32 tensor holding a uint32 ``[N, W]`` bitmap's bits unchanged."""
    bm = np.ascontiguousarray(bm, dtype=np.uint32)
    return torch.from_numpy(bm.view(np.int32)).to(device)


def bitmap_to_numpy(bm: torch.Tensor) -> np.ndarray:
    """The uint32 host view of an int32 bitmap tensor (bits unchanged)."""
    return bm.detach().cpu().numpy().view(np.uint32)


def from_edge_list(spec: GraphSpec, edge_list: np.ndarray,
                   device="cuda") -> GraphState:
    """Bulk-load (host-side, numpy) — the fast path for dataset ingestion.

    ``edge_list``: int array [m, 2]; duplicates/self-loops rejected.
    """
    el = np.asarray(edge_list, dtype=np.int64)
    if el.size == 0:
        return empty_state(spec, device)
    u = np.minimum(el[:, 0], el[:, 1])
    v = np.maximum(el[:, 0], el[:, 1])
    if (u == v).any():
        raise ValueError("self-loops are not allowed (simple graph)")
    keys = u * spec.n_nodes + v
    if len(np.unique(keys)) != len(keys):
        raise ValueError("duplicate edges are not allowed (simple graph)")
    m = len(u)
    if m > spec.e_cap:
        raise ValueError(f"{m} edges exceed capacity {spec.e_cap}")

    n, d = spec.n_nodes, spec.d_max
    nbr = np.full((n, d), n, dtype=np.int32)
    eid = np.full((n, d), spec.e_cap, dtype=np.int32)
    half = np.concatenate([np.stack([u, v], 1), np.stack([v, u], 1)])
    eidx = np.concatenate([np.arange(m), np.arange(m)])
    order = np.lexsort((half[:, 1], half[:, 0]))
    half, eidx = half[order], eidx[order]
    src, dst = half[:, 0], half[:, 1]
    counts = np.bincount(src, minlength=n)
    if counts.max(initial=0) > d:
        raise ValueError(f"max degree {counts.max()} exceeds d_max {d}")
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(src)) - starts[src]
    nbr[src, slot] = dst
    eid[src, slot] = eidx

    edges = np.full((spec.e_cap, 2), n, dtype=np.int32)
    edges[:m, 0] = u
    edges[:m, 1] = v
    active = np.zeros((spec.e_cap,), dtype=bool)
    active[:m] = True
    phi = np.zeros((spec.e_cap,), dtype=np.int32)
    return state_from_numpy(spec, (edges, active, phi, nbr, eid,
                                   counts.astype(np.int32)), device)


# ---------------------------------------------------------------------------
# small helpers: the reference's fixed-size nonzero/unique and drop-mode
# scatters, written out for torch
# ---------------------------------------------------------------------------

def nonzero_padded(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]`` as int32: the
    first ``size`` true positions in order, padded with ``fill``."""
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)[:size].to(_I32)
    if idx.numel() < size:
        idx = torch.cat([idx, idx.new_full((size - idx.numel(),), fill)])
    return idx


def set_drop(x: torch.Tensor, ids: torch.Tensor, val) -> torch.Tensor:
    """``x.at[ids].set(val, mode="drop")`` in place along axis 0: entries
    whose id is outside ``[0, len(x))`` are dropped."""
    ids = ids.reshape(-1)
    keep = (ids >= 0) & (ids < x.shape[0])
    if isinstance(val, torch.Tensor) and val.dim() > 0:
        val = val.reshape((-1,) + tuple(x.shape[1:]))[keep]
    x[ids[keep]] = val
    return x


def add_drop(x: torch.Tensor, ids: torch.Tensor, val) -> torch.Tensor:
    """``x.at[ids].add(val, mode="drop")`` in place (1-D ``x``), with
    duplicate ids accumulating."""
    ids = ids.reshape(-1)
    keep = (ids >= 0) & (ids < x.shape[0])
    vals = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    vals = vals.expand(ids.shape) if vals.dim() == 0 else vals.reshape(-1)
    x.index_put_((ids[keep],), vals[keep], accumulate=True)
    return x


def _bsearch_rows(rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per-row ``searchsorted`` (side left): ``rows [B, D]`` sorted, ``vals
    [B, K]`` -> int32 positions ``[B, K]`` (``vmap(jnp.searchsorted)``)."""
    return torch.searchsorted(rows.contiguous(), vals.contiguous()).to(_I32)


# ---------------------------------------------------------------------------
# Row edits (vectorized O(D_max) shift-insert / shift-delete on sorted rows).
# ---------------------------------------------------------------------------

def _row_insert(row: torch.Tensor, pos: torch.Tensor, val) -> torch.Tensor:
    i = torch.arange(row.shape[0], device=row.device)
    shifted = row[torch.clamp(i - 1, min=0)]
    val = torch.as_tensor(val, dtype=row.dtype, device=row.device)
    return torch.where(i < pos, row, torch.where(i == pos, val, shifted))


def _row_delete(row: torch.Tensor, pos: torch.Tensor, sentinel) -> torch.Tensor:
    i = torch.arange(row.shape[0], device=row.device)
    nxt = torch.cat([row[1:], row.new_full((1,), sentinel)])
    return torch.where(i < pos, row, nxt)


def lookup_edge(spec: GraphSpec, st: GraphState, a: torch.Tensor,
                b: torch.Tensor):
    """Return (slot, found) for edge (a, b) via binary search of a's row.

    ``a``/``b`` may be 0-d or 1-d (the batched form replaces the
    reference's ``vmap``); outputs take their shape."""
    shape = a.shape
    a1, b1 = a.reshape(-1).long(), b.reshape(-1).to(_I32)
    row = st.nbr[a1]                                        # [B, D]
    p = _bsearch_rows(row, b1[:, None])[:, 0]
    pc = torch.clamp(p, max=spec.d_max - 1).long()
    found = row.gather(1, pc[:, None])[:, 0] == b1
    slot = torch.where(found, st.eid[a1, pc], spec.e_cap)
    return slot.reshape(shape), found.reshape(shape)


def _scalar(x, st: GraphState) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_I32, device=st.edges.device)


def insert_edge_struct(spec: GraphSpec, st: GraphState, a, b):
    """Structural insert (no phi maintenance), in place. Returns
    (state, slot).

    Caller guarantees: edge absent, a != b, deg < d_max, a free slot exists.
    """
    a, b = _scalar(a, st), _scalar(b, st)
    u = torch.minimum(a, b).long()
    v = torch.maximum(a, b).long()
    slot = (~st.active).to(_I32).argmax().to(_I32)  # first free slot
    st.edges[slot] = torch.stack([u, v]).to(_I32)
    st.active[slot] = True

    pa = _bsearch_rows(st.nbr[u][None], v.to(_I32).reshape(1, 1))[0, 0]
    st.eid[u] = _row_insert(st.eid[u], pa, slot)
    st.nbr[u] = _row_insert(st.nbr[u], pa, v)
    pb = _bsearch_rows(st.nbr[v][None], u.to(_I32).reshape(1, 1))[0, 0]
    st.eid[v] = _row_insert(st.eid[v], pb, slot)
    st.nbr[v] = _row_insert(st.nbr[v], pb, u)
    st.deg[u] += 1
    st.deg[v] += 1
    return st, slot


def delete_edge_struct(spec: GraphSpec, st: GraphState, a, b):
    """Structural delete, in place. Returns (state, slot_of_deleted_edge)."""
    a, b = _scalar(a, st), _scalar(b, st)
    u = torch.minimum(a, b).long()
    v = torch.maximum(a, b).long()
    slot, _found = lookup_edge(spec, st, u, v)
    slot_c = torch.clamp(slot, max=spec.e_cap - 1).long()
    st.edges[slot_c] = spec.n_nodes
    st.active[slot_c] = False
    st.phi[slot_c] = 0

    pa = _bsearch_rows(st.nbr[u][None], v.to(_I32).reshape(1, 1))[0, 0]
    st.nbr[u] = _row_delete(st.nbr[u], pa, spec.n_nodes)
    st.eid[u] = _row_delete(st.eid[u], pa, spec.e_cap)
    pb = _bsearch_rows(st.nbr[v][None], u.to(_I32).reshape(1, 1))[0, 0]
    st.nbr[v] = _row_delete(st.nbr[v], pb, spec.n_nodes)
    st.eid[v] = _row_delete(st.eid[v], pb, spec.e_cap)
    st.deg[u] -= 1
    st.deg[v] -= 1
    return st, slot


def apply_edge_batch_struct(spec: GraphSpec, st: GraphState,
                            del_u, del_v, del_valid,
                            ins_u, ins_v, ins_valid):
    """Vectorized multi-edge structural update (no phi maintenance), in
    place.

    All six tensors are length-B (padded; masked rows are ignored).  Every
    affected adjacency row is rebuilt in one batched pass: deleted entries
    are overwritten with the sort-last sentinel, inserted neighbors are
    appended in a candidate block, and one stable sort per row restores the
    sorted-row invariant for ``nbr``/``eid`` jointly.

    Caller guarantees (checked host-side by ``DynamicGraph.apply_batch``):
    valid deletions exist, valid insertions are absent, no edge pair appears
    twice across the batch, and the post-update graph fits (e_cap, d_max).

    Returns ``(state, ins_slots int32[B])`` (slot ``e_cap`` on masked rows).
    """
    n, d, e_cap = spec.n_nodes, spec.d_max, spec.e_cap
    bsz = del_u.shape[0]
    du = torch.minimum(del_u, del_v).to(_I32)
    dv = torch.maximum(del_u, del_v).to(_I32)
    iu = torch.minimum(ins_u, ins_v).to(_I32)
    iv = torch.maximum(ins_u, ins_v).to(_I32)

    # -- edge-slot table: free deleted slots, then claim slots for inserts --
    duc = torch.where(del_valid, du, 0)
    dvc = torch.where(del_valid, dv, 0)
    d_slot, d_found = lookup_edge(spec, st, duc, dvc)
    vdel = del_valid & d_found
    tgt_d = torch.where(vdel, d_slot, e_cap)
    set_drop(st.edges, tgt_d, n)
    set_drop(st.active, tgt_d, False)
    set_drop(st.phi, tgt_d, 0)

    free_idx = nonzero_padded(~st.active, bsz, e_cap)
    rank = torch.cumsum(ins_valid.to(_I32), 0, dtype=_I32) - 1
    ins_slots = torch.where(ins_valid,
                            free_idx[torch.clamp(rank, 0, bsz - 1).long()],
                            e_cap)
    tgt_i = torch.where(ins_valid, ins_slots, e_cap)
    set_drop(st.edges, tgt_i, torch.stack([iu, iv], 1))
    set_drop(st.active, tgt_i, True)

    # -- rebuild every affected adjacency row ------------------------------
    nodes = torch.cat([torch.where(vdel, du, n), torch.where(vdel, dv, n),
                       torch.where(ins_valid, iu, n),
                       torch.where(ins_valid, iv, n)])
    r = 4 * bsz
    uniq = torch.unique(nodes, sorted=True).to(_I32)[:r]
    uniq = torch.cat([uniq, uniq.new_full((r - uniq.numel(),), n)])
    rows_nbr = st.nbr[torch.clamp(uniq, max=n - 1).long()]       # [R, D]
    rows_eid = st.eid[torch.clamp(uniq, max=n - 1).long()]

    def row_of(x):
        return torch.clamp(torch.searchsorted(uniq, x.to(_I32)),
                           max=r - 1).long()

    delmask = torch.zeros((r, d), dtype=torch.bool, device=nodes.device)

    def mark_deleted(xs, others):
        i = row_of(xs)                                           # [B]
        pos = _bsearch_rows(rows_nbr[i], others[:, None])[:, 0]
        posc = torch.clamp(pos, max=d - 1).long()
        hit = vdel & (rows_nbr[i, posc] == others)
        delmask[i[hit], posc[hit]] = True

    mark_deleted(du, dv)
    mark_deleted(dv, du)
    ext_nbr = torch.where(delmask, n, rows_nbr)
    ext_eid = torch.where(delmask, e_cap, rows_eid)

    cand_nbr = torch.full((r, bsz), n, dtype=_I32, device=nodes.device)
    cand_eid = torch.full((r, bsz), e_cap, dtype=_I32, device=nodes.device)
    col = torch.arange(bsz, device=nodes.device)
    ok = ins_valid
    cand_nbr[row_of(iu)[ok], col[ok]] = iv[ok]
    cand_nbr[row_of(iv)[ok], col[ok]] = iu[ok]
    cand_eid[row_of(iu)[ok], col[ok]] = ins_slots[ok]
    cand_eid[row_of(iv)[ok], col[ok]] = ins_slots[ok]

    ext_nbr = torch.cat([ext_nbr, cand_nbr], dim=1)              # [R, D+B]
    ext_eid = torch.cat([ext_eid, cand_eid], dim=1)
    sorted_nbr, order = torch.sort(ext_nbr, dim=1, stable=True)
    new_nbr = sorted_nbr[:, :d]
    new_eid = torch.gather(ext_eid, 1, order)[:, :d]

    real = uniq < n
    rows = uniq[real].long()
    st.nbr[rows] = new_nbr[real]
    st.eid[rows] = new_eid[real]
    st.deg[rows] = (new_nbr[real] < n).sum(1).to(_I32)
    return st, ins_slots


# ---------------------------------------------------------------------------
# Triangle partner enumeration — the shared primitive behind support,
# localSupport (Alg. 1 step 5) and localSupport2 (Alg. 3).
# ---------------------------------------------------------------------------

def triangle_partners(spec: GraphSpec, st: GraphState, u: torch.Tensor,
                      v: torch.Tensor):
    """For each query edge (u[i], v[i]) enumerate common neighbors.

    Returns ``(id_uw, id_vw, valid)`` of shape [B, D_max]: slot ids of the two
    partner edges (u,w), (v,w) for every common neighbor w, and a validity
    mask.
    """
    u, v = u.long(), v.long()
    w = st.nbr[u]                       # [B, D]
    id_uw = st.eid[u]                   # [B, D]
    valid_w = w < spec.n_nodes
    rows_v = st.nbr[v]                  # [B, D]
    pos = _bsearch_rows(rows_v, w)      # [B, D]
    pos_c = torch.clamp(pos, max=spec.d_max - 1).long()
    found = torch.gather(rows_v, 1, pos_c) == w
    id_vw = torch.gather(st.eid[v], 1, pos_c)
    return id_uw, id_vw, valid_w & found


def phi_of(st: GraphState, e_cap: int, ids: torch.Tensor) -> torch.Tensor:
    """phi gather with OOB → 0 (sentinel slot e_cap means "no edge")."""
    return torch.where(ids < e_cap,
                       st.phi[torch.clamp(ids, max=e_cap - 1).long()], 0)


def support(spec: GraphSpec, st: GraphState, u: torch.Tensor,
            v: torch.Tensor, alive: torch.Tensor | None = None) -> torch.Tensor:
    """Global support sup(e, G) for query edges; optionally restricted to an
    ``alive`` mask over edge slots (used by peeling)."""
    id1, id2, valid = triangle_partners(spec, st, u, v)
    if alive is not None:
        al = torch.cat([alive, alive.new_zeros(1)])  # slot e_cap → False
        valid = (valid & al[torch.clamp(id1, max=spec.e_cap).long()]
                 & al[torch.clamp(id2, max=spec.e_cap).long()])
    return valid.sum(1).to(_I32)


def _endpoints(spec: GraphSpec, edges: torch.Tensor):
    """Clamped endpoint ids (sentinel rows read node n-1, masked later)."""
    return (torch.clamp(edges[:, 0], max=spec.n_nodes - 1),
            torch.clamp(edges[:, 1], max=spec.n_nodes - 1))


def support_all(spec: GraphSpec, st: GraphState, alive: torch.Tensor) -> torch.Tensor:
    """Support of every edge slot within the ``alive`` subgraph. [E_cap]."""
    u, v = _endpoints(spec, st.edges)
    sup = support(spec, st, u, v, alive=alive)
    return torch.where(alive, sup, 0)


# ---------------------------------------------------------------------------
# Adjacency bitmaps — intersection via AND + popcount.
# ---------------------------------------------------------------------------

# bit b of a word as int32 (1 << 31 is the int32 minimum), and its negation
# mod 2^32 for subtract-to-clear
_BITS = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
_SET = torch.from_numpy(_BITS.view(np.int32).copy())
_CLEAR = torch.from_numpy((np.uint32(0) - _BITS).view(np.int32).copy())


def _scatter_bits(bm: torch.Tensor, src, dst, keep, table):
    """Add ``table[dst % 32]`` at ``bm[src, dst // 32]`` for every kept pair
    whose row is in range, in place (int32 wrap == uint32 add).  The word
    index is clipped as in the reference; sentinel rows (node ``N``) drop."""
    n_rows, w = bm.shape
    word = torch.clamp(dst // 32, max=w - 1)
    keep = keep & (src < n_rows)
    val = table.to(bm.device)[(dst % 32).long()]
    bm.index_put_((src[keep].long(), word[keep].long()), val[keep],
                  accumulate=True)
    return bm


def partial_bitmap(spec: GraphSpec, edges: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """int32[N, W] bitmap contribution of an edge subset ([B, 2], masked).

    Each valid edge contributes one distinct bit per direction, so
    scatter-add equals scatter-or.  (The reference's word-slab arguments
    serve the node-partitioned bitmap, ROADMAP item 13.)
    """
    bm = torch.zeros((spec.n_nodes, spec.n_words), dtype=_I32,
                     device=edges.device)
    u, v = edges[:, 0], edges[:, 1]
    for src, dst in ((u, v), (v, u)):
        _scatter_bits(bm, src, dst, valid, _SET)
    return bm


def build_bitmap(spec: GraphSpec, st: GraphState, alive: torch.Tensor) -> torch.Tensor:
    """int32[N, W] adjacency bitmap of the alive subgraph."""
    return partial_bitmap(spec, st.edges, alive)


def update_bitmap(spec: GraphSpec, bm: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor, valid: torch.Tensor, *,
                  set_bits: bool) -> torch.Tensor:
    """Set (insert) or clear (delete/peel) per-edge bits **in place** and
    return ``bm``.

    Clearing relies on the simple-graph invariant: every (edge, direction)
    owns one distinct bit, set iff the edge is present, so subtracting the
    bit value clears it with no borrow.  Caller guarantees set bits are
    absent and cleared bits are present.
    """
    table = _SET if set_bits else _CLEAR
    for src, dst in ((u, v), (v, u)):
        _scatter_bits(bm, src, dst, valid, table)
    return bm


def support_all_bitmap(spec: GraphSpec, st: GraphState, alive: torch.Tensor,
                       bitmap: torch.Tensor | None = None) -> torch.Tensor:
    """Support of every edge via bitmap AND + popcount, read straight from
    the bitmap by endpoint (the ``bitmap_support`` kernel's gathered
    entry: no ``[E, W]`` row gather is materialized)."""
    from ..kernels import ops as kernel_ops  # kernels never import core

    if bitmap is None:
        bitmap = build_bitmap(spec, st, alive)
    u, v = _endpoints(spec, st.edges)
    sup = kernel_ops.bitmap_support_gathered(bitmap, u, v)
    return torch.where(alive, sup, 0)
