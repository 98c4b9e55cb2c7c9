"""Synthetic graph generators: Erdos-Renyi and power-law edge lists.

Copied from ``repro.data.synthetic`` (graphs only), so seeded graphs are
the same edge lists in both packages.
"""
from __future__ import annotations

import numpy as np


def er_graph(n: int, avg_deg: float, seed: int = 0) -> np.ndarray:
    """Erdos-Renyi edge list [m, 2] (u < v)."""
    rng = np.random.default_rng(seed)
    p = min(1.0, avg_deg / max(n - 1, 1))
    m_target = int(n * avg_deg / 2)
    # sample with replacement then dedupe (fast for sparse)
    u = rng.integers(0, n, size=m_target * 2)
    v = rng.integers(0, n, size=m_target * 2)
    keep = u != v
    u, v = np.minimum(u[keep], v[keep]), np.maximum(u[keep], v[keep])
    keys = np.unique(u.astype(np.int64) * n + v)
    del p
    out = np.stack([keys // n, keys % n], 1)
    return out[:m_target]


def powerlaw_graph(n: int, m_per_node: int = 4, seed: int = 0,
                   max_degree: int | None = None,
                   triangle_p: float = 0.7) -> np.ndarray:
    """Barabasi-Albert-style preferential attachment (triangle-rich variant:
    each new node also closes one triangle among its targets), producing the
    clustered power-law structure of the paper's social-network datasets.

    Vectorized Batagelj-Brandes construction (arXiv:cond-mat/0412004 idiom):
    instead of per-node rejection sampling over a growing occurrence list
    (``repro.data.synthetic.powerlaw_graph_reference``, O(n·m)), every
    draw indexes the *virtual* occurrence array ``[seed pairs | (src, tgt)
    pairs]`` whose even slots are known up front; odd-slot references (a
    draw landing on an earlier draw's target) strictly decrease, so pointer
    doubling resolves them all in O(log) numpy passes.  Self-loop draws are
    dropped and duplicates deduped (multi-edge draws ARE the preferential
    bias in B-B), triangle closing connects each new node's first two
    targets with probability ``triangle_p``, and ``max_degree`` admits edges
    first-come in generation order.  Emits 10^6 edges in well under a
    second and 10^7 in tens of seconds.  Seeded + deterministic; distribution
    equivalence with the reference loop is pinned in ``repro``'s tests.
    """
    rng = np.random.default_rng(seed)
    n0 = min(m_per_node + 1, n)
    seed_u, seed_v = (x.astype(np.int64) for x in np.triu_indices(n0, k=1))
    if n <= n0:
        return np.stack([seed_u, seed_v], 1)
    m = m_per_node
    nv = n - n0
    e0 = len(seed_u)
    l0 = 2 * e0                        # occurrence slots owned by the clique
    nd = m * nv                        # one (src, tgt) occurrence pair per draw
    src = n0 + np.arange(nd) // m      # the new node of each draw
    pos = l0 + 2 * np.arange(nd)       # occurrence count before draw i
    r = (rng.random(nd) * pos).astype(np.int64)
    # resolve r -> node id: seed slots and even draw slots are known; an odd
    # draw slot l0+2j+1 IS draw j's target, i.e. whatever r[j] points at —
    # pointer values strictly decrease, so doubling converges in O(log nd)
    while True:
        odd = (r >= l0) & ((r - l0) % 2 == 1)
        if not odd.any():
            break
        r[odd] = r[(r[odd] - l0) // 2]
    tgt = np.where(
        r < l0,
        np.where(r % 2 == 0, seed_u[np.minimum(r // 2, e0 - 1)],
                 seed_v[np.minimum(r // 2, e0 - 1)]),
        src[np.maximum(r - l0, 0) // 2])
    # triangle closing: connect each new node's first two targets (the
    # vectorized form of the reference generator's clustered variant)
    if m >= 2:
        t2 = tgt.reshape(nv, m)
        vnode = n0 + np.arange(nv)
        a, b = t2[:, 0], t2[:, 1]
        close = ((a != b) & (a != vnode) & (b != vnode)
                 & (rng.random(nv) < triangle_p))
        cu = np.minimum(a[close], b[close])
        cv = np.maximum(a[close], b[close])
    else:
        cu = cv = np.zeros(0, np.int64)
    ok = src != tgt
    allu = np.concatenate([seed_u, np.minimum(src[ok], tgt[ok]), cu])
    allv = np.concatenate([seed_v, np.maximum(src[ok], tgt[ok]), cv])
    # dedup keeping generation order, so the degree cap admits first-come
    _, first = np.unique(allu * n + allv, return_index=True)
    order = np.sort(first)
    allu, allv = allu[order], allv[order]
    if max_degree is not None:
        ids = np.concatenate([allu, allv])
        eidx = np.tile(np.arange(len(allu)), 2)
        o2 = np.lexsort((eidx, ids))
        sid = ids[o2]
        rank = np.arange(len(sid)) - np.searchsorted(sid, sid, side="left")
        ranks = np.empty(len(sid), np.int64)
        ranks[o2] = rank
        keep = ((ranks[:len(allu)] < max_degree)
                & (ranks[len(allu):] < max_degree))
        allu, allv = allu[keep], allv[keep]
    out = np.stack([allu, allv], 1)
    return out[np.lexsort((out[:, 1], out[:, 0]))]
