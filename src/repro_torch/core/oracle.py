"""Pure-Python reference implementation (ground truth for property tests).

* ``truss_decomposition`` — textbook peeling (Wang & Cheng style); this is the
  paper's ``batchUpdate`` building block and the oracle every incremental path
  is validated against.
* ``Oracle`` — a dict-based dynamic graph running the paper's Algorithm 1
  (deletion) and Algorithm 2 (insertion) *as published*, with two documented
  deviations where the published pseudocode is under-specified / unsound
  (see DESIGN.md §2 item 3 and the inline notes below).
"""
from __future__ import annotations

from collections import deque


def _canon(a: int, b: int):
    return (a, b) if a < b else (b, a)


def scratch_phi(n_nodes: int, edges) -> dict[tuple[int, int], int]:
    """From-scratch phi of an edge set — the shared exactness baseline used
    by tests and benchmarks (one implementation, not one per caller)."""
    adj: dict[int, set[int]] = {i: set() for i in range(n_nodes)}
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    return truss_decomposition(adj)


def phi_snapshot(state, phi=None) -> dict[tuple[int, int], int]:
    """{(u, v): phi} for the active edges of a GraphState (optionally with
    an override phi array) — the host-side view every exactness check
    compares against ``scratch_phi``/``truss_decomposition`` output."""
    import numpy as np  # local: keep this module importable without numpy

    act = np.asarray(state.active)
    edges = np.asarray(state.edges)[act]
    phis = np.asarray(state.phi if phi is None else phi)[act]
    return {(int(u), int(v)): int(p) for (u, v), p in zip(edges, phis)}


def truss_decomposition(adj: dict[int, set[int]]) -> dict[tuple[int, int], int]:
    """phi(e) for every edge of the graph given as adjacency sets."""
    sup: dict[tuple[int, int], int] = {}
    for u in adj:
        for v in adj[u]:
            if u < v:
                sup[(u, v)] = len(adj[u] & adj[v])
    alive = {u: set(vs) for u, vs in adj.items()}
    phi: dict[tuple[int, int], int] = {}
    remaining = set(sup)
    k = 3
    while remaining:
        # strip everything with support < k-2 (cascading), then advance k
        queue = deque(e for e in remaining if sup[e] < k - 2)
        queued = set(queue)
        while queue:
            e = queue.popleft()
            queued.discard(e)
            if e not in remaining:
                continue
            u, v = e
            phi[e] = k - 1
            remaining.discard(e)
            for w in alive[u] & alive[v]:
                for f in (_canon(u, w), _canon(v, w)):
                    sup[f] -= 1
                    if f in remaining and sup[f] < k - 2 and f not in queued:
                        queue.append(f)
                        queued.add(f)
            alive[u].discard(v)
            alive[v].discard(u)
        k += 1
    return phi


class Oracle:
    """Dynamic graph with paper-faithful incremental maintenance."""

    def __init__(self, n_nodes: int, edges=()):
        self.n = n_nodes
        self.adj: dict[int, set[int]] = {i: set() for i in range(n_nodes)}
        for a, b in edges:
            self.adj[a].add(b)
            self.adj[b].add(a)
        self.phi = truss_decomposition(self.adj)

    # -- helpers -----------------------------------------------------------
    def _partner_edges(self, a: int, b: int):
        """E_{S_ab <-> {a,b}} (paper Table 1)."""
        out = []
        for w in self.adj[a] & self.adj[b]:
            out.append(_canon(a, w))
            out.append(_canon(b, w))
        return out

    def _local_support(self, v1: int, v2: int, k: int) -> int:
        """Alg. 1 step 5: common neighbors whose both partner edges have phi >= k."""
        c = 0
        for w in self.adj[v1] & self.adj[v2]:
            if (self.phi[_canon(v1, w)] >= k and self.phi[_canon(v2, w)] >= k):
                c += 1
        return c

    def _phi_of_new_edge(self, a: int, b: int) -> int:
        """Exact local characterization of phi for an edge whose neighbors'
        phi values are correct:  phi(e) = max{k : |{w in S: phi(aw)>=k and
        phi(bw)>=k}| >= k-2}  (proof sketch: '>=' direction — the union of the
        (>=k)-trusses containing the qualifying partner edges plus e is a
        k-truss containing e; '<=' direction — inside e's k-truss every
        partner edge has phi >= k)."""
        s = self.adj[a] & self.adj[b]
        best = 2
        for k in range(3, len(s) + 3):
            cnt = sum(1 for w in s
                      if self.phi[_canon(a, w)] >= k and self.phi[_canon(b, w)] >= k)
            if cnt >= k - 2:
                best = k
            else:
                break
        return best

    # -- Algorithm 1: deletion ---------------------------------------------
    def delete(self, a: int, b: int):
        """Remove edge (a, b) and repair phi per the paper's Algorithm 1."""
        e = _canon(a, b)
        phi_e = self.phi[e]
        partners = self._partner_edges(a, b)
        kmin = min((self.phi[f] for f in partners), default=None)
        # structural delete first (paper line 1)
        self.adj[a].discard(b)
        self.adj[b].discard(a)
        del self.phi[e]
        if kmin is None or kmin > phi_e:
            return  # Theorem 1(a)
        lo, hi = kmin, phi_e
        queue = deque(f for f in partners if lo <= self.phi[f] <= hi)
        marked: set = set()
        while queue:
            f = queue.popleft()
            if f in marked or f not in self.phi:
                continue
            k = self.phi[f]
            if not (lo <= k <= hi):
                continue
            if self._local_support(f[0], f[1], k) < k - 2:
                self.phi[f] = k - 1
                marked.add(f)
                for g in self._partner_edges(*f):
                    if g not in marked and lo <= self.phi[g] <= hi:
                        queue.append(g)

    # -- Algorithm 2: insertion (mark-and-verify) ---------------------------
    def insert(self, a: int, b: int):
        """Add edge (a, b) and repair phi per Algorithm 2 (mark-and-verify)."""
        s = self.adj[a] & self.adj[b]
        partners = self._partner_edges(a, b)
        kmin = min((self.phi[f] for f in partners), default=None)
        kmax = max((self.phi[f] for f in partners), default=None)
        e = _canon(a, b)
        self.adj[a].add(b)
        self.adj[b].add(a)
        if kmin is None or kmin > len(s) + 1:
            self.phi[e] = self._phi_of_new_edge(a, b)
            return  # Theorem 2(a)
        lo, hi = kmin, min(len(s) + 1, kmax)

        # Outer fixpoint on the inserted edge's phi estimate (DESIGN §2.3):
        # the paper computes phi(e) "at the end" (line 19) yet reads it during
        # localSupport2.  The iteration must run FROM ABOVE — start at the
        # upper bound min(|S|+2, kmax+1) (Lemma 1 + Lemma 4) and verify
        # downward — because promotions and phi(e_new) can be mutually
        # dependent (a from-below estimate settles edges unsoundly and the
        # joint least fixpoint under-promotes).  Every iterate stays >= the
        # true value (mark set is monotone in phi(e_new)), so settles remain
        # sound; the sequence is decreasing and bounded, and any consistent
        # fixpoint from above equals the truth (union/achievability argument
        # in _phi_of_new_edge's docstring).
        self.phi[e] = min(len(s) + 2, kmax + 1)
        while True:
            marked, unchanged = self._mark_and_verify(e, partners, lo, hi)
            trial = dict(self.phi)
            for f in marked:
                trial[f] = self.phi[f] + 1
            saved = self.phi
            self.phi = trial
            est = self._phi_of_new_edge(a, b)
            self.phi = saved
            if est == self.phi[e]:
                for f in marked:
                    self.phi[f] += 1
                return
            self.phi[e] = est

    def _ls2(self, v1, v2, k, e_new, unchanged):
        """Corrected localSupport2 (Alg. 3). A partner edge g qualifies for
        membership of the (k+1)-truss iff phi(g) >= k+1 already, or
        phi(g) == k and g may still be promoted (not proven unchanged).
        The inserted edge's phi is an exact estimate, never 'promotable', so
        it qualifies only with phi >= k+1.  (The published condition
        ``phi >= k and not unchanged`` both over-excludes settled edges with
        phi > k and never settles never-marked failures; see DESIGN.md.)"""
        c = 0
        for w in self.adj[v1] & self.adj[v2]:
            ok = True
            for g in (_canon(v1, w), _canon(v2, w)):
                p = self.phi[g]
                if p >= k + 1 and g != e_new:
                    continue
                if g != e_new and p == k and g not in unchanged:
                    continue
                if g == e_new and p >= k + 1:
                    continue
                ok = False
                break
            if ok:
                c += 1
        return c

    def _mark_and_verify(self, e_new, partners, lo, hi):
        marked: set = set()
        unchanged: set = set()
        queue = deque(f for f in partners
                      if f != e_new and lo <= self.phi[f] <= hi)
        while queue:
            f = queue.popleft()
            if f in unchanged or f == e_new:
                continue
            k = self.phi[f]
            if not (lo <= k <= hi):
                continue
            if self._ls2(f[0], f[1], k, e_new, unchanged) >= k - 1:
                if f not in marked:
                    marked.add(f)
                    for g in self._partner_edges(*f):
                        if g != e_new and g not in unchanged and lo <= self.phi[g] <= hi:
                            queue.append(g)
            else:
                # Fail is final within a round (the bound only decreases), so
                # settle f regardless of mark state — the published Alg. 2
                # only settles previously-marked edges, which lets a
                # never-marked failure keep inflating neighbors' bounds.
                marked.discard(f)
                unchanged.add(f)
                for g in self._partner_edges(*f):
                    if g != e_new and g not in unchanged and lo <= self.phi[g] <= hi:
                        queue.append(g)
        return marked, unchanged

    def apply(self, updates):
        """Sequential replay of a (op, a, b) stream — op 1 inserts, 0
        deletes (data.streams convention).  Ground truth for the batched
        engine: phi depends only on the final edge set, so a netted batch
        must match this replay edge-for-edge."""
        for op, a, b in updates:
            if int(op) == 1:
                self.insert(int(a), int(b))
            else:
                self.delete(int(a), int(b))

    # -- queries -------------------------------------------------------------
    def k_truss_edges(self, k: int):
        """Canonical edge set of the k-truss."""
        return {e for e, p in self.phi.items() if p >= k}

    def check(self):
        """Assert phi matches from-scratch decomposition (test hook)."""
        ref = truss_decomposition(self.adj)
        assert ref == self.phi, (
            sorted((e, self.phi[e], ref[e]) for e in ref if self.phi.get(e) != ref[e]))
