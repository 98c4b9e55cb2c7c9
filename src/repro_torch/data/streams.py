"""Update-stream generation (paper §6.1): random insert/delete mixes over a
base graph, stored for reuse so every approach sees the identical stream —
plus the mixed read/write serving workload that drives the cluster.

Copied from ``repro.data.streams`` (numpy only): at the same seed both
packages yield identical arrays and records.  Two costs of the reference
are cut without changing a draw, so the streams run at a full-width graph
(980,614 edges): a delete picks the ``i``-th edge of the sorted present
set from a sorted list kept beside the set (the reference sorts the whole
set on every delete), and a zipf key reads the cumulative distribution
once built (``Generator.choice(n, p=p)`` rebuilds it on every call, then
draws one ``random()`` and searches it, which is what ``_zipf_node`` does).
"""
from __future__ import annotations

import bisect

import numpy as np

OP_DELETE = 0
OP_INSERT = 1

# MixedWorkloadStream record tags / read kinds (the kind strings match
# repro_torch.service.api's query-kind constants so records convert 1:1
# into QueryRequests without this data layer importing the service layer)
READ = "r"
WRITE = "w"
KIND_COMMUNITY = "community"
KIND_MAX_K = "max_k"
KIND_MEMBERS = "members"
KIND_REPRESENTATIVES = "representatives"


def make_update_stream(edges: np.ndarray, n_nodes: int, n_updates: int,
                       insert_frac: float = 0.5, seed: int = 0) -> np.ndarray:
    """[U, 3] rows (op, a, b).  Deletions pick existing edges; insertions pick
    absent pairs; the evolving edge set is tracked so the stream is valid
    when applied in order (mirrors the paper's experimental protocol)."""
    rng = np.random.default_rng(seed)
    present = {(int(u), int(v)) for u, v in edges}
    out = []
    for _ in range(n_updates):
        do_insert = rng.random() < insert_frac or not present
        if do_insert:
            while True:
                a, b = rng.integers(0, n_nodes, size=2)
                a, b = int(min(a, b)), int(max(a, b))
                if a != b and (a, b) not in present:
                    break
            present.add((a, b))
            out.append((OP_INSERT, a, b))
        else:
            idx = rng.integers(len(present))
            e = list(present)[idx]
            present.discard(e)
            out.append((OP_DELETE, e[0], e[1]))
    return np.asarray(out, np.int64)


class _Present:
    """The evolving present-edge set, with its sorted order kept beside it
    (built at the first delete, then updated by bisection) so a delete's
    ``sorted(present)[i]`` costs no sort."""

    def __init__(self, pairs):
        self.set = set(pairs)
        self._sorted: list | None = None

    def __len__(self) -> int:
        return len(self.set)

    def __contains__(self, e) -> bool:
        return e in self.set

    def add(self, e):
        self.set.add(e)
        if self._sorted is not None:
            bisect.insort(self._sorted, e)

    def pop_sorted(self, i: int) -> tuple[int, int]:
        """Remove and return the ``i``-th edge in sorted order."""
        if self._sorted is None:
            self._sorted = sorted(self.set)
        e = self._sorted.pop(i)
        self.set.discard(e)
        return e


def _sample_insert(rng, present: _Present, n_nodes: int) -> tuple[int, int]:
    """Rejection-sample an absent, non-loop edge and add it to ``present``."""
    while True:
        a, b = rng.integers(0, n_nodes, size=2)
        a, b = int(min(a, b)), int(max(a, b))
        if a != b and (a, b) not in present:
            present.add((a, b))
            return a, b


def _sample_delete(rng, present: _Present) -> tuple[int, int]:
    """Pick a present edge (sorted order for determinism) and remove it."""
    return present.pop_sorted(int(rng.integers(len(present))))


def _present_state(seed: int, step: int, present: _Present) -> dict:
    """Resumable stream state: the rng is keyed by (seed, step) per chunk,
    and the evolving present-edge set is captured explicitly so restore
    needs no replay."""
    arr = np.asarray(sorted(present.set), np.int64).reshape(-1, 2)
    return {"seed": seed, "step": step, "present": arr}


def _load_present(state) -> _Present:
    return _Present((int(u), int(v))
                    for u, v in np.asarray(state["present"]).reshape(-1, 2))


def iter_batches(stream: np.ndarray, batch_size: int):
    """Yield consecutive ``[<=B, 3]`` chunks of an update stream, in order.

    The fused engine (``DynamicGraph.apply_batch``) consumes one chunk per
    call; yielding views keeps every approach on the identical stream."""
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    for s in range(0, len(stream), batch_size):
        yield stream[s:s + batch_size]


class GraphUpdateStream:
    """Resumable insert/delete stream (the ``serve_truss`` drive loop's)."""

    def __init__(self, edges: np.ndarray, n_nodes: int, chunk: int = 16,
                 insert_frac: float = 0.5, seed: int = 0, step: int = 0):
        self.edges = edges
        self.n = n_nodes
        self.chunk = chunk
        self.insert_frac = insert_frac
        self.seed = seed
        self.step = step
        self._present = _Present((int(u), int(v)) for u, v in edges)

    def next(self) -> np.ndarray:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        out = []
        for _ in range(self.chunk):
            if rng.random() < self.insert_frac or not self._present:
                a, b = _sample_insert(rng, self._present, self.n)
                out.append((OP_INSERT, a, b))
            else:
                a, b = _sample_delete(rng, self._present)
                out.append((OP_DELETE, a, b))
        return np.asarray(out, np.int64)

    def state_dict(self):
        return _present_state(self.seed, self.step, self._present)

    def load_state_dict(self, state):
        """Restore so the next ``next()`` yields the chunk the saved stream
        would have yielded.  Legacy two-key dicts (no ``present``) are
        fast-forwarded deterministically: chunks 0..step-1 are regenerated
        from the constructor edge set to rebuild the present set."""
        seed, step = int(state["seed"]), int(state["step"])
        if "present" in state:
            self.seed, self.step = seed, step
            self._present = _load_present(state)
            return self
        self.seed, self.step = seed, 0
        self._present = _Present((int(u), int(v)) for u, v in self.edges)
        while self.step < step:
            self.next()
        return self


class MixedWorkloadStream:
    """Mixed read/write serving workload with zipfian query keys.

    Models the traffic a replicated community-search service sees: mostly
    point reads whose seed nodes follow a zipf(``zipf_s``) rank distribution
    over node ids (hot communities absorb most queries — exactly the
    locality a read-replica tier exploits), interleaved with valid
    insert/delete writes maintained the same way ``GraphUpdateStream``
    maintains its evolving present-edge set.  Each ``next()`` yields one
    chunk of records::

        (WRITE, op, a, b)      op in {OP_INSERT, OP_DELETE}
        (READ, kind, k, a, b)  kind in {community, max_k, members,
                               representatives}; a/b are zipf node keys
                               (a = community seed; (a, b) = max_k edge;
                               -1 when the kind takes no key)

    The read mix is point-lookup heavy (~60% community, ~30% max_k) with an
    occasional full-enumeration read (representatives/members).  The rng is
    keyed by ``(seed, step)`` per chunk, so two instances with the same
    parameters produce the identical workload."""

    def __init__(self, edges: np.ndarray, n_nodes: int, chunk: int = 32,
                 read_frac: float = 0.9, zipf_s: float = 1.1,
                 ks: tuple[int, ...] = (3, 4), insert_frac: float = 0.5,
                 seed: int = 0, step: int = 0):
        self.n = n_nodes
        self.chunk = chunk
        self.read_frac = read_frac
        self.zipf_s = zipf_s
        self.ks = tuple(int(k) for k in ks)
        self.insert_frac = insert_frac
        self.seed = seed
        self.step = step
        ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
        p = ranks ** -float(zipf_s)
        self._p = p / p.sum()   # node id == popularity rank
        # Generator.choice(n, p=p)'s own table: cumsum, then over its last
        self._cdf = self._p.cumsum()
        self._cdf /= self._cdf[-1]
        self._present = _Present((int(u), int(v)) for u, v in edges)

    def _zipf_node(self, rng) -> int:
        return int(self._cdf.searchsorted(rng.random(), side="right"))

    def next(self) -> list[tuple]:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        out: list[tuple] = []
        for _ in range(self.chunk):
            if rng.random() < self.read_frac:
                k = self.ks[rng.integers(len(self.ks))]
                r = rng.random()
                if r < 0.6:
                    out.append((READ, KIND_COMMUNITY, k,
                                self._zipf_node(rng), -1))
                elif r < 0.9:
                    a = self._zipf_node(rng)
                    b = self._zipf_node(rng)
                    while b == a:
                        b = self._zipf_node(rng)
                    out.append((READ, KIND_MAX_K, k, a, b))
                elif r < 0.97:
                    out.append((READ, KIND_REPRESENTATIVES, k, -1, -1))
                else:
                    out.append((READ, KIND_MEMBERS, k, -1, -1))
            elif rng.random() < self.insert_frac or not self._present:
                a, b = _sample_insert(rng, self._present, self.n)
                out.append((WRITE, OP_INSERT, a, b))
            else:
                a, b = _sample_delete(rng, self._present)
                out.append((WRITE, OP_DELETE, a, b))
        return out

    def state_dict(self):
        return _present_state(self.seed, self.step, self._present)

    def load_state_dict(self, state):
        self.seed, self.step = int(state["seed"]), int(state["step"])
        self._present = _load_present(state)
        return self
