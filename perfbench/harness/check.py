"""How ``correct`` is decided, the part every kind of cell shares: samples
drawn from the seed, and the verdict of the numbers a cell's
``limits/<cell>.json`` names.

A kind's check (``kinds/<kind>.py``) holds what the timed calls produced
to the plain reference once the window has closed and gives per-item
readings (a list a reading, one entry a compared row, position or
session).  The limits file names each number compared: the reading it
reduces (``of``), the statistic (``stat``: ``max``, ``median`` or
``mean``) and its ``limit``.  A run is correct where every number is at or
under its limit; the items over a number's limit are counted beside it.
"""
from __future__ import annotations

import numpy as np

from .model import sub_seed

STATS = {"max": np.max, "median": np.median, "mean": np.mean}


def sample_rows(items: list, k: int, seed: int) -> list:
    """``k`` (request, row) pairs of a window's rows: one of the longest,
    then as many from the first half of their requests' rows as from the
    second."""
    rows = [(c, r) for c, it in enumerate(items) for r in range(it.rows)]
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    longest = max(items[c].length for c, _ in rows)
    first = [x for x in rows if items[x[0]].length == longest]
    pick = [first[rng.integers(len(first))]]
    halves = [[x for x in rows if x != pick[0]
               and (x[1] < items[x[0]].rows / 2) == low] for low in (True, False)]
    high = pick[0][1] >= items[pick[0][0]].rows / 2
    want = [(k - 1 + high) // 2, (k - high) // 2]
    for half, n in zip(halves, want):
        idx = rng.choice(len(half), size=min(n, len(half)), replace=False)
        pick += [half[i] for i in sorted(idx)]
    return pick


def sample_sessions(batch: int, k: int, seed: int) -> list:
    """``k`` sessions, half from each half of the batch."""
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    half = batch // 2
    lo = rng.choice(half, size=min(k // 2, half), replace=False)
    hi = half + rng.choice(batch - half, size=min(k - len(lo), batch - half),
                           replace=False)
    return sorted(int(s) for s in np.concatenate([lo, hi]))


def numbers(items: dict, spec: dict) -> dict:
    """``{name: (number, limit, items over the limit, items)}`` of the
    numbers ``spec`` (a limits file's ``numbers``) names."""
    out = {}
    for name, n in spec.items():
        per = items[n["of"]]
        value = float(STATS[n["stat"]](per)) if len(per) else float("nan")
        out[name] = (value, n["limit"], sum(not x <= n["limit"] for x in per), len(per))
    return out


def verdict(items: dict, spec: dict) -> tuple:
    """(correct, ``numbers(items, spec)``)."""
    table = numbers(items, spec)
    return all(v <= lim for v, lim, _, _ in table.values()), table
