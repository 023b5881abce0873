"""Exact join ordering by dynamic programming over csg-cmp pairs.

For a connected inner-join query the optimal bushy plan joins, at every
node, a connected relation set ``L`` with a connected, disjoint, adjacent
set ``R``.  This module enumerates exactly those pairs, level by level in
NumPy, and keeps for each connected set the cheapest split:

1. the connected sets, grown one neighbour at a time from the singletons;
2. the unordered pairs (the lowest relation of ``L | R`` lies in ``L``),
   each ``R`` grown from one neighbour of ``L`` through its own
   neighbours outside ``L``;
3. by increasing ``|L | R|``: ``cost(S) = min cost(L) + cost(R) +
   join(rows(L), rows(R), rows(S))``.

The join cost is symmetric in its operands, so one orientation a pair
suffices.  Costs are in the precision given (``costmodel.F64`` for the
reference).  The plan comes back as nested ``[left, right]`` lists over
leaf bitmaps.
"""
from __future__ import annotations

import numpy as np

from .costmodel import F64, Precision


def adjacency(wire: dict) -> np.ndarray:
    adj = np.zeros(wire["n"], np.int64)
    for u, v in wire["edges"]:
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    return adj


def neighbours(sets: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """Union of the neighbours of each set, outside the set."""
    nb = np.zeros_like(sets)
    for v in range(len(adj)):
        nb |= np.where((sets >> v) & 1 == 1, adj[v], 0)
    return nb & ~sets


def connected_sets(adj: np.ndarray) -> list[np.ndarray]:
    """Sorted connected sets of each size 1..n (index k - 1)."""
    n = len(adj)
    levels = [np.array([1 << v for v in range(n)], np.int64)]
    for _ in range(2, n + 1):
        cur = levels[-1]
        nb = neighbours(cur, adj)
        grown = [cur[(nb >> v) & 1 == 1] | (1 << v) for v in range(n)]
        levels.append(np.unique(np.concatenate(grown)))
    return levels


def ccp_pairs(adj: np.ndarray, sets: np.ndarray):
    """Every unordered csg-cmp pair (L, R) over the connected ``sets``,
    with the lowest relation of ``L | R`` in ``L``."""
    n = len(adj)
    low = sets & -sets
    nb = neighbours(sets, adj)
    cl, cr = [], []
    for v in range(n):
        m = ((nb >> v) & 1 == 1) & ((1 << v) > low)
        cl.append(sets[m])
        cr.append(np.full(int(m.sum()), 1 << v, np.int64))
    cur_l, cur_r = np.concatenate(cl), np.concatenate(cr)
    out_l, out_r = [cur_l], [cur_r]
    while len(cur_l):
        nb = neighbours(cur_r, adj) & ~cur_l
        low = cur_l & -cur_l
        cl, cr = [], []
        for v in range(n):
            m = ((nb >> v) & 1 == 1) & ((1 << v) > low)
            cl.append(cur_l[m])
            cr.append(cur_r[m] | (1 << v))
        key = np.unique((np.concatenate(cl) << 32) | np.concatenate(cr))
        cur_l, cur_r = key >> 32, key & 0xFFFFFFFF
        out_l.append(cur_l)
        out_r.append(cur_r)
    return np.concatenate(out_l), np.concatenate(out_r)


def popcount(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.int64)
    c = np.zeros(x.shape, np.int64)
    while np.any(x):
        c += x & 1
        x = x >> 1
    return c


def solve(wire: dict, prec: Precision = F64):
    """(optimal cost, plan) of a connected inner-join query."""
    n = wire["n"]
    if wire.get("kinds"):
        raise ValueError("the reference orders inner joins only")
    if n > 30:
        raise ValueError(f"exact DP over {n} relations is out of reach")
    adj = adjacency(wire)
    levels = connected_sets(adj)
    sets = np.concatenate(levels)
    order = np.argsort(sets)
    sets = sets[order]
    if sets[-1] != (1 << n) - 1:
        raise ValueError("the query graph is disconnected")
    rows = prec.rows_l2(sets, wire)
    cost = np.full(len(sets), np.inf, prec.dtype)
    left = np.zeros(len(sets), np.int64)
    single = popcount(sets) == 1
    cost[single] = prec.scan_cost(rows[single])
    if n == 1:
        return float(cost[0]), int(sets[0])
    pl, pr = ccp_pairs(adj, sets)
    ps = pl | pr
    size = popcount(ps)
    by_size = np.argsort(size, kind="stable")
    bounds = np.searchsorted(size[by_size], np.arange(2, n + 2))
    for k in range(2, n + 1):
        sel = by_size[bounds[k - 2]: bounds[k - 1]]
        if not len(sel):
            continue
        il = np.searchsorted(sets, pl[sel])
        ir = np.searchsorted(sets, pr[sel])
        iS = np.searchsorted(sets, ps[sel])
        jc = prec.join_cost(rows[il], rows[ir], rows[iS])
        cand = prec.r(prec.r(cost[il] + cost[ir]) + jc)
        o = np.lexsort((cand, iS))
        first = np.ones(len(o), bool)
        first[1:] = iS[o][1:] != iS[o][:-1]
        best = o[first]
        cost[iS[best]] = cand[best]
        left[iS[best]] = pl[sel][best]
    return float(cost[-1]), _extract(sets, left, (1 << n) - 1)


def _extract(sets: np.ndarray, left: np.ndarray, s: int):
    if s & (s - 1) == 0:
        return int(s)
    lb = int(left[np.searchsorted(sets, s)])
    if lb == 0 or lb & s != lb:
        raise RuntimeError(f"no split recorded for set {s:#x}")
    return [_extract(sets, left, lb), _extract(sets, left, s & ~lb)]
