"""LinDP (Neumann & Radke, SIGMOD'18) — linearized DP, paper §6/§7.3 baseline.

The port of ``repro.heuristics.lindp``, host only.  IKKBZ produces a
linear order; a polynomial interval DP then finds the best *bushy* plan
consistent with that order.  Interval split loops are numpy-vectorized;
connectivity is handled by INF-poisoning (within a connected interval, any
split into two connected halves necessarily has a cross edge).  Native cap
LINDP_CAP relations; above that the paper's adaptive scheme runs LinDP
inside IDP2 (``idp.solve(..., subsolver="lindp")``).
"""
from __future__ import annotations

import time

import numpy as np

from ..core import cost as cm
from ..core.joingraph import JoinGraph
from ..core.plan import Counters, OptimizeResult, cost_plan, join_plans, leaf_plan
from . import ikkbz

LINDP_CAP = 400
INF = np.float32(np.inf)


def _interval_tables(g: JoinGraph, order: list[int]):
    """rows_l2[i, j] and connected[i, j] for intervals of the linear order."""
    n = g.n
    pos = {r: i for i, r in enumerate(order)}
    # edges in position space
    eposs = [(min(pos[u], pos[v]), max(pos[u], pos[v]), float(s))
             for (u, v), s in zip(g.edges, g.log2_sel)]
    by_right: dict[int, list[tuple[int, float]]] = {}
    for (a, b, s) in eposs:
        by_right.setdefault(b, []).append((a, s))

    rows = np.zeros((n, n), np.float32)
    conn = np.zeros((n, n), bool)
    for i in range(n):
        # union-find over positions i..j as j grows
        parent = list(range(n))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        comps = 0
        acc = 0.0
        for j in range(i, n):
            acc += float(g.log2_card[order[j]])
            comps += 1
            for (a, s) in by_right.get(j, ()):
                if a >= i:
                    acc += s
                    ra, rj = find(a), find(j)
                    if ra != rj:
                        parent[ra] = rj
                        comps -= 1
            rows[i, j] = max(acc, 0.0)
            conn[i, j] = comps == 1
    return rows, conn


def dp_over_order(g: JoinGraph, order: list[int]):
    n = g.n
    rows, conn = _interval_tables(g, order)
    cost = np.full((n, n), INF, np.float32)
    split = np.full((n, n), -1, np.int32)
    for i in range(n):
        cost[i, i] = cm.np_scan_cost(np.float32(g.log2_card[order[i]]))
    for L in range(2, n + 1):
        for i in range(0, n - L + 1):
            j = i + L - 1
            if not conn[i, j]:
                continue
            ks = np.arange(i, j)
            cl = cost[i, ks]
            rr = cost[ks + 1, j]
            jc = cm.np_join_cost(rows[i, ks], rows[ks + 1, j],
                                 np.float32(rows[i, j]))
            cand = cl + rr + jc
            k = int(np.argmin(cand))
            if np.isfinite(cand[k]):
                cost[i, j] = cand[k]
                split[i, j] = i + k

    def build(i, j):
        if i == j:
            return leaf_plan(order[i], g)
        k = int(split[i, j])
        assert k >= 0, "no plan for connected interval?"
        return join_plans(build(i, k), build(k + 1, j), g)

    return build(0, n - 1), float(cost[0, n - 1])


def solve(g: JoinGraph) -> OptimizeResult:
    t0 = time.perf_counter()
    if g.n > LINDP_CAP:
        from . import idp
        r = idp.solve(g, k=100, subsolver="lindp")
        r.algorithm = "lindp_adaptive"
        return r
    order = ikkbz.best_order(g)
    p, _ = dp_over_order(g, order)
    p = cost_plan(p, g)
    return OptimizeResult(plan=p, cost=p.cost, counters=Counters(),
                          algorithm="lindp", wall_s=time.perf_counter() - t0)
