"""GOO — Greedy Operator Ordering (Fegaras '98; paper §6/§7.3 baseline).

The port of ``repro.heuristics.goo``, host only.  Repeatedly joins the
connected unit pair with the smallest resulting cardinality until one unit
remains.  It is the quality baseline UnionDP is held against, the IDP2
seed-plan builder, one of the two seed trees of UnionDP's re-optimization
passes, and the opt-in ``goo_floor`` of ``uniondp.solve``.
"""
from __future__ import annotations

import time

from ..core.joingraph import JoinGraph
from ..core.plan import Counters, OptimizeResult, join_plans
from .common import UnitGraph, cost_plan


def goo_plan(ug: UnitGraph):
    """Run GOO on a UnitGraph in place; returns the final single unit."""
    while ug.n > 1:
        if not ug.edges:
            raise ValueError("disconnected unit graph (cross product needed)")
        best, best_rows = None, None
        for (a, b) in ug.edges:
            r = ug.join_rows_log2(a, b)
            if best is None or r < best_rows:
                best, best_rows = (a, b), r
        a, b = best
        p = join_plans(ug.units[a].plan, ug.units[b].plan, ug.base)
        ug.merge([a, b], p)
    return ug.units[0]


def solve(g: JoinGraph) -> OptimizeResult:
    t0 = time.perf_counter()
    if g.typed:
        # non-inner bridges pin the join shape across components; GOO orders
        # the inner components, the shared decomposition stitches validly
        from .common import solve_typed
        p = solve_typed(g, lambda jg: solve(jg).plan)
        return OptimizeResult(plan=p, cost=p.cost, counters=Counters(),
                              algorithm="goo",
                              wall_s=time.perf_counter() - t0)
    ug = UnitGraph(g)
    u = goo_plan(ug)
    p = cost_plan(u.plan, g)
    return OptimizeResult(plan=p, cost=p.cost, counters=Counters(),
                          algorithm="goo", wall_s=time.perf_counter() - t0)
