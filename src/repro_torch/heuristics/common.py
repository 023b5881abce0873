"""Shared machinery for large-query heuristics (paper §4).

The port of ``repro.heuristics.common``.  ``UnitGraph`` is the working
graph every heuristic operates on: its nodes ("units") are either base
relations or *temp tables* (already-optimized composite sub-plans, the IDP2
materialization device).  Node cardinalities and aggregated inter-unit
selectivities are kept in log2 space, so a unit graph built from units is
*exactly* consistent with the base graph: rows(union of units) == sum of
unit log2-cards + crossing selectivities.

Every value keeps the reference's type (Python floats for unit rows and
aggregated selectivities, f32 only where ``JoinGraph.from_log2`` casts)
and every sum its order, so each exact subproblem the heuristics carve out
has the reference's stats bit for bit.

Heuristics return plans over base relations (composites expanded), and
every result is canonically re-costed bottom-up on the base graph so that
plan quality is comparable across techniques (Table 1/2 methodology).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..core import bitset as bs
from ..core import conflicts as cf
from ..core.joingraph import JoinGraph
from ..core.plan import Plan, cost_plan, join_plans, leaf_plan


@dataclasses.dataclass
class Unit:
    rel_set: int                 # bitmap over BASE relations (python int)
    rows_log2: float
    plan: Plan                   # plan over base relations for this unit


def base_units(g: JoinGraph) -> list[Unit]:
    return [Unit(rel_set=1 << v, rows_log2=float(g.log2_card[v]),
                 plan=leaf_plan(v, g)) for v in range(g.n)]


class UnitGraph:
    """Mutable graph over units with aggregated log2 selectivities."""

    def __init__(self, g: JoinGraph, units: Optional[list[Unit]] = None):
        self.base = g
        self.units = units if units is not None else base_units(g)
        self._rebuild_edges()

    def _rebuild_edges(self):
        g = self.base
        idx_of = {}
        for i, u in enumerate(self.units):
            for v in bs.iter_bits(u.rel_set):
                idx_of[v] = i
        agg: dict[tuple[int, int], float] = {}
        for (a, b), s in zip(g.edges, g.log2_sel):
            ia, ib = idx_of[a], idx_of[b]
            if ia == ib:
                continue
            key = (min(ia, ib), max(ia, ib))
            agg[key] = agg.get(key, 0.0) + float(s)
        self.edges = sorted(agg.keys())
        self.sel_l2 = {e: agg[e] for e in self.edges}

    @property
    def n(self) -> int:
        return len(self.units)

    def index_of(self, unit: Unit) -> int:
        """Current slot of ``unit`` (by identity — merges reindex units)."""
        for j, u in enumerate(self.units):
            if u is unit:
                return j
        raise ValueError("unit is not in this UnitGraph")

    def neighbors(self, i: int) -> list[int]:
        out = []
        for (a, b) in self.edges:
            if a == i:
                out.append(b)
            elif b == i:
                out.append(a)
        return out

    def join_rows_log2(self, i: int, j: int) -> float:
        s = self.units[i].rows_log2 + self.units[j].rows_log2
        key = (min(i, j), max(i, j))
        s += self.sel_l2.get(key, 0.0)
        return max(s, 0.0)

    def union_rows_log2(self, idxs: list[int]) -> float:
        s = sum(self.units[i].rows_log2 for i in idxs)
        ii = set(idxs)
        for (a, b) in self.edges:
            if a in ii and b in ii:
                s += self.sel_l2[(a, b)]
        return max(s, 0.0)

    def merge(self, idxs: list[int], plan: Plan) -> None:
        """Replace units ``idxs`` by one composite unit with the given plan."""
        rel = 0
        for i in idxs:
            rel |= self.units[i].rel_set
        rows = self.union_rows_log2(idxs)
        keep = [u for k, u in enumerate(self.units) if k not in set(idxs)]
        keep.append(Unit(rel_set=rel, rows_log2=rows, plan=plan))
        self.units = keep
        self._rebuild_edges()

    def sel_adjacency(self) -> dict[int, dict[int, float]]:
        """Aggregated log2 selectivities as a dict-of-dicts adjacency:
        ``adj[i][j]`` is the summed log2 selectivity of every base edge
        crossing units ``i`` and ``j``.  The cost-aware partitioner mutates
        a copy of this structure while union-find merges collapse it."""
        adj: dict[int, dict[int, float]] = {i: {} for i in range(self.n)}
        for (a, b), s in self.sel_l2.items():
            adj[a][b] = s
            adj[b][a] = s
        return adj

    def rel_ids(self, idxs: list[int]) -> list[int]:
        """Sorted base-relation ids covered by units ``idxs`` (for explain
        output: partition boundaries in base-graph vocabulary)."""
        rel = 0
        for i in idxs:
            rel |= self.units[i].rel_set
        return list(bs.iter_bits(rel))

    def as_joingraph(self, idxs: Optional[list[int]] = None):
        """JoinGraph over (a subset of) units, for exact-DP subcalls.
        Returns (graph, unit index list)."""
        if idxs is None:
            idxs = list(range(self.n))
        lmap = {g: l for l, g in enumerate(idxs)}
        ed, sl = [], []
        for (a, b) in self.edges:
            if a in lmap and b in lmap:
                ed.append((lmap[a], lmap[b]))
                sl.append(self.sel_l2[(a, b)])
        jg = JoinGraph.from_log2(
            n=len(idxs), edges=ed,
            cards_l2=[self.units[i].rows_log2 for i in idxs],
            sels_l2=sl)
        return jg, idxs


def expand_unit_plan(p: Plan, units: list[Unit], g: JoinGraph) -> Plan:
    """Substitute unit leaves by their underlying base-relation plans and
    re-cost canonically on the base graph."""

    def rec(node: Plan) -> Plan:
        if node.is_leaf:
            return units[node.relations()[0]].plan
        l = rec(node.left)
        r = rec(node.right)
        return join_plans(l, r, g)

    return cost_plan(rec(p), g)


def _inner_component_plan(g: JoinGraph, vset: int, inner_solve) -> Plan:
    """Solve one inner-only component of a typed graph with the heuristic's
    own machinery (``inner_solve`` maps an inner JoinGraph to a Plan over its
    local ids) and expand back to base-relation vocabulary."""
    verts = list(bs.iter_bits(vset))
    if len(verts) == 1:
        return leaf_plan(verts[0], g)
    lmap = {v: l for l, v in enumerate(verts)}
    ed, sl = [], []
    for (a, b), s in zip(g.edges, g.log2_sel):
        if a in lmap and b in lmap:
            ed.append((lmap[a], lmap[b]))
            sl.append(float(s))
    jg = JoinGraph.from_log2(
        n=len(verts), edges=ed,
        cards_l2=[float(g.log2_card[v]) for v in verts],
        sels_l2=sl,
        names=tuple(g.names[v] for v in verts))
    units = [Unit(rel_set=1 << v, rows_log2=float(g.log2_card[v]),
                  plan=leaf_plan(v, g)) for v in verts]
    return expand_unit_plan(inner_solve(jg), units, g)


def solve_typed(g: JoinGraph, inner_solve: Callable) -> Plan:
    """Typed-join decomposition shared by the heuristics (GOO/IDP2/UnionDP).

    Non-inner edges are bridges (``conflicts.analyze`` rejects anything
    else), so cutting them splits the query into inner-only components where
    all the reordering freedom lives.  The conservative TES rule admits
    exactly one shape across each bridge: the whole non-preserved side as
    the RIGHT operand and any superset of the preserved endpoint as the
    LEFT (either orientation for FULL, and a complete side is valid there
    too).  Recursing on the two sides of each bridge and stitching with
    ``join_plans`` — preserved side left — therefore yields a conflict-valid
    tree *by construction*; the inner components go through ``inner_solve``
    (the heuristic's normal path, including its batched exact subcalls).
    The result is re-costed canonically on the base typed graph, so plan
    quality stays comparable across techniques."""

    def reach(start: int, ei: int, vset: int) -> int:
        seen = 1 << start
        frontier = [start]
        while frontier:
            x = frontier.pop()
            for j, (a, b) in enumerate(g.edges):
                if j == ei or not ((vset >> a) & 1 and (vset >> b) & 1):
                    continue
                y = b if a == x else (a if b == x else -1)
                if y >= 0 and not (seen >> y) & 1:
                    seen |= 1 << y
                    frontier.append(y)
        return seen

    def need(i: int) -> int:
        # vertices that must be fully assembled before edge i fires
        # (its right TES; both sides for FULL) — _check_feasible's relation
        return g.tes_r[i] | (g.tes_l[i] if g.kind(i) == cf.KIND_FULL else 0)

    def rec(vset: int) -> Plan:
        cand = [i for i, (a, b) in enumerate(g.edges)
                if (vset >> a) & 1 and (vset >> b) & 1
                and g.kind(i) != cf.KIND_INNER]
        if not cand:
            return _inner_component_plan(g, vset, inner_solve)
        # topmost join = the LAST edge in the Kahn firing order: its TES
        # lies inside vset and no other pending edge's need contains it
        # (an edge inside need(j) must fire before j, so it cannot be top).
        # analyze()'s feasibility check guarantees a maximal edge exists.
        ni = next(
            i for i in cand
            if need(i) & ~vset == 0
            and not any(j != i and (need(j) >> a) & 1 and (need(j) >> b) & 1
                        for j in cand
                        for a, b in [g.edges[i]]))
        l = g.left_op(ni)
        a, b = g.edges[ni]
        r = b if l == a else a
        rset = reach(r, ni, vset)
        return join_plans(rec(vset & ~rset), rec(rset), g)

    return cost_plan(rec(g.full_set), g)


def exact_subsolver(algorithm: str = "mpdp", device=None) -> Callable:
    """A subsolver that runs the port's exact ``engine.optimize`` on
    ``device`` (``cuda`` unless the caller names another)."""
    from ..core import engine

    def solve(jg: JoinGraph) -> Plan:
        if jg.n == 1:
            return leaf_plan(0, jg)
        return engine.optimize(jg, algorithm, device=device).plan

    return solve
