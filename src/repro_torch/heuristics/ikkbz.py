"""IKKBZ (Ibaraki-Kameda / Krishnamurthy-Boral-Zaniolo) — optimal left-deep
order for tree queries under an ASI cost function (C_out), paper §6/§7.3.

The port of ``repro.heuristics.ikkbz``, host only.  Cyclic graphs are
first reduced to their most-selective spanning tree (the LinDP
convention).  All T/C bookkeeping is in log2 space so 1000-relation chains
cannot overflow: C(S1 S2) = C1 + T1*C2 becomes logaddexp2.  For n >
ROOT_SAMPLE roots we sample candidate roots (documented deviation; the
classic algorithm tries all n roots in O(n^2) each).
"""
from __future__ import annotations

import time

import numpy as np

from ..core import cost as cm
from ..core.joingraph import JoinGraph
from ..core.plan import Counters, OptimizeResult, cost_plan, join_plans, leaf_plan

ROOT_SAMPLE = 32
_NEG = -1e30


def _logadd2(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if a <= _NEG:
        return _NEG
    return a + float(np.log2(1.0 + 2.0 ** (b - a)))


def _rank_l2(t_l2: float, c_l2: float) -> float:
    """log2 of (T-1)/C, stable near T=1."""
    if t_l2 <= 0.0:
        return _NEG  # T <= 1: rank <= 0 — joins that shrink go first
    if t_l2 > 30.0:
        tm1 = t_l2
    else:
        tm1 = float(np.log2(max(2.0 ** t_l2 - 1.0, 1e-300)))
    return tm1 - c_l2


class _Seq:
    """Chain element: (possibly compound) sequence of relations."""

    __slots__ = ("rels", "t_l2", "c_l2")

    def __init__(self, rels, t_l2, c_l2):
        self.rels = rels
        self.t_l2 = t_l2
        self.c_l2 = c_l2

    @property
    def rank(self):
        return _rank_l2(self.t_l2, self.c_l2)

    def concat(self, other: "_Seq") -> "_Seq":
        return _Seq(self.rels + other.rels,
                    self.t_l2 + other.t_l2,
                    _logadd2(self.c_l2, self.t_l2 + other.c_l2))


def spanning_tree(g: JoinGraph) -> list[tuple[int, int, float]]:
    """Most-selective spanning tree (Kruskal on ascending log2 sel)."""
    order = sorted(range(g.m), key=lambda i: g.log2_sel[i])
    parent = list(range(g.n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    out = []
    for i in order:
        u, v = g.edges[i]
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            out.append((u, v, float(g.log2_sel[i])))
    return out


def _linearize(g: JoinGraph, tree, root: int) -> list[int]:
    """IKKBZ chain for one root (returns relation order)."""
    children: dict[int, list[int]] = {v: [] for v in range(g.n)}
    sel_to_parent = {root: 0.0}
    adj: dict[int, list[tuple[int, float]]] = {v: [] for v in range(g.n)}
    for (u, v, s) in tree:
        adj[u].append((v, s))
        adj[v].append((u, s))
    seen = {root}
    stack = [root]
    order = []
    while stack:
        x = stack.pop()
        order.append(x)
        for (y, s) in adj[x]:
            if y not in seen:
                seen.add(y)
                children[x].append(y)
                sel_to_parent[y] = s
                stack.append(y)

    # chains[v]: the normalized chain of the subtree rooted at v (list of _Seq)
    chains: dict[int, list[_Seq]] = {}

    def norm(chain: list[_Seq]) -> list[_Seq]:
        out: list[_Seq] = []
        for s in chain:
            out.append(s)
            while len(out) >= 2 and out[-2].rank > out[-1].rank:
                b = out.pop()
                a = out.pop()
                out.append(a.concat(b))
        return out

    for v in reversed(order):          # leaves first
        n_l2 = sel_to_parent[v] + float(g.log2_card[v])
        head = _Seq((v,), n_l2, n_l2)
        # children are already normalized (rank-ascending) chains: merge by
        # rank, prepend the parent, re-normalize (compounds fix precedence)
        merged = sorted((x for c in children[v] for x in chains[c]),
                        key=lambda s: s.rank)
        chains[v] = norm([head] + merged)

    seq: list[int] = []
    for s in chains[root]:
        seq.extend(s.rels)
    return seq


def _cout_l2(g: JoinGraph, order: list[int]) -> float:
    """log2 of the sum of intermediate cardinalities (C_out)."""
    s = 0
    total = _NEG
    rows = 0.0
    for v in order:
        prev = s
        s |= 1 << v
        rows = float(cm.np_rows_log2(s, g))
        if prev:
            total = _logadd2(total, rows)
    return total


def best_order(g: JoinGraph) -> list[int]:
    tree = spanning_tree(g)
    if g.n > ROOT_SAMPLE:
        by_card = np.argsort(g.log2_card)
        roots = sorted(set(int(x) for x in
                           list(by_card[: ROOT_SAMPLE // 2]) +
                           list(by_card[-ROOT_SAMPLE // 2:])))
    else:
        roots = list(range(g.n))
    best, best_c = None, None
    for r in roots:
        order = _linearize(g, tree, r)
        c = _cout_l2(g, order)
        if best is None or c < best_c:
            best, best_c = order, c
    return best


def solve(g: JoinGraph) -> OptimizeResult:
    t0 = time.perf_counter()
    order = best_order(g)
    p = leaf_plan(order[0], g)
    for v in order[1:]:
        p = join_plans(p, leaf_plan(v, g), g)
    p = cost_plan(p, g)
    return OptimizeResult(plan=p, cost=p.cost, counters=Counters(),
                          algorithm="ikkbz", wall_s=time.perf_counter() - t0)
