"""Join plan trees, enumeration counters, plan validation and host costing."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import bitset as bs
from . import conflicts as cf
from . import cost as cm


@dataclasses.dataclass
class Counters:
    """Paper §2.1: EvaluatedCounter vs CCP-Counter (symmetric pairs included)."""

    evaluated: int = 0
    ccp: int = 0

    def __iadd__(self, other: "Counters"):
        self.evaluated += other.evaluated
        self.ccp += other.ccp
        return self


@dataclasses.dataclass
class Plan:
    """Bushy join tree node.  Leaf iff left is None."""

    rel_set: int                       # bitmap over graph-local relation ids
    cost: float
    rows_log2: float
    left: Optional["Plan"] = None
    right: Optional["Plan"] = None

    @property
    def is_leaf(self) -> bool:
        return self.left is None

    def relations(self) -> list[int]:
        return list(bs.iter_bits(self.rel_set))

    def depth(self) -> int:
        if self.is_leaf:
            return 1
        return 1 + max(self.left.depth(), self.right.depth())

    def n_joins(self) -> int:
        if self.is_leaf:
            return 0
        return 1 + self.left.n_joins() + self.right.n_joins()

    def pretty(self, names=None, indent=0) -> str:
        pad = "  " * indent
        if self.is_leaf:
            v = self.relations()[0]
            nm = names[v] if names else f"R{v}"
            return f"{pad}{nm} (rows~2^{self.rows_log2:.1f})"
        hdr = (f"{pad}JOIN cost={self.cost:.4g} rows~2^{self.rows_log2:.1f} "
               f"set={self.rel_set:#x}")
        return "\n".join([hdr,
                          self.left.pretty(names, indent + 1),
                          self.right.pretty(names, indent + 1)])


@dataclasses.dataclass
class OptimizeResult:
    plan: Plan
    cost: float
    counters: Counters
    algorithm: str
    wall_s: float = 0.0
    levels: int = 0
    timings: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)


def leaf_plan(v: int, g) -> Plan:
    rl2 = float(g.log2_card[v])
    return Plan(rel_set=1 << v, cost=float(cm.np_scan_cost(rl2)), rows_log2=rl2)


def join_plans(l: Plan, r: Plan, g) -> Plan:
    """Host-side join of two plans under the shared cost model (``l`` is
    the LEFT operand: typed graphs cost by the crossing edge's kind)."""
    s = l.rel_set | r.rel_set
    rl2 = float(cm.np_rows_log2(s, g))
    if g.typed:
        k = cf.crossing_kind(l.rel_set, r.rel_set, g)
        jc = float(cm.np_join_cost_kind(
            np.float32(l.rows_log2), np.float32(r.rows_log2),
            np.float32(rl2), k))
    else:
        jc = float(cm.np_join_cost(np.float32(l.rows_log2), np.float32(r.rows_log2),
                                   np.float32(rl2)))
    return Plan(rel_set=s, cost=l.cost + r.cost + jc, rows_log2=rl2, left=l, right=r)


def cost_plan(p: Plan, g) -> Plan:
    """Re-cost a plan tree bottom-up (fresh Plan with canonical costs)."""
    if p.is_leaf:
        return leaf_plan(p.relations()[0], g)
    return join_plans(cost_plan(p.left, g), cost_plan(p.right, g), g)


def validate_plan(p: Plan, g, require_ccp: bool = True) -> None:
    """Assert structural validity: covers each relation once; every join is a
    CCP-Pair (both sides connected, disjoint, cross edge exists) unless
    ``require_ccp`` is False; typed joins obey the conflict rules."""
    adj = g.adjacency()

    def rec(node: Plan) -> int:
        if node.is_leaf:
            assert bin(node.rel_set).count("1") == 1, "leaf must be single rel"
            return node.rel_set
        ls = rec(node.left)
        rs = rec(node.right)
        assert ls & rs == 0, "overlapping join sides"
        assert (ls | rs) == node.rel_set, "rel_set mismatch"
        if require_ccp:
            assert bs.np_is_connected(ls, adj), f"left side {ls:#x} disconnected"
            assert bs.np_is_connected(rs, adj), f"right side {rs:#x} disconnected"
            assert bs.np_neighbors(ls, adj) & rs, "no edge between join sides"
        assert cf.ordered_valid(ls, rs, g), \
            f"join ({ls:#x}, {rs:#x}) violates the conflict rules"
        return node.rel_set

    covered = rec(p)
    assert covered == g.full_set, "plan does not cover all relations"


def extract_plan(s: int, memo_left: np.ndarray, g) -> Plan:
    """Rebuild the best plan for set ``s`` from the dense memo 'left' array."""

    def rec(ss: int) -> Plan:
        if bin(ss).count("1") == 1:
            return leaf_plan(int(ss).bit_length() - 1, g)
        lb = int(memo_left[ss])
        if lb == 0 or (lb & ss) != lb:
            raise RuntimeError(f"memo has no plan for set {ss:#x}")
        return join_plans(rec(lb), rec(ss & ~lb), g)

    return rec(s)
