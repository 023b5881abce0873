"""Plan trees as nested ``[left, right]`` lists over leaf bitmaps: their
validity against a query and their cost under the reference model.  Sets
are Python ints, so a plan may span any number of relations."""
from __future__ import annotations

import numpy as np

from .costmodel import F64, Precision


def _postorder(plan) -> list:
    """Nodes children-first (iterative: a plan can be 400 levels deep)."""
    stack, out = [plan], []
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, list):
            stack.extend(node)
    out.reverse()
    return out


def _bits(s: int):
    while s:
        low = s & -s
        yield low.bit_length() - 1
        s ^= low


def invalid_reason(plan, wire: dict, require_ccp: bool = True):
    """None if ``plan`` is a join tree covering every relation of the
    query exactly once and (``require_ccp``) joining at each node two
    connected sets with an edge between them; else why it is not."""
    n = wire["n"]
    adj = [0] * n
    for u, v in wire["edges"]:
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    sets: dict[int, int] = {}

    def rel(node):
        return node if isinstance(node, int) else sets[id(node)]

    for node in _postorder(plan):
        if isinstance(node, bool) or not isinstance(node, (int, list)):
            return f"node {node!r} is neither a leaf nor a join"
        if isinstance(node, int):
            if node <= 0 or node & (node - 1) or node >> n:
                return f"leaf {node!r} is not one of the {n} relations"
            continue
        if len(node) != 2:
            return f"join with {len(node)} children"
        ls, rs = rel(node[0]), rel(node[1])
        if ls & rs:
            return f"join sides {ls:#x} and {rs:#x} overlap"
        # leaves are connected, so an edge between two connected sides
        # keeps every side connected, checked bottom-up
        if require_ccp and not any(adj[v] & rs for v in _bits(ls)):
            return f"no edge between {ls:#x} and {rs:#x}"
        sets[id(node)] = ls | rs
    if rel(plan) != (1 << n) - 1:
        return f"the plan covers {rel(plan):#x}, not all {n} relations"
    return None


def plan_cost(plan, wire: dict, prec: Precision = F64) -> float:
    """Cost of a valid plan tree under the model, in ``prec``: leaves scan,
    each join costs the cheapest operator on its operands' rows, the
    join's log2 rows being its operands' unfloored sums plus the log2
    selectivities of the edges between them, floored at 0."""
    n = wire["n"]
    cards = np.asarray(wire["cards_l2"], prec.dtype)
    sels = np.asarray(wire["sels_l2"], prec.dtype)
    inc: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for i, (u, v) in enumerate(wire["edges"]):
        inc[u].append((v, i))
        inc[v].append((u, i))
    zero = prec.c(0.0)
    vals: dict[int, tuple] = {}      # id(join) -> (set, cost, raw log2 rows)

    def get(node):
        if isinstance(node, int):
            raw = cards[node.bit_length() - 1]
            return node, prec.scan_cost(np.maximum(raw, zero)), raw
        return vals[id(node)]

    for node in _postorder(plan):
        if isinstance(node, int):
            continue
        (ls, lc, lraw), (rs, rc, rraw) = get(node[0]), get(node[1])
        small, other = (ls, rs) if ls.bit_count() <= rs.bit_count() \
            else (rs, ls)
        raw = prec.r(lraw + rraw)
        for u in _bits(small):
            for w, i in inc[u]:
                if (other >> w) & 1:
                    raw = prec.r(raw + sels[i])
        jc = prec.join_cost(np.maximum(lraw, zero), np.maximum(rraw, zero),
                            np.maximum(raw, zero))
        vals[id(node)] = (ls | rs, prec.r(prec.r(lc + rc) + jc), raw)
    return float(get(plan)[1])
