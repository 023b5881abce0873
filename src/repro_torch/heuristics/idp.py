"""IDP2 (Kossmann & Stocker, TODS'00) with MPDP inside — paper §4.1.

The port of ``repro.heuristics.idp``.  Two components, exactly as in the
paper:
 1. *Initial join order*: a GOO plan over the unit graph.
 2. *Iterative DP*: repeatedly select the most costly subtree with <= k
    leaves, optimize its units exactly (MPDP by default — the paper's point
    is that a massively-parallel exact core affords a much larger k),
    replace it by a single temp-table unit, and continue until one unit
    remains.  Composite cardinalities stay exact (log2 bookkeeping), so the
    search is over materialization boundaries only.

Beyond the paper, each round selects up to ``batch`` *disjoint* costly
subtrees instead of one: their unit sets don't overlap, so the exact
subproblems are independent and ship to the device as a single
``optimize_many`` batch (the port's batched DP on ``device``, ``cuda`` by
default).  With the ``mpdp`` subsolver the batch dispatcher picks the
lane space per (NMAX, topology) bucket: unit subgraphs are usually
near-trees, so the rounds run in the MPDP:Tree/general spaces rather than
DPSUB's ``sets x 2^i`` blow-up; subproblems past 16 relations take
``optimize_many``'s solo route.

The host decisions (``_recost``, ``_costly_disjoint_subtrees``) compare
the same Python and f32 values in the same order as the reference.
``stitch_partial_memo`` completes a deadline-abandoned exact DP from its
committed memo levels, for the engines' degraded results.
"""
from __future__ import annotations

import time
from typing import Optional

from ..core import cost as cm
from ..core.joingraph import JoinGraph
from ..core.plan import Counters, OptimizeResult, cost_plan
from .common import UnitGraph, expand_unit_plan
from .goo import goo_plan


class _TNode:
    """Plan-over-units tree with cached unit-id set and cost."""

    __slots__ = ("uids", "left", "right", "cost", "rows_l2", "unit")

    def __init__(self, uids, left=None, right=None, unit=None):
        self.uids = uids          # frozenset of unit ids
        self.left = left
        self.right = right
        self.unit = unit          # Unit for leaves
        self.cost = 0.0
        self.rows_l2 = 0.0

    @property
    def is_leaf(self):
        return self.left is None

    def leaves(self):
        if self.is_leaf:
            return [self]
        return self.left.leaves() + self.right.leaves()


def _goo_tree(ug: UnitGraph) -> _TNode:
    """GOO merge tree over unit ids (non-destructive: works on id sets)."""
    active: dict[int, _TNode] = {i: _TNode(frozenset([i]), unit=ug.units[i])
                                 for i in range(ug.n)}
    # aggregated sel between active groups
    rows = {i: ug.units[i].rows_log2 for i in range(ug.n)}
    sel: dict[tuple[int, int], float] = dict(ug.sel_l2)
    gid = ug.n

    while len(active) > 1:
        best, best_rows = None, None
        for (a, b), s in sel.items():
            r = max(rows[a] + rows[b] + s, 0.0)
            if best is None or r < best_rows:
                best, best_rows = (a, b), r
        if best is None:
            raise ValueError("disconnected unit graph")
        a, b = best
        node = _TNode(active[a].uids | active[b].uids, active[a], active[b])
        del active[a], active[b]
        active[gid] = node
        rows[gid] = best_rows
        # re-aggregate edges touching a or b
        new_sel: dict[tuple[int, int], float] = {}
        for (x, y), s in sel.items():
            if (x, y) == (a, b) or (x, y) == (b, a):
                continue
            nx = gid if x in (a, b) else x
            ny = gid if y in (a, b) else y
            key = (min(nx, ny), max(nx, ny))
            new_sel[key] = new_sel.get(key, 0.0) + s
        sel = new_sel
        gid += 1
    return next(iter(active.values()))


def _recost(node: _TNode, ug: UnitGraph):
    """Bottom-up cost/rows over the unit graph (temp-table semantics)."""
    if node.is_leaf:
        uid = next(iter(node.uids))
        node.unit = ug.units[uid]
        node.rows_l2 = ug.units[uid].rows_log2
        node.cost = float(cm.np_scan_cost(node.rows_l2))
        return
    _recost(node.left, ug)
    _recost(node.right, ug)
    ids = list(node.uids)
    node.rows_l2 = ug.union_rows_log2(ids)
    jc = float(cm.np_join_cost(node.left.rows_l2, node.right.rows_l2,
                               node.rows_l2))
    node.cost = node.left.cost + node.right.cost + jc


def _most_costly_subtree(root: _TNode, k: int) -> _TNode:
    best = None

    def rec(n: _TNode):
        nonlocal best
        if n.is_leaf:
            return
        if 2 <= len(n.uids) <= k and (best is None or n.cost > best.cost):
            best = n
        rec(n.left)
        rec(n.right)

    rec(root)
    if best is None:
        # root has > k leaves but no internal node within k: take the
        # smallest internal node (its leaf count may still exceed k; clamp
        # by walking down)
        n = root
        while not n.is_leaf and len(n.uids) > k:
            n = n.left if len(n.left.uids) >= len(n.right.uids) else n.right
        best = n if not n.is_leaf else root
    return best


def _costly_disjoint_subtrees(root: _TNode, k: int, batch: int) -> list[_TNode]:
    """Up to ``batch`` unit-disjoint internal nodes with <= k leaves, most
    costly first.  The primary target keeps `_most_costly_subtree`'s fallback
    semantics (always returns something merge-able); extras are best-effort.
    """
    cands: list[_TNode] = []

    def rec(n: _TNode):
        if n.is_leaf:
            return
        if 2 <= len(n.uids) <= k:
            cands.append(n)
        rec(n.left)
        rec(n.right)

    rec(root)
    if not cands:
        return [_most_costly_subtree(root, k)]     # walk-down fallback only
    # stable descending sort of the DFS preorder: ordered[0] is the first of
    # equal maxima, matching _most_costly_subtree's strict-> update rule
    ordered = sorted(cands, key=lambda t: -t.cost)
    chosen = [ordered[0]]
    taken = set(ordered[0].uids)
    for n in ordered[1:]:
        if len(chosen) >= batch:
            break
        if n.uids & taken:
            continue
        chosen.append(n)
        taken |= n.uids
    return chosen


def tree_from_plan(p) -> _TNode:
    """Plan tree over *base relations* -> ``_TNode`` tree over unit ids.

    Valid for a fresh ``UnitGraph`` built from base units, where unit ``i``
    *is* base relation ``i``.  This is how UnionDP's re-optimization loop
    seeds the round driver with its composite plan instead of a GOO tree:
    the plan's own join structure becomes the subtree-selection space, so
    costly subtrees that straddle the previous partition boundaries are
    exactly re-optimized (IDP2's trick applied across rounds)."""
    if p.is_leaf:
        return _TNode(frozenset(p.relations()))
    l = tree_from_plan(p.left)
    r = tree_from_plan(p.right)
    return _TNode(l.uids | r.uids, l, r)


def run_rounds(ug: UnitGraph, tree: _TNode, k: int, batch, batch_sub,
               max_rounds: Optional[int] = None):
    """IDP2's round driver, shared by ``idp.solve`` and UnionDP's
    re-optimization loop (``uniondp``).

    Repeatedly: re-cost ``tree`` over ``ug`` (temp-table semantics), select
    up to ``batch`` unit-disjoint most-costly subtrees with <= k leaves,
    optimize each subtree's units exactly — the whole round ships as ONE
    ``optimize_many`` batch via ``batch_sub`` — and collapse each optimized
    subtree into a composite unit.  Runs until a single unit remains (or
    ``max_rounds``); returns the final ``Unit`` (greedy GOO finish when
    stopped early).  Each collapse replaces a subtree by the exact optimum
    over the *same* unit set with unchanged output cardinality, so the total
    tree cost is monotone non-increasing round over round.
    """
    g = ug.base
    rounds = 0
    while True:
        _recost(tree, ug)
        if ug.n == 1:
            break
        targets = _costly_disjoint_subtrees(tree, k, batch)
        if (len(targets[0].uids) == len(tree.uids)
                and len(tree.uids) <= k):
            targets = [tree]
        # disjoint targets: every subgraph extracts from the same pre-merge
        # snapshot and the whole round runs as ONE batched device pass
        jobs = []
        for target in targets:
            jg, idxs = ug.as_joingraph(sorted(target.uids))
            jobs.append((jg, [ug.units[i] for i in idxs]))
        plans = batch_sub([jg for jg, _ in jobs])
        for target, (jg, ulist), plan in zip(targets, jobs, plans):
            # recompute current indices by unit identity: earlier merges in
            # this round reindexed ug.units
            ids = sorted(ug.index_of(t) for t in ulist)
            base_plan = expand_unit_plan(plan, ulist, g)
            ug.merge(ids, base_plan)
            # ug.units reindexed: composite appended at end, others shift.
            old2new = {}
            j = 0
            dropped = set(ids)
            for old in range(len(ug.units) + len(ids) - 1):
                if old in dropped:
                    continue
                old2new[old] = j
                j += 1
            new_leaf = _TNode(frozenset([len(ug.units) - 1]),
                              unit=ug.units[-1])
            tree = _replace(tree, target, new_leaf)

            def remap(n: _TNode, new_leaf=new_leaf, old2new=old2new):
                if n is new_leaf:
                    return
                if n.is_leaf:
                    n.uids = frozenset(old2new[u] for u in n.uids)
                    return
                remap(n.left)
                remap(n.right)
                n.uids = n.left.uids | n.right.uids

            remap(tree)
        rounds += 1
        if max_rounds and rounds >= max_rounds:
            break
        if len(tree.uids) == 1 and tree.is_leaf:
            break

    final_unit = ug.units[-1] if ug.n > 1 else ug.units[0]
    if ug.n > 1:
        # stopped early (max_rounds): finish greedily with GOO
        final_unit = goo_plan(ug)
    return final_unit


def stitch_partial_memo(g: JoinGraph, memo_cost, memo_left):
    """Anytime completion of a deadline-abandoned exact DP (the paper's
    time-budget contract, composed as IDP2 composes its rounds).

    ``memo_cost``/``memo_left`` are one query's host memo slices with only
    the first k levels committed.  Every finite composite entry is an
    exact optimum over its relation set, so: cover the relations greedily
    with the largest (cheapest first among equal sizes) disjoint solved
    sets, extract each exact sub-plan, wrap them as temp-table ``Unit``\\ s
    and let GOO order the remaining joins.  The result is compared with
    plain GOO from scratch and the cheaper plan wins, so the degraded cost
    is never worse than GOO's.

    Returns ``(plan, cost, dinfo)``; ``dinfo`` describes the stitch and is
    merged into ``OptimizeResult.info["degraded"]`` by the engines.
    """
    import numpy as np

    from ..core.plan import extract_plan, leaf_plan
    from . import goo as _goo
    from .common import Unit

    full = 1 << g.n
    cost = np.asarray(memo_cost[:full], np.float32)
    solved = [int(s) for s in np.flatnonzero(np.isfinite(cost))
              if int(s).bit_count() >= 2]
    # largest exact islands first; cheaper first among equal sizes
    solved.sort(key=lambda s: (-s.bit_count(), float(cost[s])))
    units, covered, stitched = [], 0, 0
    for s in solved:
        if s & covered:
            continue
        p = extract_plan(s, memo_left, g)
        rows = float(cm.np_rows_for_sets(np.array([s]), g)[0])
        units.append(Unit(rel_set=s, rows_log2=rows, plan=p))
        covered |= s
        stitched += 1
    for v in range(g.n):
        if not (covered >> v) & 1:
            units.append(Unit(rel_set=1 << v,
                              rows_log2=float(g.log2_card[v]),
                              plan=leaf_plan(v, g)))
    ug = UnitGraph(g, units=units)
    unit = goo_plan(ug)
    stitch = cost_plan(unit.plan, g)
    plain = _goo.solve(g)
    if plain.cost < stitch.cost:
        return plain.plan, plain.cost, {"stitched_units": stitched,
                                        "fallback": "goo"}
    return stitch, stitch.cost, {"stitched_units": stitched,
                                 "fallback": "stitch"}


def _replace(root: _TNode, target: _TNode, leaf: _TNode) -> _TNode:
    if root is target:
        return leaf
    if root.is_leaf:
        return root
    root.left = _replace(root.left, target, leaf)
    root.right = _replace(root.right, target, leaf)
    root.uids = root.left.uids | root.right.uids
    return root


def solve(g: JoinGraph, k: int = 15, subsolver: str = "mpdp",
          max_rounds: Optional[int] = None, batch: int = 4,
          devices=None, mesh=None,
          pipeline: bool | None = None, policy=None, *,
          device=None) -> OptimizeResult:
    """IDP2 over ``g`` with exact subproblems of at most ``k`` units, up to
    ``batch`` of them a round in one ``optimize_many`` call on ``device``
    (``cuda`` unless the caller names another; ``subsolver="lindp"`` runs
    on the host).  ``pipeline`` goes to ``optimize_many``: with ``True``
    every round's flights run the pipelined level loop, with results
    equal to the synchronous ones.  ``policy`` (a ``policy.PolicyTable``)
    goes there too and learns per-bucket dispatch across the rounds;
    ``devices`` and ``mesh`` go there too: every round's flights are
    dealt over the mesh, and its 17-20-relation subproblems run on the
    lattice (``core.lattice``) instead of the solo engine."""
    t0 = time.perf_counter()
    counters = Counters()
    if g.typed:
        # decompose at non-inner bridges; each inner component runs the full
        # IDP2 machinery (GOO seed + batched exact rounds) independently
        from .common import solve_typed

        def inner(jg):
            r = solve(jg, k=k, subsolver=subsolver, max_rounds=max_rounds,
                      batch=batch, devices=devices, mesh=mesh,
                      pipeline=pipeline, policy=policy, device=device)
            counters.evaluated += r.counters.evaluated
            counters.ccp += r.counters.ccp
            return r.plan

        p = solve_typed(g, inner)
        return OptimizeResult(plan=p, cost=p.cost, counters=counters,
                              algorithm=f"idp2_{subsolver}",
                              wall_s=time.perf_counter() - t0)
    if subsolver == "lindp":
        from . import lindp as _l

        def batch_sub(jgs):
            out = []
            for jg in jgs:
                order = _l.ikkbz.best_order(jg)
                p, _ = _l.dp_over_order(jg, order)
                out.append(p)
            return out
    else:
        from ..core import engine as _e

        def batch_sub(jgs):
            # "mpdp" routes through the per-bucket topology dispatcher:
            # acyclic subproblems get the sets x m tree lanes, cyclic ones
            # the block prefix-sum lanes (cheap spaces, identical costs);
            # a policy table learns per-bucket dispatch across the rounds
            rs = _e.optimize_many(jgs, algorithm=subsolver, devices=devices,
                                  mesh=mesh, pipeline=pipeline, policy=policy,
                                  device=device)
            for r in rs:
                counters.evaluated += r.counters.evaluated
                counters.ccp += r.counters.ccp
            return [r.plan for r in rs]

    ug = UnitGraph(g)
    if ug.n <= k:
        jg, idxs = ug.as_joingraph()
        p = expand_unit_plan(batch_sub([jg])[0], [ug.units[i] for i in idxs], g)
        return OptimizeResult(plan=p, cost=p.cost, counters=counters,
                              algorithm=f"idp2_{subsolver}",
                              wall_s=time.perf_counter() - t0)

    # unit-id indirection: _TNode.uids refer to slots in ug.units; merging
    # rewrites ug.units, so run_rounds rebuilds uid maps after each merge
    tree = _goo_tree(ug)
    final_unit = run_rounds(ug, tree, k, batch, batch_sub,
                            max_rounds=max_rounds)
    p = cost_plan(final_unit.plan, g)
    return OptimizeResult(plan=p, cost=p.cost, counters=counters,
                          algorithm=f"idp2_{subsolver}",
                          wall_s=time.perf_counter() - t0)
