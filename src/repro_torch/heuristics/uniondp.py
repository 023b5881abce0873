"""UnionDP — the paper's novel graph-conscious heuristic (§4.2, Alg. 4),
with cost-aware partition boundaries and IDP2-style re-optimization.

The port of ``repro.heuristics.uniondp``.  Partition the unit graph with a
union-find sweep, optimize every partition exactly with MPDP, collapse
each into a composite node, and recurse on the composite graph until it
fits a single MPDP call.  Two things distinguish this implementation from
the paper's size-greedy baseline:

  * **cost-aware partitioning** (``partition="cost"``, the default):
    candidate merges are scored by ``cost.np_boundary_cost`` — the
    estimated cost of the *boundary join* between the two partitions — and
    the cheapest boundary is unioned first while the merged partition stays
    <= k; the expensive skewed boundary joins stay outside the sweep, where
    the exact composite-level DP decides their order.  ``partition="size"``
    keeps the legacy size-greedy rule for comparison.
  * **iterative re-optimization** (``reopt_rounds > 0``, default on): each
    pass seeds IDP2's round driver (``idp.run_rounds``) with the cheaper of
    the composite plan's own join tree and a fresh GOO merge tree; passes
    repeat until one stops strictly improving the total cost (or
    ``reopt_rounds`` is exhausted), so ``info["round_costs"]`` is monotone
    non-increasing.

A round's partitions are vertex-disjoint, so each partitioning round AND
each re-optimization round ships its subproblems to ``device`` (``cuda``
by default) as one ``optimize_many`` batch.  The heap keys with lazy
revalidation, the union folds and the acceptance test compare the same
Python and f32 values in the same order as the reference.

``info`` on the returned ``OptimizeResult`` carries the explain payload:
``partitions`` (per recursion round, each partition as sorted base-relation
ids) and ``round_costs`` (total plan cost after the initial partitioned pass
and after each accepted re-optimization pass).
"""
from __future__ import annotations

import heapq
import time

import numpy as np

from ..core import cost as cm
from ..core import engine as _e
from ..core import telemetry as _telemetry
from ..core.joingraph import JoinGraph
from ..core.plan import Counters, OptimizeResult, cost_plan
from .common import UnitGraph, expand_unit_plan


def _partition_size_greedy(ug: UnitGraph, k: int) -> list[list[int]]:
    """Legacy rule (paper Alg. 4): union edges by increasing merged size,
    ties broken by cheaper edge weight first.  Kept for the quality
    comparison (``partition="size"``)."""
    n = ug.n
    parent = list(range(n))
    size = [1] * n

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def weight(a, b):
        ra = ug.units[a].rows_log2
        rb = ug.units[b].rows_log2
        ro = ug.join_rows_log2(a, b)
        return float(cm.np_join_cost(np.float32(ra), np.float32(rb),
                                     np.float32(ro)))

    heap = []
    for (a, b) in ug.edges:
        heapq.heappush(heap, (2, weight(a, b), a, b))
    while heap:
        ssum, w, a, b = heapq.heappop(heap)
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        cur = size[ra] + size[rb]
        if cur != ssum:
            heapq.heappush(heap, (cur, w, a, b))   # lazy key refresh
            continue
        if cur <= k:
            parent[ra] = rb
            size[rb] = cur
    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def _partition_cost_aware(ug: UnitGraph, k: int) -> list[list[int]]:
    """Cost-aware union rule: repeatedly merge the partition pair with the
    *cheapest* boundary join, while the merged size stays <= k.

    Each candidate merge is scored with ``cost.np_boundary_cost(rows_a,
    rows_b, crossing_sel)`` over the *current* partitions: per-root
    aggregated log2 rows plus a dict-of-dicts crossing-selectivity
    adjacency (seeded from ``ug.sel_adjacency``) are folded on every union.
    A min-heap with lazy revalidation keeps the sweep near O(E log E):
    stale entries (either side merged since the push) are re-scored and
    re-pushed; pairs that can no longer fit under k are dropped permanently
    (partition sizes only grow).  Ties break on unit indices —
    deterministic sweep.
    """
    n = ug.n
    parent = list(range(n))
    size = [1] * n
    rows = [u.rows_log2 for u in ug.units]    # per-root aggregated log2 rows
    nbr = ug.sel_adjacency()                  # root -> {root: crossing sel}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def boundary(ra, rb):
        return float(cm.np_boundary_cost(rows[ra], rows[rb], nbr[ra][rb]))

    heap = []
    for (a, b) in ug.edges:
        heapq.heappush(heap, (boundary(a, b), a, b))
    while heap:
        key, a, b = heapq.heappop(heap)
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if size[ra] + size[rb] > k:
            continue                          # sizes only grow: drop forever
        cur = boundary(ra, rb)
        if cur != key:
            heapq.heappush(heap, (cur, ra, rb))    # lazy key refresh
            continue
        # union ra into rb: fold rows and redirect ra's crossing edges
        parent[ra] = rb
        size[rb] += size[ra]
        rows[rb] = max(rows[ra] + rows[rb] + nbr[ra].pop(rb), 0.0)
        del nbr[rb][ra]
        for o, s in nbr.pop(ra).items():
            nbr[o].pop(ra)
            nbr[o][rb] = nbr[rb][o] = nbr[rb].get(o, 0.0) + s
            if size[rb] + size[o] <= k:
                heapq.heappush(heap, (boundary(rb, o), rb, o))
    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def _partition(ug: UnitGraph, k: int, rule: str = "cost") -> list[list[int]]:
    """Partition the unit graph into groups of <= k units (every unit
    appears in exactly one group).  ``rule="cost"`` scores merges by
    boundary-join cost (default), ``rule="size"`` is the legacy size-greedy
    sweep."""
    if rule == "size":
        return _partition_size_greedy(ug, k)
    if rule != "cost":
        raise ValueError(f"unknown partition rule: {rule!r}")
    return _partition_cost_aware(ug, k)


def _reoptimize(g: JoinGraph, plan, k: int, batch_sub, batch: int,
                max_rounds: int):
    """Bounded IDP2-style re-optimization over the composite plan.

    Each pass treats the current plan as a tree over the base unit graph and
    runs ``idp.run_rounds`` seeded with the *cheaper* of two trees
    (temp-table recost decides): the plan's own join tree (refinement across
    the previous partition boundaries) or a fresh GOO merge tree (classic
    IDP2).  A pass is accepted only if it strictly lowers the total
    canonical cost, so the returned per-pass cost sequence is monotone
    non-increasing and the loop stops at the first non-improving pass (or
    after ``max_rounds``).  Returns (best plan, per-pass costs incl. the
    seed's).
    """
    from . import idp as _idp
    best = plan
    costs = [best.cost]
    for _ in range(max_rounds):
        ug = UnitGraph(g)
        plan_tree = _idp.tree_from_plan(best)
        goo_tree = _idp._goo_tree(ug)
        _idp._recost(plan_tree, ug)
        _idp._recost(goo_tree, ug)
        tree = plan_tree if plan_tree.cost <= goo_tree.cost else goo_tree
        unit = _idp.run_rounds(ug, tree, k, batch, batch_sub)
        cand = cost_plan(unit.plan, g)
        if not cand.cost < best.cost:
            break
        best = cand
        costs.append(cand.cost)
    return best, costs


def solve(g: JoinGraph, k: int = 15, subsolver: str = "mpdp",
          goo_floor: bool = False, partition: str = "cost",
          reopt_rounds: int = 4, reopt_batch: int = 4,
          devices=None, mesh=None,
          pipeline: bool | None = None, policy=None, *,
          device=None) -> OptimizeResult:
    """UnionDP over ``g`` with partitions of at most ``k`` units; every
    round's subproblems run as one ``optimize_many`` call on ``device``
    (``cuda`` unless the caller names another).  ``policy`` (a
    ``policy.PolicyTable``) sets ``reopt_rounds`` to one past the EMA of
    the passes that improved earlier plans, learns from this run's, and
    goes to ``optimize_many`` to learn per-bucket dispatch.  ``pipeline``
    goes to ``optimize_many``: with ``True`` every round's flights run the
    pipelined level loop, with results equal to the synchronous ones.
    ``devices`` and ``mesh`` go there too: every round's flights are
    dealt over the mesh, and its 17-20-relation subproblems run on the
    lattice (``core.lattice``) instead of the solo engine."""
    with _telemetry.span("uniondp.solve"):
        t0 = time.perf_counter()
        counters = Counters()
        if g.typed:
            # decompose at non-inner bridges: partitioning +
            # re-optimization run per inner component (reordering across a
            # bridge is inadmissible anyway), the shared stitch joins
            # components conflict-validly
            from .common import solve_typed

            def inner(jg):
                r = solve(jg, k=k, subsolver=subsolver, goo_floor=goo_floor,
                          partition=partition, reopt_rounds=reopt_rounds,
                          reopt_batch=reopt_batch, devices=devices, mesh=mesh,
                          pipeline=pipeline, policy=policy, device=device)
                counters.evaluated += r.counters.evaluated
                counters.ccp += r.counters.ccp
                return r.plan

            p = solve_typed(g, inner)
            return OptimizeResult(plan=p, cost=p.cost, counters=counters,
                                  algorithm=f"uniondp_{subsolver}",
                                  info={"partitions": [],
                                        "round_costs": [p.cost]},
                                  wall_s=time.perf_counter() - t0)
        if policy is not None:
            # learned re-optimization budget: one past the EMA of passes that
            # improved the plan before (cold table -> the static default)
            reopt_rounds = policy.reopt_rounds_for(reopt_rounds)

        def batch_solve(jgs):
            """Disjoint subproblems -> one batched device pass ("mpdp"
            lands in the per-bucket tree/general lane spaces, not DPSUB;
            ``policy`` learns per-bucket dispatch across the rounds)."""
            with _telemetry.span("uniondp.subsolve"):
                rs = _e.optimize_many(jgs, algorithm=subsolver,
                                      devices=devices, mesh=mesh,
                                      pipeline=pipeline, policy=policy,
                                      device=device)
            for r in rs:
                counters.evaluated += r.counters.evaluated
                counters.ccp += r.counters.ccp
            return [r.plan for r in rs]

        info: dict = {"partitions": [], "round_costs": []}
        ug = UnitGraph(g)
        while ug.n > k:
            with _telemetry.span("uniondp.partition"):
                groups = _partition(ug, k, rule=partition)
            if all(len(gr) == 1 for gr in groups):
                # cannot union anything (all merges would exceed k): force the
                # two cheapest-connected groups together to guarantee progress
                a, b = ug.edges[0]
                groups = [[a, b]] + [[i] for i in range(ug.n)
                                     if i not in (a, b)]
            info["partitions"].append(
                [ug.rel_ids(sorted(gr)) for gr in groups])
            # capture unit objects up-front: each merge reindexes ug.units.
            # Partitions are disjoint, so every subgraph can be extracted from
            # the pre-merge snapshot and the whole round batched.
            jobs = []
            with _telemetry.span("uniondp.merge"):
                for gr in groups:
                    if len(gr) < 2:
                        continue
                    # pre-merge: ids == gr
                    jg, idxs = ug.as_joingraph(sorted(gr))
                    jobs.append((jg, [ug.units[i] for i in idxs]))
            plans = batch_solve([jg for jg, _ in jobs])
            with _telemetry.span("uniondp.merge"):
                for (jg, ulist), plan in zip(jobs, plans):
                    ids = sorted(ug.index_of(t) for t in ulist)
                    ug.merge(ids, expand_unit_plan(plan, ulist, g))
        with _telemetry.span("uniondp.merge"):
            jg, idxs = ug.as_joingraph()
        plan = batch_solve([jg])[0]
        with _telemetry.span("uniondp.merge"):
            p = cost_plan(expand_unit_plan(
                plan, [ug.units[i] for i in idxs], g), g)
        algo = f"uniondp_{subsolver}"
        if reopt_rounds > 0 and g.n > k:
            with _telemetry.span("uniondp.reopt"):
                p, info["round_costs"] = _reoptimize(
                    g, p, k, batch_solve, reopt_batch, reopt_rounds)
            algo += "+reopt"
            if policy is not None:
                # accepted passes = improvements beyond the initial cost
                policy.observe_reopt(len(info["round_costs"]) - 1)
        else:
            info["round_costs"] = [p.cost]
        # opt-in serving guard, OFF by default: the cost-aware partitioner
        # plus re-optimization beat plain GOO outright on the skewed PK-FK
        # streams
        if goo_floor and g.n > k:
            from .goo import solve as _goo_solve
            base = _goo_solve(g)
            if base.cost < p.cost:
                p = base.plan
                algo += "+goo_floor"
                # keep the explain payload consistent with the served plan:
                # round_costs stays monotone and ends at the result's cost,
                # and the raw (pre-floor) cost remains inspectable
                info["goo_floor_raw_cost"] = info["round_costs"][-1]
                info["round_costs"] = info["round_costs"] + [base.cost]
        return OptimizeResult(plan=p, cost=p.cost, counters=counters,
                              algorithm=algo, info=info,
                              wall_s=time.perf_counter() - t0)
