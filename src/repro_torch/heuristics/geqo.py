"""GEQO — PostgreSQL-style genetic join-order search (paper §7.3 baseline).

The port of ``repro.heuristics.geqo``, host only, drawing the same
``random.Random(seed)`` stream.  Chromosome = permutation of relations;
decoding follows PostgreSQL's gimme_tree clump-merging (join a new relation
into the first clump it has an edge to, else keep it as its own clump;
merge clumps whenever an edge appears), so no cross products are produced
on connected graphs.  Edge recombination is approximated by order crossover
(OX) + swap mutation with elitism — the PG default parameters scaled to a
wall-clock budget.  The result is the reference's only while
``generations`` binds before ``budget_s`` does.
"""
from __future__ import annotations

import random
import time

from ..core import bitset as bs
from ..core.joingraph import JoinGraph
from ..core.plan import Counters, OptimizeResult, Plan, cost_plan, join_plans, leaf_plan


def _decode(perm, g: JoinGraph, adj) -> Plan:
    clumps: list[Plan] = []
    for r in perm:
        cur = leaf_plan(r, g)
        merged = True
        while merged:
            merged = False
            for i, c in enumerate(clumps):
                if bs.np_neighbors(cur.rel_set, adj) & c.rel_set:
                    cur = join_plans(c, cur, g)
                    clumps.pop(i)
                    merged = True
                    break
        clumps.append(cur)
    # connected graph: keep merging until single clump
    while len(clumps) > 1:
        done = False
        for i in range(len(clumps)):
            for j in range(i + 1, len(clumps)):
                if bs.np_neighbors(clumps[i].rel_set, adj) & clumps[j].rel_set:
                    c = join_plans(clumps[i], clumps[j], g)
                    clumps = [x for k, x in enumerate(clumps) if k not in (i, j)]
                    clumps.append(c)
                    done = True
                    break
            if done:
                break
        if not done:
            raise ValueError("disconnected query graph")
    return clumps[0]


def _ox(a, b, rng):
    n = len(a)
    i, j = sorted(rng.sample(range(n), 2))
    child = [None] * n
    child[i:j + 1] = a[i:j + 1]
    fill = [x for x in b if x not in set(child[i:j + 1])]
    t = 0
    for k in list(range(0, i)) + list(range(j + 1, n)):
        child[k] = fill[t]
        t += 1
    return child


def solve(g: JoinGraph, pool: int = 64, generations: int = 200,
          budget_s: float = 20.0, seed: int = 0) -> OptimizeResult:
    t0 = time.perf_counter()
    rng = random.Random(seed)
    adj = g.adjacency()
    base = list(range(g.n))
    pop = []
    for _ in range(pool):
        p = base[:]
        rng.shuffle(p)
        pop.append(p)

    def fitness(perm):
        return _decode(perm, g, adj).cost

    scored = sorted(((fitness(p), p) for p in pop), key=lambda x: x[0])
    for _ in range(generations):
        if time.perf_counter() - t0 > budget_s:
            break
        # tournament parents biased to the front (PG's linear bias)
        a = scored[rng.randrange(len(scored) // 2)][1]
        b = scored[rng.randrange(len(scored))][1]
        child = _ox(a, b, rng)
        if rng.random() < 0.15:
            i, j = rng.randrange(g.n), rng.randrange(g.n)
            child[i], child[j] = child[j], child[i]
        c = fitness(child)
        if c < scored[-1][0]:
            scored[-1] = (c, child)
            scored.sort(key=lambda x: x[0])
    best = scored[0][1]
    p = cost_plan(_decode(best, g, adj), g)
    return OptimizeResult(plan=p, cost=p.cost, counters=Counters(),
                          algorithm="geqo", wall_s=time.perf_counter() - t0)
