"""DPCCP (Moerkotte & Neumann, VLDB'06) — sequential edge-based enumeration.

Role here (paper §2/§6): the host correctness oracle.  It enumerates
exactly the CCP-Pairs, so its optimal cost and its pair count anchor the
batched device DP; ``chip_smoke.py`` checks every query of its streams
against it on the card's host, which has no JAX.

Pure Python ints (host); fine for n <= ~18 on sparse graphs.
"""
from __future__ import annotations

import time

import numpy as np

from . import bitset as bs
from . import conflicts as cf
from . import cost as cm
from .plan import Counters, OptimizeResult, extract_plan


def _nbrs(s: int, adj) -> int:
    return bs.np_neighbors(s, adj)


def _subsets(x: int):
    """All non-empty subsets of bitmap x, ascending: cur = (cur - x) & x."""
    cur = 0
    while True:
        cur = (cur - x) & x
        if cur == 0:
            return
        yield cur


def enumerate_csg(n: int, adj) -> list[int]:
    """All connected subgraphs, each exactly once (EnumerateCsg)."""
    out = []

    def rec(s: int, x: int):
        nb = _nbrs(s, adj) & ~x
        for s1 in _subsets(nb):
            out.append(s | s1)
        for s1 in _subsets(nb):
            rec(s | s1, x | nb)

    for i in range(n - 1, -1, -1):
        v = 1 << i
        out.append(v)
        rec(v, (v - 1) | v)
    return out


def enumerate_ccp_pairs(n: int, adj) -> list[tuple[int, int]]:
    """All csg-cmp pairs (unordered, each once) — EnumerateCsg x EnumerateCmp."""
    pairs = []

    def rec_cmp(s1: int, s: int, x: int):
        nb = _nbrs(s, adj) & ~x
        for s2 in _subsets(nb):
            pairs.append((s1, s | s2))
        for s2 in _subsets(nb):
            rec_cmp(s1, s | s2, x | nb)

    def cmp_for(s1: int):
        lo = s1 & (-s1)
        bmin = lo - 1  # vertices below min(s1)
        x = bmin | s1
        nb = _nbrs(s1, adj) & ~x
        for v in reversed(list(bs.iter_bits(nb))):
            vb = 1 << v
            pairs.append((s1, vb))
            rec_cmp(s1, vb, x | (((vb - 1)) & nb) | vb)

    def rec_csg(s: int, x: int):
        nb = _nbrs(s, adj) & ~x
        for s1 in _subsets(nb):
            cmp_for(s | s1)
        for s1 in _subsets(nb):
            rec_csg(s | s1, x | nb)

    for i in range(n - 1, -1, -1):
        v = 1 << i
        cmp_for(v)
        rec_csg(v, (v - 1) | v)
    return pairs


def ccp_count(g) -> int:
    """CCP-Counter for a query (symmetric pairs counted, as in the paper)."""
    return 2 * len(enumerate_ccp_pairs(g.n, g.adjacency()))


def solve(g) -> OptimizeResult:
    """Exact optimum via DPCCP.  Processes pairs in |union| order for safety."""
    t0 = time.perf_counter()
    adj = g.adjacency()
    pairs = enumerate_ccp_pairs(g.n, adj)
    pairs.sort(key=lambda p: bin(p[0] | p[1]).count("1"))

    size = 1 << g.n
    memo_cost = np.full(size, np.inf, np.float32)
    memo_rows = np.zeros(size, np.float32)
    memo_left = np.zeros(size, np.int32)
    for v in range(g.n):
        rl2 = np.float32(g.log2_card[v])
        memo_cost[1 << v] = cm.np_scan_cost(rl2)
        memo_rows[1 << v] = rl2

    rows_cache: dict[int, np.float32] = {}

    def rows_l2(s: int) -> np.float32:
        r = rows_cache.get(s)
        if r is None:
            r = cm.np_rows_log2(s, g)
            rows_cache[s] = r
        return r

    typed = g.typed
    for (a, b) in pairs:
        s = a | b
        rl2 = rows_l2(s)
        memo_rows[s] = rl2
        if typed:
            # typed edges break cost symmetry (semi/anti) and admissibility:
            # evaluate each order under the conflict rules
            k = cf.crossing_kind(a, b, g)
            for (x, y) in ((a, b), (b, a)):
                if not cf.ordered_valid(x, y, g):
                    continue
                jc = cm.np_join_cost_kind(memo_rows[x], memo_rows[y], rl2, k)
                cand = memo_cost[x] + memo_cost[y] + jc
                if cand < memo_cost[s] or (cand == memo_cost[s]
                                           and x > memo_left[s]):
                    memo_cost[s] = cand
                    memo_left[s] = x
            continue
        # evaluate both orders (costs symmetric in our model, counted twice)
        jc = cm.np_join_cost(memo_rows[a], memo_rows[b], rl2)
        cand = memo_cost[a] + memo_cost[b] + jc
        if cand < memo_cost[s] or (cand == memo_cost[s] and max(a, b) > memo_left[s]):
            memo_cost[s] = cand
            memo_left[s] = max(a, b)  # deterministic tie-break: larger bitmap left

    full = g.full_set
    if not np.isfinite(memo_cost[full]):
        raise RuntimeError("query graph is disconnected")
    p = extract_plan(full, memo_left, g)
    n_pairs = 2 * len(pairs)
    return OptimizeResult(plan=p, cost=float(memo_cost[full]),
                          counters=Counters(evaluated=n_pairs, ccp=n_pairs),
                          algorithm="dpccp", wall_s=time.perf_counter() - t0,
                          levels=g.n)
