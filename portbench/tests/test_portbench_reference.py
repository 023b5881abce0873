"""The plain reference: its optimum against brute force, its csg-cmp
pairs against the port's DPccp, its plan checks and its costs."""
import itertools

import numpy as np
import pytest

from portbench.reference import exact, greedy, plans
from portbench.reference.costmodel import BF16, F64, to_bf16
from portbench.traffic import musicbrainz, snowflake
from portbench.traffic.wire import make_wire


def _wire(n, edges, seed):
    r = np.random.default_rng(seed)
    cards = 10 ** r.uniform(1, 7, n)
    sels = [float(10 ** r.uniform(-6, 0)) for _ in edges]
    return make_wire(n, edges, cards, sels)


def _graphs():
    out = []
    for s in range(3):
        out.append(_wire(5, [(i, i + 1) for i in range(4)], s))            # chain
        out.append(_wire(6, [(i, (i + 1) % 6) for i in range(6)], s))      # cycle
        out.append(_wire(6, [(0, i) for i in range(1, 6)], s))             # star
        out.append(_wire(5, list(itertools.combinations(range(5), 2)), s))  # clique
        out.append(musicbrainz.query(6, s))
        out.append(snowflake.query(7, s))
    return out


def _connected(s, adj):
    seen = frontier = s & -s
    while frontier:
        nxt = 0
        for v in plans._bits(frontier):
            nxt |= adj[v]
        frontier = nxt & s & ~seen
        seen |= frontier
    return seen == s


def _trees(s, adj):
    """Every valid join tree over the connected set s (leaves as bitmaps)."""
    if s & (s - 1) == 0:
        yield s
        return
    low = s & -s
    sub = (s - 1) & s
    while sub:
        if sub & low and sub != s:
            rest = s & ~sub
            if _connected(sub, adj) and _connected(rest, adj) \
                    and any(adj[v] & rest for v in plans._bits(sub)):
                for lt in _trees(sub, adj):
                    for rt in _trees(rest, adj):
                        yield [lt, rt]
        sub = (sub - 1) & s


@pytest.mark.parametrize("i", range(18))
def test_optimum_equals_brute_force(i):
    w = _graphs()[i]
    adj = [0] * w["n"]
    for u, v in w["edges"]:
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    best = min(plans.plan_cost(t, w) for t in _trees((1 << w["n"]) - 1, adj))
    cost, plan = exact.solve(w)
    assert plans.invalid_reason(plan, w) is None
    assert cost == pytest.approx(best, rel=1e-12)
    assert plans.plan_cost(plan, w) == pytest.approx(cost, rel=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_pairs_and_optimum_match_the_ports_dpccp(seed):
    from repro_torch.core import dpccp
    from repro_torch.core.joingraph import graph_from_wire
    w = musicbrainz.query(12, 100 + seed)
    g = graph_from_wire(w)
    adj = exact.adjacency(w)
    sets = np.sort(np.concatenate(exact.connected_sets(adj)))
    pl, _ = exact.ccp_pairs(adj, sets)
    assert 2 * len(pl) == dpccp.ccp_count(g)
    assert exact.solve(w)[0] == pytest.approx(dpccp.solve(g).cost, rel=1e-5)


def test_invalid_plans_are_named():
    w = snowflake.query(4, 0)          # edges 0-1, 0-2, 0-3
    assert plans.invalid_reason([[[1, 2], 4], 8], w) is None
    assert "overlap" in plans.invalid_reason([[[1, 2], 2], 8], w)
    assert "not all" in plans.invalid_reason([[1, 2], 4], w)
    assert "no edge" in plans.invalid_reason([[[2, 4], 1], 8], w)
    assert "not one of" in plans.invalid_reason([[[1, 2], 4], 16], w)
    assert "children" in plans.invalid_reason([[1, 2, 4], 8], w)
    assert plans.invalid_reason([[[2, 4], 1], 8], w, require_ccp=False) \
        is None


def test_greedy_plans_are_valid_and_costed():
    for n in (12, 100):
        w = snowflake.query(n, 3)
        cost, plan = greedy.solve(w, F64)
        assert plans.invalid_reason(plan, w) is None
        assert plans.plan_cost(plan, w) == pytest.approx(cost, rel=1e-12)


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.01171875, 3.4e38, -2.5], np.float32)
    got = to_bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == 1.015625
    assert np.isinf(got[3]) and got[4] == -2.5
    w = musicbrainz.query(10, 4)
    c64, _ = exact.solve(w, F64)
    c16, _ = exact.solve(w, BF16)
    assert c16 != c64 and abs(c16 - c64) / c64 < 0.5
