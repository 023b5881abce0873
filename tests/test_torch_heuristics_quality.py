"""Invariants of the port's large-query heuristics, on the CPU: the port's
runs of the cases of ``tests/test_heuristics.py`` and of the tier-1 cases
of ``tests/test_uniondp_quality.py``.

Every heuristic returns a valid plan no cheaper than the exact optimum;
UnionDP's partitions stay within k and cover every unit once; a larger k
does not make IDP2 worse on average; batched IDP2 rounds do not regress
on one-subtree rounds; raw UnionDP (no GOO floor) is within ``GOO_EPS`` of
plain GOO on skewed PK-FK graphs, beats the size-greedy partitioner by a
clear geometric mean, and converges monotonically; the explain payload
and the opt-in GOO floor behave as in the reference.  All on
``device="cpu"`` with one torch thread.
"""
import math

import pytest

from repro.workloads import generators as rgen
from repro_torch.core import engine as teng
from repro_torch.core.plan import validate_plan
from repro_torch.heuristics import geqo, goo, idp, ikkbz, lindp, uniondp
from repro_torch.heuristics.common import UnitGraph
from repro_torch.heuristics.uniondp import _partition
from tests.test_torch_batch import one_torch_thread, port  # noqa: F401

GOO_EPS = 2e-3          # the reference's margin for "<= GOO"

GRAPHS = [rgen.star(10, 1), rgen.snowflake(12, 2), rgen.musicbrainz_query(11, 3),
          rgen.job_like(10, 4)]
SOLVERS = {
    "goo": goo.solve, "ikkbz": ikkbz.solve, "lindp": lindp.solve,
    "geqo": lambda g: geqo.solve(g, budget_s=2),
    "idp2": lambda g: idp.solve(g, k=6, device="cpu"),
    "uniondp": lambda g: uniondp.solve(g, k=6, device="cpu"),
}


def plan_shape(p):
    return p.rel_set if p.is_leaf else (plan_shape(p.left), plan_shape(p.right))


@pytest.mark.parametrize("g", GRAPHS, ids=["star10", "snow12", "mb11", "job10"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_heuristic_valid_and_at_least_optimal(g, solver):
    t = port(g)
    opt = teng.optimize(t, "mpdp", device="cpu")
    r = SOLVERS[solver](t)
    validate_plan(r.plan, t)
    assert r.cost >= opt.cost * (1 - 1e-4)


@pytest.mark.parametrize("rule", ["cost", "size"])
def test_uniondp_partition_sizes_bounded(rule):
    g = port(rgen.snowflake(40, 7))
    ug = UnitGraph(g)
    for k in (5, 10, 15):
        groups = _partition(ug, k, rule=rule)
        assert all(len(gr) <= k for gr in groups)
        assert sorted(i for gr in groups for i in gr) == list(range(g.n))


def test_idp2_bigger_k_not_worse_on_average():
    costs = {k: 0.0 for k in (4, 8)}
    for seed in range(3):
        g = port(rgen.snowflake(25, seed))
        for k in costs:
            costs[k] += idp.solve(g, k=k, device="cpu").cost
    assert costs[8] <= costs[4] * 1.05


def test_large_query_end_to_end():
    g = port(rgen.snowflake(120, 13))
    for r in (idp.solve(g, k=8, device="cpu"),
              uniondp.solve(g, k=8, device="cpu"), goo.solve(g)):
        validate_plan(r.plan, g)
        assert r.cost > 0


@pytest.mark.parametrize("n", [30, 60])
def test_heuristics_at_scale_beat_goo(n):
    g = port(rgen.snowflake(n, seed=n))
    goo_cost = goo.solve(g).cost
    for r in (idp.solve(g, k=8, device="cpu"),
              uniondp.solve(g, k=8, device="cpu")):
        validate_plan(r.plan, g)
        assert r.counters.evaluated > 0          # the exact core ran
        assert r.cost <= goo_cost * (1 + GOO_EPS)
        assert "+goo_floor" not in r.algorithm


def test_idp2_batched_rounds_match_single_target():
    for seed in (3, 4):
        g = port(rgen.musicbrainz_query(30, seed=seed))
        r1 = idp.solve(g, k=6, batch=1, device="cpu")
        rb = idp.solve(g, k=6, batch=4, device="cpu")
        validate_plan(r1.plan, g)
        validate_plan(rb.plan, g)
        assert rb.cost <= r1.cost * 1.05


# ------------------------------------------------ UnionDP quality, tier 1 --

SKEWED_FAST = [("mb", 30, 230), ("snow", 30, 30)]


def make_graph(kind, n, seed):
    if kind == "mb":
        return port(rgen.musicbrainz_query(n, seed=seed))
    return port(rgen.snowflake(n, seed=seed))


@pytest.mark.parametrize("kind,n,seed", SKEWED_FAST,
                         ids=[f"{k}{n}" for k, n, _ in SKEWED_FAST])
def test_raw_beats_goo_on_skewed_streams(kind, n, seed):
    g = make_graph(kind, n, seed)
    goo_cost = goo.solve(g).cost
    r = uniondp.solve(g, k=8, device="cpu")
    validate_plan(r.plan, g)
    assert "+goo_floor" not in r.algorithm
    assert r.cost <= goo_cost * (1 + GOO_EPS)


def test_cost_aware_beats_size_greedy():
    logs = []
    for kind, n, seed in SKEWED_FAST:
        g = make_graph(kind, n, seed)
        old = uniondp.solve(g, k=8, partition="size", reopt_rounds=0,
                            device="cpu")
        new = uniondp.solve(g, k=8, device="cpu")
        logs.append(math.log(old.cost / new.cost))
    assert math.exp(sum(logs) / len(logs)) >= 1.2


def test_reopt_convergence_monotone_and_bounded():
    g = make_graph("mb", 30, 230)
    r = uniondp.solve(g, k=8, reopt_rounds=4, device="cpu")
    rc = r.info["round_costs"]
    assert 1 <= len(rc) <= 1 + 4            # seed + accepted passes
    assert all(rc[i + 1] <= rc[i] for i in range(len(rc) - 1))
    assert rc[-1] == r.cost
    assert r.algorithm == "uniondp_mpdp+reopt"
    raw = uniondp.solve(g, k=8, reopt_rounds=0, device="cpu")
    assert raw.algorithm == "uniondp_mpdp"
    assert raw.info["round_costs"] == [raw.cost]
    assert raw.cost == rc[0]


def test_explain_payload_partitions():
    g = make_graph("snow", 30, 30)
    r = uniondp.solve(g, k=8, device="cpu")
    parts = r.info["partitions"]
    assert len(parts) >= 1
    assert sorted(v for gr in parts[0] for v in gr) == list(range(g.n))
    for rnd in parts:
        seen = [v for gr in rnd for v in gr]
        assert len(seen) == len(set(seen))   # disjoint groups


def test_goo_floor_is_opt_in():
    g = make_graph("mb", 30, 230)
    raw = uniondp.solve(g, k=8, device="cpu")
    floored = uniondp.solve(g, k=8, goo_floor=True, device="cpu")
    assert "+goo_floor" not in raw.algorithm
    assert floored.cost == raw.cost
    assert plan_shape(floored.plan) == plan_shape(raw.plan)
    fired = uniondp.solve(g, k=8, goo_floor=True, partition="size",
                          reopt_rounds=0, device="cpu")
    assert fired.algorithm.endswith("+goo_floor")
    rc = fired.info["round_costs"]
    assert rc[-1] == fired.cost
    assert all(rc[i + 1] <= rc[i] for i in range(len(rc) - 1))
    assert fired.info["goo_floor_raw_cost"] == rc[-2]
    assert fired.info["goo_floor_raw_cost"] > fired.cost


def test_unknown_partition_rule_raises():
    ug = UnitGraph(make_graph("snow", 30, 30))
    with pytest.raises(ValueError):
        _partition(ug, 8, rule="balanced")
