"""The large-query heuristics of the port (``repro_torch.heuristics``) vs the
JAX reference's (``repro.heuristics``), on the CPU.

* ``cost.np_boundary_cost`` (UnionDP's merge score) is bit-identical on
  seeded inputs, and ``UnitGraph`` keeps the reference's edges, aggregated
  selectivities, unit rows and ``as_joingraph`` subproblem wires exactly
  after scripted merges;
* GOO, IKKBZ, LinDP and GEQO (with a budget that never fires) give the
  reference's plan shapes and ``==`` costs;
* IDP2 and UnionDP are compared round by round: every call of the exact
  sub-solver (``engine.optimize_many`` in both packages) gets equal
  subproblems (``graph_to_wire``) and returns equal plan shapes.  A
  differing shape is allowed only as a shown tie (both subplans, costed by
  the port's ``cost_plan`` on that subproblem, within 1e-5 of each other):
  the test prints it and compares that query no further.  Without a tie the
  final plan shapes, costs (host ``cost_plan`` in both), ``Counters``,
  ``algorithm`` strings and the UnionDP explain payload are equal;
* typed graphs go through ``solve_typed`` the same way;
* ``pipeline=True`` runs equal the synchronous runs round by round, and
  so do runs under a learning ``policy=`` table (equal subproblems and
  costs, join trees up to mirrored equal-cost operands), and so do runs
  sharded by ``devices=`` or ``mesh=`` (cost also equal to the
  reference's sharded run); without a card a call that names no
  ``device`` raises.
"""
import math

import numpy as np
import pytest

from repro.core import cost as rcm, engine as reng
from repro.core.plan import join_plans as rjoin_plans
from repro.daemon.protocol import graph_to_wire
from repro.heuristics import common as rcommon, geqo as rgeqo, goo as rgoo
from repro.heuristics import idp as ridp, ikkbz as rikkbz, lindp as rlindp
from repro.heuristics import uniondp as runiondp
from repro.workloads import generators as rgen
from repro_torch.core import cost as tcm, engine as teng, joingraph as tjg
from repro_torch.core.plan import Plan, cost_plan, join_plans, validate_plan
from repro_torch.heuristics import common, geqo, goo, idp, ikkbz, lindp, uniondp
from tests.test_torch_batch import REL, one_torch_thread, port  # noqa: F401


def shape(p):
    return p.rel_set if p.is_leaf else (shape(p.left), shape(p.right))


def plan_of(s) -> Plan:
    """A port plan tree of shape ``s`` (costs left at 0: ``cost_plan``
    fills them)."""
    if isinstance(s, int):
        return Plan(rel_set=s, cost=0.0, rows_log2=0.0)
    left, right = plan_of(s[0]), plan_of(s[1])
    return Plan(rel_set=left.rel_set | right.rel_set, cost=0.0, rows_log2=0.0,
                left=left, right=right)


# ------------------------------------------------------- boundary cost ----

def test_np_boundary_cost_bit_exact():
    rng = np.random.default_rng(17)
    ra = rng.uniform(0.0, 70.0, 4000)
    rb = rng.uniform(0.0, 70.0, 4000)
    sel = -rng.uniform(0.0, 90.0, 4000)
    ra[:200] = rng.uniform(90.0, 130.0, 200)      # past LOG2_CAP
    sel[200:400] = -(ra[200:400] + rb[200:400]) - rng.uniform(0, 5, 200)
    for i in range(len(ra)):
        # Python floats (UnionDP's unit rows) and f32 (graph stats) alike
        args = ((float(ra[i]), float(rb[i]), float(sel[i])) if i % 2
                else (np.float32(ra[i]), np.float32(rb[i]), np.float32(sel[i])))
        want = rcm.np_boundary_cost(*args)
        got = tcm.np_boundary_cost(*args)
        assert got.dtype == np.float32
        assert got.tobytes() == np.asarray(want).tobytes(), (args, got, want)


# ----------------------------------------------------------- UnitGraph ----

def assert_same_unit_graph(ug_t, ug_r):
    assert ug_t.edges == ug_r.edges
    assert ug_t.sel_l2 == ug_r.sel_l2
    assert [type(v) for v in ug_t.sel_l2.values()] == \
        [type(v) for v in ug_r.sel_l2.values()]
    assert [(u.rel_set, u.rows_log2) for u in ug_t.units] == \
        [(u.rel_set, u.rows_log2) for u in ug_r.units]
    assert ug_t.sel_adjacency() == ug_r.sel_adjacency()


@pytest.mark.parametrize("g", [rgen.musicbrainz_query(30, seed=230),
                               rgen.snowflake(40, 3), rgen.clique(9, 2)],
                         ids=["mb30", "snow40", "clique9"])
def test_unit_graph_exact_after_scripted_merges(g):
    t = port(g)
    ug_r, ug_t = rcommon.UnitGraph(g), common.UnitGraph(t)
    rng = np.random.default_rng(g.n)
    assert_same_unit_graph(ug_t, ug_r)
    while ug_r.n > 3:
        # merge a random unit with up to three of its neighbours
        a = int(rng.integers(0, ug_r.n))
        nb = ug_r.neighbors(a)
        assert ug_t.neighbors(a) == nb
        idxs = sorted({a, *rng.permutation(nb)[: rng.integers(1, 4)].tolist()})
        assert ug_t.union_rows_log2(idxs) == ug_r.union_rows_log2(idxs)
        assert ug_t.rel_ids(idxs) == ug_r.rel_ids(idxs)
        if len(idxs) > 1:
            i, j = idxs[:2]
            assert ug_t.join_rows_log2(i, j) == ug_r.join_rows_log2(i, j)
        jr, _ = ug_r.as_joingraph(idxs)
        jt, _ = ug_t.as_joingraph(idxs)
        assert tjg.graph_to_wire(jt) == graph_to_wire(jr)
        pr, pt = ug_r.units[idxs[0]].plan, ug_t.units[idxs[0]].plan
        for k in idxs[1:]:
            pr = rjoin_plans(pr, ug_r.units[k].plan, g)
            pt = join_plans(pt, ug_t.units[k].plan, t)
        ug_r.merge(idxs, pr)
        ug_t.merge(idxs, pt)
        assert_same_unit_graph(ug_t, ug_r)
        assert ug_t.units[-1].plan.cost == ug_r.units[-1].plan.cost
    jr, _ = ug_r.as_joingraph()
    jt, _ = ug_t.as_joingraph()
    assert tjg.graph_to_wire(jt) == graph_to_wire(jr)


# ------------------------------------------------------ host heuristics ----

HOST_GRAPHS = [("star10", rgen.star(10, 1)), ("job10", rgen.job_like(10, 4)),
               ("snow25", rgen.snowflake(25, 1)),
               ("mb30", rgen.musicbrainz_query(30, seed=230)),
               ("snow40", rgen.snowflake(40, 3)), ("cycle12", rgen.cycle(12, 2))]
HOST = {
    "goo": (rgoo.solve, goo.solve),
    "ikkbz": (rikkbz.solve, ikkbz.solve),
    "lindp": (rlindp.solve, lindp.solve),
    # generations bind: a budget of 1e9 s never fires
    "geqo": (lambda g: rgeqo.solve(g, generations=60, budget_s=1e9, seed=5),
             lambda g: geqo.solve(g, generations=60, budget_s=1e9, seed=5)),
    "idp2_lindp": (lambda g: ridp.solve(g, k=10, subsolver="lindp"),
                   lambda g: idp.solve(g, k=10, subsolver="lindp")),
}


@pytest.mark.parametrize("name,g", HOST_GRAPHS, ids=[c[0] for c in HOST_GRAPHS])
@pytest.mark.parametrize("solver", list(HOST))
def test_host_heuristics_match_reference(name, g, solver):
    ref_solve, port_solve = HOST[solver]
    ref, got = ref_solve(g), port_solve(port(g))
    validate_plan(got.plan, port(g))
    assert got.algorithm == ref.algorithm
    assert shape(got.plan) == shape(ref.plan)
    assert got.cost == ref.cost


def test_ikkbz_orders_and_lindp_tables_match():
    for g in (rgen.musicbrainz_query(30, seed=230), rgen.snowflake(40, 3)):
        t = port(g)
        assert ikkbz.spanning_tree(t) == rikkbz.spanning_tree(g)
        order = rikkbz.best_order(g)
        assert ikkbz.best_order(t) == order
        assert ikkbz._cout_l2(t, order) == rikkbz._cout_l2(g, order)
        for a, b in zip(lindp._interval_tables(t, order),
                        rlindp._interval_tables(g, order)):
            assert a.tobytes() == b.tobytes()


# ---------------------------------------------- IDP2 and UnionDP rounds ----

class Rounds:
    """Spies on the exact sub-solver of both packages: per
    ``optimize_many`` call, the subproblems' wires and the plan shapes that
    came back."""

    def __init__(self, monkeypatch):
        self.calls = {"ref": [], "port": []}
        for key, mod, wire in (("ref", reng, graph_to_wire),
                               ("port", teng, tjg.graph_to_wire)):
            def spy(graphs, *a, _real=mod.optimize_many, _log=self.calls[key],
                    _wire=wire, **kw):
                rs = _real(graphs, *a, **kw)
                _log.append(([_wire(g) for g in graphs],
                             [shape(r.plan) for r in rs]))
                return rs
            monkeypatch.setattr(mod, "optimize_many", spy)

    def compare(self, label, ref, got) -> bool:
        """Round by round; returns False (and prints it) where a shown tie
        ended the comparison, True where everything matched to the end."""
        ref_calls, port_calls = self.calls["ref"], self.calls["port"]
        assert port_calls, f"{label}: the sub-solver never ran"
        for i, ((rw, rs), (pw, ps)) in enumerate(zip(ref_calls, port_calls)):
            assert pw == rw, f"{label}: call {i} got other subproblems"
            if ps == rs:
                continue
            for j, (w, a, b) in enumerate(zip(pw, rs, ps)):
                if a == b:
                    continue
                sub = tjg.graph_from_wire(w)
                ca = cost_plan(plan_of(a), sub).cost
                cb = cost_plan(plan_of(b), sub).cost
                assert math.isclose(ca, cb, rel_tol=REL), \
                    f"{label}: call {i} subproblem {j}: {cb} vs {ca}, no tie"
                print(f"{label}: call {i} subproblem {j} (n={sub.n}) is a "
                      f"tie broken by rounding ({cb!r} vs {ca!r}); compared "
                      f"no further")
            return False
        assert len(port_calls) == len(ref_calls)
        assert got.algorithm == ref.algorithm
        assert shape(got.plan) == shape(ref.plan)
        assert got.cost == ref.cost
        assert (got.counters.evaluated, got.counters.ccp) == \
            (ref.counters.evaluated, ref.counters.ccp)
        assert got.info == ref.info
        print(f"{label}: {len(port_calls)} sub-solver calls, "
              f"{sum(len(w) for w, _ in port_calls)} subproblems, all equal")
        return True


ROUND_GRAPHS = [("snow25", rgen.snowflake(25, 1)), ("snow32", rgen.snowflake(32, 2)),
                ("snow40", rgen.snowflake(40, 3)),
                ("mb30", rgen.musicbrainz_query(30, seed=230))]
ROUND_CASES = {
    "idp2_batch1": (lambda g: ridp.solve(g, k=6, batch=1),
                    lambda g: idp.solve(g, k=6, batch=1, device="cpu")),
    "idp2_batch4": (lambda g: ridp.solve(g, k=6, batch=4),
                    lambda g: idp.solve(g, k=6, batch=4, device="cpu")),
    "uniondp_cost": (lambda g: runiondp.solve(g, k=6),
                     lambda g: uniondp.solve(g, k=6, device="cpu")),
    "uniondp_size": (lambda g: runiondp.solve(g, k=6, partition="size"),
                     lambda g: uniondp.solve(g, k=6, partition="size",
                                             device="cpu")),
}


@pytest.mark.parametrize("name,g", ROUND_GRAPHS, ids=[c[0] for c in ROUND_GRAPHS])
@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_rounds_match_reference(name, g, case, monkeypatch):
    ref_solve, port_solve = ROUND_CASES[case]
    rounds = Rounds(monkeypatch)
    ref = ref_solve(g)
    got = port_solve(port(g))
    validate_plan(got.plan, port(g))
    assert got.cost == cost_plan(got.plan, port(g)).cost
    rounds.compare(f"{case} {name}", ref, got)


@pytest.mark.parametrize("case", ["dpsub_k6", "small_k_whole", "max_rounds2"])
def test_idp2_options_match_reference(case, monkeypatch):
    g = rgen.musicbrainz_query(30, seed=230)
    kw = {"dpsub_k6": dict(k=6, subsolver="dpsub"),
          "small_k_whole": dict(k=12),        # 12-relation graph: one call
          "max_rounds2": dict(k=5, max_rounds=2)}[case]
    if case == "small_k_whole":
        g = rgen.musicbrainz_query(12, seed=7)
    rounds = Rounds(monkeypatch)
    ref = ridp.solve(g, **kw)
    got = idp.solve(port(g), device="cpu", **kw)
    validate_plan(got.plan, port(g))
    rounds.compare(f"idp2 {case}", ref, got)


def test_uniondp_options_match_reference(monkeypatch):
    """No re-optimization, the GOO floor forced to fire, and a k that
    forces the all-singletons fallback pairing."""
    g = rgen.musicbrainz_query(30, seed=230)
    for kw in (dict(k=8, reopt_rounds=0),
               dict(k=8, goo_floor=True, partition="size", reopt_rounds=0),
               dict(k=1, reopt_rounds=0)):
        rounds = Rounds(monkeypatch)
        ref = runiondp.solve(g, **kw)
        got = uniondp.solve(port(g), device="cpu", **kw)
        rounds.compare(f"uniondp {kw}", ref, got)


def test_partition_rules_match_reference():
    for g in (rgen.snowflake(40, 7), rgen.musicbrainz_query(30, seed=230)):
        ug_r, ug_t = rcommon.UnitGraph(g), common.UnitGraph(port(g))
        for k in (3, 5, 8, 15):
            for rule in ("cost", "size"):
                assert uniondp._partition(ug_t, k, rule) == \
                    runiondp._partition(ug_r, k, rule)


def test_idp_trees_and_targets_match_reference():
    """GOO merge tree, temp-table recost and the disjoint target choice."""
    g = rgen.musicbrainz_query(30, seed=230)
    ug_r, ug_t = rcommon.UnitGraph(g), common.UnitGraph(port(g))
    tr, tt = ridp._goo_tree(ug_r), idp._goo_tree(ug_t)
    ridp._recost(tr, ug_r)
    idp._recost(tt, ug_t)

    def walk(n):
        return ((sorted(n.uids), n.cost, n.rows_l2) if n.is_leaf else
                (sorted(n.uids), n.cost, n.rows_l2, walk(n.left), walk(n.right)))

    assert walk(tt) == walk(tr)
    for k, b in ((4, 1), (6, 4), (10, 3)):
        assert [sorted(n.uids) for n in idp._costly_disjoint_subtrees(tt, k, b)] \
            == [sorted(n.uids) for n in ridp._costly_disjoint_subtrees(tr, k, b)]
    plan = rgoo.solve(g).plan
    pr, pt = ridp.tree_from_plan(plan), idp.tree_from_plan(plan_of(shape(plan)))
    ridp._recost(pr, ug_r)
    idp._recost(pt, ug_t)
    assert walk(pt) == walk(pr)


# --------------------------------------------------------------- typed ----

TYPED = [("mb20", rgen.typed_query(20, seed=11, base="musicbrainz")),
         ("job24", rgen.typed_query(24, seed=3))]


@pytest.mark.parametrize("name,g", TYPED, ids=[c[0] for c in TYPED])
def test_typed_through_solve_typed(name, g, monkeypatch):
    assert g.typed
    t = port(g)
    ref, got = rgoo.solve(g), goo.solve(t)
    assert (shape(got.plan), got.cost) == (shape(ref.plan), ref.cost)
    for label, rs, ps in (
            ("idp2", lambda: ridp.solve(g, k=6),
             lambda: idp.solve(t, k=6, device="cpu")),
            ("uniondp", lambda: runiondp.solve(g, k=6),
             lambda: uniondp.solve(t, k=6, device="cpu"))):
        rounds = Rounds(monkeypatch)
        ref, got = rs(), ps()
        validate_plan(got.plan, t)          # conflict rules included
        rounds.compare(f"typed {label} {name}", ref, got)
    ref = rcommon.solve_typed(g, rcommon.exact_subsolver("mpdp"))
    got = common.solve_typed(t, common.exact_subsolver("mpdp", device="cpu"))
    validate_plan(got, t)
    assert shape(got) == shape(ref) and got.cost == ref.cost


# ---------------------------------------------------- outside the slice ----

G_REF = rgen.snowflake(20, 1)
G = port(G_REF)
# refused until the sharding slice: a 2-shard mesh, by count or given
REFUSED = {
    "devices": lambda mesh: dict(devices=2),
    "mesh": lambda mesh: dict(mesh=mesh(2)),
}
# refused until the service slice (pipeline) and the deadlines-and-faults
# slice (policy)
SERVED = ("pipeline", "policy")


def sub_solver_calls(monkeypatch, solve, **kw):
    """One run of ``solve`` on G with the port's sub-solver spied on: per
    ``optimize_many`` call its subproblems' wires, plan shapes, costs and
    counters; then the result."""
    calls = []
    real = teng.optimize_many

    def spy(graphs, *a, **k):
        rs = real(graphs, *a, **k)
        calls.append(([tjg.graph_to_wire(g) for g in graphs],
                      [(shape(r.plan), r.cost, r.algorithm,
                        (r.counters.evaluated, r.counters.ccp)) for r in rs]))
        return rs
    monkeypatch.setattr(teng, "optimize_many", spy)
    r = solve(G, k=6, device="cpu", **kw)
    monkeypatch.setattr(teng, "optimize_many", real)
    return calls, r


@pytest.mark.parametrize("solver", ["idp", "uniondp"])
@pytest.mark.parametrize("option", [*REFUSED, *SERVED])
def test_unported_options_raise(solver, option, monkeypatch):
    """``pipeline=True`` equals the synchronous run call for call (equal
    subproblems, plan shapes, costs ``==`` and counters) and at the end,
    and so does a run under a policy table that learns chunks, drain
    windows and the re-optimization budget (a learned lane space may break
    an equal-cost tie another way, which sends later rounds apart;
    ``tests/test_torch_policy.py`` holds those single-shot); so does a
    run sharded over 2 logical CPU shards (``devices=2`` or a 2-shard
    ``mesh=``), whose cost also equals the reference's sharded run's."""
    solve = {"idp": idp.solve, "uniondp": uniondp.solve}[solver]
    if option == "policy":
        from repro_torch.core.policy import PolicyTable
        plain_calls, plain = sub_solver_calls(monkeypatch, solve)
        table = PolicyTable(learn_space=False)
        pol_calls, pol = sub_solver_calls(monkeypatch, solve, policy=table)
        assert pol_calls == plain_calls
        assert (shape(pol.plan), pol.cost, pol.algorithm, pol.info) == \
            (shape(plain.plan), plain.cost, plain.algorithm, plain.info)
        assert table.stats.observations > 0
        return
    if option in SERVED:
        sync_calls, sync = sub_solver_calls(monkeypatch, solve, pipeline=False)
        pipe_calls, pipe = sub_solver_calls(monkeypatch, solve, pipeline=True)
        assert len(sync_calls) > 1
        assert pipe_calls == sync_calls
        assert (shape(pipe.plan), pipe.cost, pipe.algorithm, pipe.info) == \
            (shape(sync.plan), sync.cost, sync.algorithm, sync.info)
        assert (pipe.counters.evaluated, pipe.counters.ccp) == \
            (sync.counters.evaluated, sync.counters.ccp)
        return
    from repro.core.shard import batch_mesh as rmesh
    from repro_torch.core.shard import batch_mesh as tmesh
    from repro_torch.hostdev import ensure_host_devices
    ensure_host_devices(4)
    plain_calls, plain = sub_solver_calls(monkeypatch, solve)
    kw = REFUSED[option](lambda n: tmesh(["cpu"] * n))
    shard_calls, sharded = sub_solver_calls(monkeypatch, solve, **kw)
    assert shard_calls == plain_calls
    assert (shape(sharded.plan), sharded.cost, sharded.algorithm,
            sharded.info) == (shape(plain.plan), plain.cost, plain.algorithm,
                              plain.info)
    rsolve = {"idp": ridp.solve, "uniondp": runiondp.solve}[solver]
    ref = rsolve(G_REF, k=6, **REFUSED[option](rmesh))
    assert math.isclose(sharded.cost, ref.cost, rel_tol=1e-5), \
        (sharded.cost, ref.cost)


def test_no_card_without_device_cpu_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    for solve in (idp.solve, uniondp.solve):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solve(G, k=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.exact_subsolver()(G)
