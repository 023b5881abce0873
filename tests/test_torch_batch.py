"""The batched slice of the port vs the JAX reference, on the CPU.

* ``graph_from_wire(graph_to_wire(g))`` rebuilds reference graphs bit for
  bit, and the port's generators give the reference's graphs seed for seed;
* phase A (``np_pairs_for_sets``) gives the reference's pair arrays;
* ``optimize_many(..., device="cpu")`` equals the reference's
  ``optimize_many``: ``algorithm`` strings and ``Counters`` exactly, costs
  to a relative 1e-5 (XLA and torch round ``exp2`` and fused products
  differently), plans equal or a tie broken by that rounding (both plans,
  costed by the port's ``cost_plan``, within 1e-5 of each other);
* the queries no batched lane space serves (``dpsize``, ``dpccp``,
  ``mpdp_tree`` on a cyclic graph, n > 16) go to the solo engine and give
  the reference's results, or its error; a typed query (non-inner edges)
  runs batched and gives the reference's results;
* ``cache=``, ``pipeline=True``, ``policy=``, ``config.deadline_s`` and
  the sharded options (``devices=``, ``mesh=``, on logical CPU shards)
  give the reference's results, and no card without ``device="cpu"``
  raises.
"""
import math
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import batch as rbatch, blocks as rbl, bitset as rbs
from repro.core.plancache import PlanCache as RPlanCache
from repro.daemon.protocol import graph_to_wire
from repro.workloads import generators as rgen
from repro_torch.core import batch as tbatch, blocks as tbl
from repro_torch.core import joingraph as tjg
from repro_torch.core.plan import Plan, cost_plan, validate_plan
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.workloads import generators as tgen
from tests.helpers import rand_graph

REL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test (imported by the other port test files):
    the suite runs in several worker processes at once, and torch's
    parallel regions on chunk-sized tensors stall when the workers'
    threads outnumber the cores.  No result depends on the thread
    count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(g):
    return tjg.graph_from_wire(graph_to_wire(g))


# ------------------------------------------------------------- graph codec --

WIRE_CASES = [rgen.musicbrainz_query(14, 2), rgen.clique(6, 1),
              rgen.typed_query(9, seed=3), rgen.typed_query(8, seed=5,
                                                            base="star"),
              *rgen.mixed_joins_stream(4, seed=1)]


@pytest.mark.parametrize("g", WIRE_CASES, ids=[f"w{i}" for i in range(len(WIRE_CASES))])
def test_graph_from_wire_bit_identical(g):
    t = port(g)
    assert (t.n, t.edges, t.names, t.kinds, t.ldirs) == \
        (g.n, g.edges, g.names, g.kinds, g.ldirs)
    assert t.log2_card.tobytes() == np.asarray(g.log2_card, np.float32).tobytes()
    assert t.log2_sel.tobytes() == np.asarray(g.log2_sel, np.float32).tobytes()
    assert (t.tes_l, t.tes_r, t.typed) == (tuple(g.tes_l), tuple(g.tes_r), g.typed)
    if g.fan_l2 is None:
        assert t.fan_l2 is None
    else:
        assert t.fan_l2.tobytes() == g.fan_l2.tobytes()
    assert tjg.graph_to_wire(t) == graph_to_wire(g)


GEN_CASES = [("star", (9, 4)), ("snowflake", (13, 2)), ("chain", (11, 5)),
             ("cycle", (7, 6)), ("clique", (6, 7)), ("job_like", (12, 8)),
             ("musicbrainz_query", (16, 9)), ("musicbrainz_query", (40, 1))]


@pytest.mark.parametrize("name,args", GEN_CASES, ids=[c[0] for c in GEN_CASES])
def test_generators_match_seed_for_seed(name, args):
    assert tjg.graph_to_wire(getattr(tgen, name)(*args)) == \
        graph_to_wire(getattr(rgen, name)(*args))


def test_mixed_stream_matches():
    for ref, got in zip(rgen.mixed_stream(12, seed=3),
                        tgen.mixed_stream(12, seed=3)):
        assert tjg.graph_to_wire(got) == graph_to_wire(ref)


def test_device_graph_matches_reference():
    from repro.core.joingraph import DeviceGraph as RefDeviceGraph
    for g in WIRE_CASES[:2] + [rgen.snowflake(16, 2)]:
        want = RefDeviceGraph.from_graph(g)
        got = tjg.DeviceGraph.from_graph(port(g), "cpu")
        assert (got.n, got.m, got.nmax, got.emax) == \
            (want.n, want.m, want.nmax, want.emax)
        for f in ("adj", "emask_u", "emask_v", "esel_l2", "card_l2"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))


# ----------------------------------------------------------------- phase A --

BLOCK_CASES = [(rand_graph(n, extra, seed), cap) for n, extra, seed, cap in
               [(7, 3, 1, 24), (9, 5, 2, 24), (11, 6, 3, 24), (10, 0, 4, 24),
                (8, 6, 5, 2)]] + [(rgen.clique(9, 1), 24),
                                  (rgen.musicbrainz_query(12, 7), 24)]


@pytest.mark.parametrize("g,cyc_cap", BLOCK_CASES,
                         ids=[f"b{i}" for i in range(len(BLOCK_CASES))])
def test_pairs_for_sets_match_reference(g, cyc_cap):
    nmax = rbs.nmax_bucket(g.n)
    emax = max(8, ((g.m + 7) // 8) * 8)
    adj = np.zeros(nmax, np.int32)
    eu = np.full(emax, -1, np.int32)
    ev = np.full(emax, -1, np.int32)
    live = np.zeros(emax, bool)
    for i, (u, v) in enumerate(g.edges):
        adj[u] |= 1 << v
        adj[v] |= 1 << u
        eu[i], ev[i], live[i] = u, v, True
    adj_l = g.adjacency()
    by_level = {}
    for s in range(1, 1 << g.n):
        if rbs.np_is_connected(s, adj_l):
            by_level.setdefault(bin(s).count("1"), []).append(s)
    tg = port(g)
    for k, sets in sorted(by_level.items()):
        if k < 2:
            continue
        sets = np.array(sets, np.int32)
        want = rbl.np_pairs_for_sets(sets, g, *map(jnp.asarray, (adj, eu, ev, live)),
                                     nmax=nmax, emax=emax, cyc_cap=cyc_cap)
        got = tbl.np_pairs_for_sets(sets, tg, *map(torch.from_numpy, (adj, eu, ev, live)),
                                    nmax=nmax, emax=emax, cyc_cap=cyc_cap)
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, np.asarray(b))


def test_find_blocks_oracle_copy():
    edges9 = [(0, 1), (1, 2), (2, 3), (0, 3), (0, 2), (3, 4), (4, 8), (5, 6),
              (6, 7), (7, 8), (5, 8)]
    got = sorted(tbl.np_find_blocks((1 << 9) - 1, edges9, 9))
    assert got == [0b1111, 0b11000, 0b100010000, 0b111100000]


# ------------------------------------------------------------ optimize_many --

def _shape(p):
    return p.rel_set if p.is_leaf else (_shape(p.left), _shape(p.right))


def ulp_diff(a: float, b: float) -> int:
    ia = np.array([a], np.float32).view(np.int32)[0]
    ib = np.array([b], np.float32).view(np.int32)[0]
    return abs(int(ia) - int(ib))


def assert_same_results(graphs, ref, got):
    """Counters exact, costs within REL, plans equal or a rounding tie."""
    worst = 0
    for g, r, t in zip(graphs, ref, got):
        tg = port(g)
        assert t.algorithm == r.algorithm
        assert (t.counters.evaluated, t.counters.ccp) == \
            (r.counters.evaluated, r.counters.ccp)
        assert math.isclose(t.cost, r.cost, rel_tol=REL), (t.cost, r.cost)
        worst = max(worst, ulp_diff(t.cost, r.cost))
        validate_plan(t.plan, tg)
        if _shape(t.plan) != _shape(r.plan):
            # only a tie broken by rounding may choose another plan
            ct = cost_plan(t.plan, tg).cost
            cr = cost_plan(tjg_plan(r.plan), tg).cost
            assert math.isclose(ct, cr, rel_tol=REL), (ct, cr)
    return worst


def tjg_plan(p):
    """A reference plan tree rebuilt as a port plan (shape only)."""
    if p.is_leaf:
        return Plan(rel_set=p.rel_set, cost=0.0, rows_log2=0.0)
    left, right = tjg_plan(p.left), tjg_plan(p.right)
    return Plan(rel_set=left.rel_set | right.rel_set, cost=0.0, rows_log2=0.0,
                left=left, right=right)


STREAM = rgen.mixed_stream(6, seed=3, sizes=(5, 6, 7, 8, 9, 10))   # n=9, 10 -> nmax 16
SMALL = [rgen.chain(8, 1), rgen.cycle(7, 2), rgen.star(6, 3), rgen.job_like(8, 4),
         rgen.clique(5, 5), rgen.snowflake(7, 6)]


@pytest.mark.parametrize("algorithm", ["auto", "dpsub", "mpdp_general"])
def test_optimize_many_matches_reference(algorithm):
    graphs = STREAM + SMALL
    ref = rbatch.optimize_many(graphs, algorithm)
    got = tbatch.optimize_many([port(g) for g in graphs], algorithm, device="cpu")
    worst = assert_same_results(graphs, ref, got)
    print(f"{algorithm}: largest cost difference {worst} ulp")
    assert worst <= 8, f"largest cost difference {worst} ulp"


@pytest.mark.parametrize("algorithm,chunk,flight",
                         [("auto", 512, 2), ("mpdp_tree", 1024, 32),
                          ("mpdp", 32768, 3)])
def test_optimize_many_chunking_and_flights(algorithm, chunk, flight):
    graphs = [g for g in STREAM + SMALL if algorithm != "mpdp_tree" or g.is_tree()]
    ref = rbatch.optimize_many(graphs, algorithm, chunk=chunk, max_flight=flight)
    got = tbatch.optimize_many([port(g) for g in graphs], algorithm, chunk=chunk,
                               max_flight=flight, device="cpu")
    assert_same_results(graphs, ref, got)


def test_leaf_queries_and_stats():
    one = tjg.JoinGraph.make(1, [], [1000.0], [])
    g = port(rgen.chain(5, 1))
    r = tbatch.optimize_many([one, g], device="cpu")
    assert r[0].plan.is_leaf and r[0].algorithm == "auto"
    eng = tbatch.BatchEngine([g], algorithm="dpsub", device="cpu")
    eng.run()
    assert eng.stats == {"launches": {k: 0 for k in eng.stats["launches"]},
                         "pipeline": False}


# --------------------------------------------------------- outside the slice --

G6_REF = rgen.cycle(6, 1)
G6 = port(G6_REF)
EXCLUDED = {
    "devices": dict(devices=2),
    "mesh": dict(mesh=2),
    "dpsize": dict(algorithm="dpsize"),
    "dpccp": dict(algorithm="dpccp"),
    "tree_on_cycle": dict(algorithm="mpdp_tree"),
}
# outside the batched lane spaces, but served by the solo engine
SOLO_ROUTED = ("dpsize", "dpccp", "tree_on_cycle")
# outside the first slices: cache and pipeline served since the service
# slice, policy and deadline since the deadlines-and-faults slice
SERVED = ("cache", "pipeline", "policy", "deadline")
# served since the sharding slice: a 2-shard mesh (the reference's of its
# emulated devices, the port's of logical CPU shards)
SHARDED = ("devices", "mesh")


def assert_sharded_matches_reference(graphs, case):
    """``devices=2`` or a 2-shard ``mesh=``: the port's results equal its
    single-device run bit for bit and the reference's sharded run."""
    from repro.core.shard import batch_mesh as rmesh
    from repro_torch.core.shard import batch_mesh as tmesh
    from repro_torch.hostdev import ensure_host_devices
    ensure_host_devices(4)
    kw = EXCLUDED[case]
    ref = rbatch.optimize_many(graphs, **(
        {"mesh": rmesh(kw["mesh"])} if case == "mesh" else kw))
    ported = [port(g) for g in graphs]
    got = tbatch.optimize_many(ported, device="cpu", **(
        {"mesh": tmesh(["cpu"] * kw["mesh"])} if case == "mesh" else kw))
    plain = tbatch.optimize_many(ported, device="cpu")
    for a, b in zip(got, plain):
        assert (a.cost, _shape(a.plan), a.counters.evaluated, a.algorithm) \
            == (b.cost, _shape(b.plan), b.counters.evaluated, b.algorithm)
    assert_same_results(graphs, ref, got)


def assert_solo_route_matches_reference(graphs, **kw):
    """The port gives the reference's results, or fails the same way."""
    try:
        ref = rbatch.optimize_many(graphs, **kw)
    except Exception as e:
        with pytest.raises(type(e), match=re.escape(str(e))):
            tbatch.optimize_many([port(g) for g in graphs], device="cpu", **kw)
        return
    got = tbatch.optimize_many([port(g) for g in graphs], device="cpu", **kw)
    assert_same_results(graphs, ref, got)


def assert_served_matches_reference(case):
    """``cache=`` (a duplicate in the stream, then a second pass of hits),
    ``pipeline=True``, a fresh ``policy=`` table and a generous
    ``deadline_s`` give the reference's results (and cache counts)."""
    graphs = [G6_REF, rgen.chain(5, 2), G6_REF]
    ported = [port(g) for g in graphs]
    if case in ("pipeline", "policy", "deadline"):
        from repro.core.policy import PolicyTable as RPolicyTable
        from repro_torch.core.policy import PolicyTable as TPolicyTable
        kw = {"pipeline": (dict(pipeline=True), dict(pipeline=True)),
              "policy": (dict(policy=RPolicyTable()),
                         dict(policy=TPolicyTable())),
              "deadline": (dict(config=rbatch.OptimizerConfig(
                  deadline_s=3600.0)), dict(config=tbatch.OptimizerConfig(
                      deadline_s=3600.0)))}[case]
        ref = rbatch.optimize_many(graphs, **kw[0])
        got = tbatch.optimize_many(ported, device="cpu", **kw[1])
        assert_same_results(graphs, ref, got)
        assert not any("degraded" in r.info for r in got)
        return
    rc, tc = RPlanCache(), TPlanCache()
    for _ in range(2):
        ref = rbatch.optimize_many(graphs, cache=rc)
        got = tbatch.optimize_many(ported, cache=tc, device="cpu")
        assert_same_results(graphs, ref, got)
        assert vars(tc.stats) == vars(rc.stats)
    assert all(r.algorithm.startswith("cache[") for r in got)


@pytest.mark.parametrize("case", [*SERVED, *EXCLUDED])
def test_outside_slice_raises(case):
    """Options outside the batched slice: the ones the solo engine serves
    (``dpsize``, ``dpccp``, ``mpdp_tree`` on a cycle), the plan cache, the
    pipelined driver, the policy, the deadline and the sharded ones equal
    the reference."""
    if case in SERVED:
        assert_served_matches_reference(case)
        return
    if case in SHARDED:
        assert_sharded_matches_reference(STREAM[:4] + [G6_REF], case)
        return
    assert case in SOLO_ROUTED
    assert_solo_route_matches_reference([G6_REF], **EXCLUDED[case])


@pytest.mark.parametrize("g", [rgen.typed_query(7, seed=2), rgen.chain(17, 1)],
                         ids=["typed", "nmax24"])
def test_outside_slice_graphs_raise(g):
    """Graphs that were outside the batched slice: a typed one now runs
    batched, an nmax-24 one goes to the solo engine; both equal the
    reference."""
    if g.typed:
        ref = rbatch.optimize_many([g])
        got = tbatch.optimize_many([port(g)], device="cpu")
        assert got[0].algorithm == "batch_mpdp_tree"
        assert_same_results([g], ref, got)
        return
    assert_solo_route_matches_reference([g])


def test_no_card_raises_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.optimize_many([G6])
