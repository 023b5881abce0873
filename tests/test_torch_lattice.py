"""The intra-query lattice of the port (``core.lattice``, the lane
partitioner and ``min_left_commit``) vs the JAX reference's, on the CPU.

The mirror of ``tests/test_lattice_shard.py`` (all but
``test_shard_map_shim_single_source``: the port has no ``shard_map``).
The port's meshes are made of logical CPU shards
(``repro_torch.hostdev.ensure_host_devices(4)``); the reference's of the
4 emulated host devices ``tests/conftest.py`` asks for.

* ``LatticeShardedEngine`` on 1, 2 and 4 shards, in all three lane
  spaces, synchronous and pipelined, typed graphs too, equals the port's
  single-device ``BatchEngine`` bit for bit (cost ``==``, plan shape,
  ``Counters``) with equal memo replicas, and the reference's lattice on
  its 4 devices: ``Counters``, collectives and dispatches exact,
  costs within a relative 1e-5 (the largest ULP distance printed), plans
  equal or a shown rounding tie;
* ``partition_lanes`` gives the reference's offsets and errors;
  ``min_left_commit`` runs once per committed level;
* the fake-clock deadline gives the reference's degraded dicts;
* the dispatcher, the service and UnionDP route 17-20-relation queries to
  the lattice only with a mesh, and a frontier query (n = 17, past the
  batched cap) solves exactly on 4 shards.
"""
import math

import numpy as np
import pytest

from repro.core import batch as rbatch, lattice as rlattice
from repro.distributed.sharding import partition_lanes as rpartition
from repro.workloads import generators as rgen
from repro_torch.core import engine as teng
from repro_torch.core import lattice as tlattice, service as tservice
from repro_torch.core.batch import NMAX_BATCH, BatchEngine, optimize_many
from repro_torch.core.lattice import (NMAX_LATTICE, LatticeShardedEngine,
                                      lattice_bucket, optimize_lattice)
from repro_torch.core.plan import validate_plan
from repro_torch.core.shard import batch_mesh
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import partition_lanes
from repro_torch.hostdev import ensure_host_devices, host_device_count
from repro_torch.kernels import ops
from tests.helpers import given, rand_graph, settings, st
from tests.test_lattice_shard import mixed_graphs, tree_graphs
from tests.test_torch_batch import (assert_same_results, one_torch_thread,  # noqa: F401
                                    port)
from tests.test_torch_faults import assert_same_degraded, fake_clocks

ensure_host_devices(4)
NDEV = host_device_count()
CPU = {"device": "cpu"}
SPACES = ("dpsub", "mpdp_tree", "mpdp_general")


def shape(p):
    return p.rel_set if p.is_leaf else (shape(p.left), shape(p.right))


def cpu_mesh(n):
    """A mesh of n logical CPU shards."""
    return batch_mesh(["cpu"] * n)


def graphs_for(space):
    return tree_graphs() if space == "mpdp_tree" else mixed_graphs()


def assert_replicas_equal(eng):
    mc, ml = eng.memo_replicas()
    assert mc.shape == (eng.D, eng.flat)
    for d in range(1, eng.D):
        assert (mc[d] == mc[0]).all()
        assert (ml[d] == ml[0]).all()


@pytest.fixture(scope="module")
def batched():
    """The port's single-device ``BatchEngine`` per graph and lane space."""
    return {space: [BatchEngine([port(g)], algorithm=space, **CPU).run()[0]
                    for g in graphs_for(space)] for space in SPACES}


@pytest.fixture(scope="module")
def reference():
    """The reference's lattice runs on its 4 devices per space, with their
    engines' collectives and dispatches (its results and counts are the
    same on 1 and 2 devices, which its own suite holds; every level of
    these graphs fits one chunk, so the dispatches are too)."""
    out = {}
    for space in SPACES:
        runs = []
        for g in graphs_for(space):
            eng = rlattice.LatticeShardedEngine(g, 4, algorithm=space)
            runs.append((eng.run()[0], eng.collectives,
                         eng.chunks_dispatched))
        out[space] = runs
    return out


@pytest.fixture(scope="module")
def frontier():
    """n = 17 past the batched cap: the port's solo result."""
    g = port(rgen.snowflake(17, seed=3))
    return g, teng.optimize(g, "auto", **CPU)


# ======================================================= lane partitioner ==

@settings(max_examples=60, deadline=None)
@given(st.integers(0, 5000), st.integers(1, 4))
def test_partition_lanes_properties(total, parts):
    offs = partition_lanes(total, parts)
    assert offs.dtype == np.int64
    np.testing.assert_array_equal(offs, rpartition(total, parts))
    assert offs.shape == (parts + 1,)
    assert offs[0] == 0 and offs[-1] == total
    sizes = np.diff(offs)
    assert (sizes >= 0).all()
    assert sizes.max() - sizes.min() <= 1
    got = np.concatenate([np.arange(offs[d], offs[d + 1])
                          for d in range(parts)])
    assert np.array_equal(got, np.arange(total))


def test_partition_lanes_rejects_bad_inputs():
    for args in ((10, 0), (-1, 2)):
        with pytest.raises(ValueError) as want:
            rpartition(*args)
        with pytest.raises(ValueError, match=str(want.value)):
            partition_lanes(*args)


def test_lattice_bucket():
    assert (tlattice.LATTICE_BUCKETS, NMAX_LATTICE) == \
        (rlattice.LATTICE_BUCKETS, rlattice.NMAX_LATTICE)
    assert lattice_bucket(6) == 8
    assert lattice_bucket(16) == 16
    assert lattice_bucket(17) == 18
    assert lattice_bucket(NMAX_LATTICE) == NMAX_LATTICE
    with pytest.raises(ValueError):
        lattice_bucket(NMAX_LATTICE + 1)


# ================================================ differential: lane spaces ==

@pytest.mark.parametrize("devices", [1, 2, 4])
@pytest.mark.parametrize("space", SPACES)
def test_lattice_bit_identical(space, devices, batched, reference):
    graphs = graphs_for(space)
    got, worst = [], 0
    for g, b, (r, r_coll, r_chunks) in zip(graphs, batched[space],
                                            reference[space]):
        before = coll.STATS.snapshot()
        eng = LatticeShardedEngine(port(g), cpu_mesh(devices),
                                   algorithm=space)
        t = eng.run()[0]
        assert t.cost == b.cost
        assert shape(t.plan) == shape(b.plan)
        assert (t.counters.evaluated, t.counters.ccp) == \
            (b.counters.evaluated, b.counters.ccp)
        assert t.algorithm == f"lattice_{space}"
        assert_replicas_equal(eng)
        assert eng.collectives == r_coll == g.n - 1
        assert coll.STATS.snapshot() - before == g.n - 1
        # each level's ranks fit one filter chunk: equal dispatches
        assert eng.chunks_dispatched == r_chunks
        got.append(t)
    worst = assert_same_results(graphs, [x[0] for x in reference[space]],
                                got)
    print(f"lattice {space} on {devices} shards: largest cost difference to "
          f"the reference {worst} ulp")


@pytest.mark.parametrize("devices", [2, 4])
def test_lattice_pipelined_bit_identical(devices, batched, reference):
    for space in SPACES:
        g = graphs_for(space)[0]
        eng = LatticeShardedEngine(port(g), cpu_mesh(devices),
                                   algorithm=space, pipeline=True)
        r = eng.run()[0]
        b = batched[space][0]
        assert (r.cost, shape(r.plan)) == (b.cost, shape(b.plan))
        assert_replicas_equal(eng)
        assert_same_results([g], [reference[space][0][0]], [r])


@pytest.mark.parametrize("devices", [2])
def test_lattice_pallas_interpret(devices, monkeypatch, batched):
    """The reference's lattice on its Pallas kernels (interpret mode)
    against the port's on the plain versions of its CUDA kernels, in the
    DPSUB lane space (the sharding mirror takes MPDP-general)."""
    monkeypatch.setenv("REPRO_PALLAS", "1")
    for space in ("dpsub",):
        g = graphs_for(space)[1]
        ref = rlattice.LatticeShardedEngine(g, devices, algorithm=space)
        assert ref.pallas
        got = LatticeShardedEngine(port(g), cpu_mesh(devices),
                                   algorithm=space).run()[0]
        assert got.cost == batched[space][1].cost
        assert_same_results([g], ref.run(), [got])


@settings(max_examples=6, deadline=None)
@given(st.integers(4, 9), st.integers(0, 3), st.integers(1, 3),
       st.integers(0, 10_000))
def test_lattice_random_graphs_property(n, extra, devices, seed):
    """Uneven lane counts, random topologies: lattice == the port's solo
    engine, replicas equal, at any shard count <= 3."""
    g = port(rand_graph(n, extra, seed))
    s = teng.optimize(g, "auto", **CPU)
    space = "mpdp_tree" if g.is_tree() else "mpdp_general"
    eng = LatticeShardedEngine(g, cpu_mesh(min(devices, NDEV)),
                               algorithm=space)
    r = eng.run()[0]
    assert r.cost == s.cost
    assert_replicas_equal(eng)


TYPED = {1: ("dpsub", rgen.typed_query(8, seed=2)),
         2: ("mpdp_general", rgen.typed_query(9, seed=3)),
         4: ("mpdp_tree", rgen.typed_query(8, seed=5, base="star"))}


@pytest.mark.parametrize("devices", sorted(TYPED))
def test_lattice_typed_matches_reference(devices):
    """Typed graphs (replicated conflict arrays), one lane space a shard
    count."""
    space, g = TYPED[devices]
    b = BatchEngine([port(g)], algorithm=space, **CPU).run()[0]
    got = LatticeShardedEngine(port(g), cpu_mesh(devices),
                               algorithm=space).run()[0]
    assert (got.cost, shape(got.plan)) == (b.cost, shape(b.plan))
    ref = rlattice.LatticeShardedEngine(g, devices, algorithm=space).run()
    assert_same_results([g], ref, [got])


# ============================================= collectives + no rebuilding ==

@pytest.mark.parametrize("devices", [2, 4])
def test_collectives_only_at_level_commit(devices, monkeypatch):
    g = port(rgen.chain(7, 11))
    before = coll.STATS.snapshot()
    calls = []
    real = coll.min_left_commit

    def spy(*a, **k):
        calls.append(len(a[3]))
        return real(*a, **k)

    monkeypatch.setattr(coll, "min_left_commit", spy)
    eng = LatticeShardedEngine(g, cpu_mesh(devices), algorithm="mpdp_tree")
    eng.run()
    assert eng.collectives == g.n - 1 == len(calls)
    assert calls == [devices] * (g.n - 1)      # one partial per shard
    assert coll.STATS.snapshot() - before == g.n - 1


@pytest.mark.parametrize("devices", [2])
def test_lattice_zero_retraces_on_repeat(devices):
    """Nothing is traced or rebuilt: a repeated shape launches nothing on
    the CPU (plain versions) and its stats keep the engine shape."""
    LatticeShardedEngine(port(rgen.chain(6, 21)), cpu_mesh(devices),
                         algorithm="mpdp_tree").run()
    eng = LatticeShardedEngine(port(rgen.chain(6, 22)), cpu_mesh(devices),
                               algorithm="mpdp_tree")
    eng.run()
    assert eng.stats == {"launches": {k: 0 for k in ops.LAUNCHES},
                         "pipeline": False}


def test_min_left_commit_semiring():
    """The combine: min cost over shards, then max left among the shards
    at a finite minimum (0 where every shard has INF), pad index dropped,
    every replica written."""
    import torch
    inf = float("inf")
    memo_c = [torch.full((8,), inf) for _ in range(3)]
    memo_l = [torch.zeros(8, dtype=torch.int32) for _ in range(3)]
    idx = torch.tensor([1, 4, 6, 8], dtype=torch.int64)     # 8 = pad
    cost = [torch.tensor([5.0, inf, 2.0, 0.0]),
            torch.tensor([5.0, inf, 3.0, 0.0]),
            torch.tensor([7.0, inf, 2.0, 0.0])]
    left = [torch.tensor([3, 9, 1, 7], dtype=torch.int32),
            torch.tensor([6, 9, 5, 7], dtype=torch.int32),
            torch.tensor([9, 9, 4, 7], dtype=torch.int32)]
    before = coll.STATS.snapshot()
    coll.min_left_commit(memo_c, memo_l, idx, cost, left, flat=8)
    assert coll.STATS.snapshot() == before + 1
    for c, lf in zip(memo_c, memo_l):
        assert c.tolist() == [inf, 5.0, inf, inf, inf, inf, 2.0, inf]
        assert lf.tolist() == [0, 6, 0, 0, 0, 0, 4, 0]


# ========================================================== frontier: n=17 ==

@pytest.mark.parametrize("devices", [4])
def test_frontier_exact_beyond_batch_cap(devices, frontier):
    """An NMAX-18 query (past the batched cap) solves exactly on 4 shards,
    equal to the solo engine and to the reference's lattice."""
    g, s = frontier
    assert g.is_tree()
    with pytest.raises(ValueError, match="nmax <= 16"):
        BatchEngine([g], algorithm="mpdp_tree", **CPU)
    rs = optimize_many([g], devices=devices, **CPU)
    assert rs[0].algorithm == "lattice_mpdp_tree"
    assert rs[0].cost == s.cost
    assert shape(rs[0].plan) == shape(s.plan)
    validate_plan(rs[0].plan, g)
    g_ref = rgen.snowflake(17, seed=3)
    ref = rbatch.optimize_many([g_ref], devices=devices)
    assert_same_results([g_ref], ref, rs)


# ============================================================== dispatcher ==

@pytest.mark.parametrize("devices", [2])
def test_dispatcher_small_queries_keep_batch_path(devices, batched):
    rs = optimize_many([port(g) for g in mixed_graphs()],
                       algorithm="mpdp_general", devices=devices, **CPU)
    for r, b in zip(rs, batched["mpdp_general"]):
        assert r.algorithm == "batch_mpdp_general"
        assert r.cost == b.cost


def test_dispatcher_no_mesh_keeps_solo_path(frontier):
    g, s = frontier
    rs = optimize_many([g], **CPU)
    assert rs[0].algorithm == "mpdp_tree"
    assert rs[0].cost == s.cost


@pytest.mark.parametrize("devices", [2])
def test_engine_optimize_lattice_kwarg(devices, batched, reference):
    g = graphs_for("mpdp_tree")[0]
    with pytest.warns(DeprecationWarning, match="lattice_devices"):
        r = teng.optimize(port(g), "auto", lattice_devices=devices, **CPU)
    assert r.algorithm == "lattice_mpdp_tree"
    assert r.cost == batched["mpdp_tree"][0].cost
    assert_same_results([g], [reference["mpdp_tree"][0][0]], [r])
    with pytest.warns(DeprecationWarning, match="lattice_mesh"):
        m = teng.optimize(port(g), "auto", lattice_mesh=["cpu"] * 3, **CPU)
    assert (m.algorithm, m.cost) == (r.algorithm, r.cost)


def test_optimize_lattice_rejects_spaceless_algorithms():
    for g, algo in ((rgen.cycle(5, 1), "mpdp_tree"),
                    (rgen.chain(5, 1), "dpsize")):
        with pytest.raises(ValueError) as want:
            rlattice.optimize_lattice(g, algorithm=algo, devices=1)
        assert "lane space" in str(want.value)
        with pytest.raises(ValueError, match="lane space"):
            optimize_lattice(port(g), algorithm=algo, devices=1, **CPU)


# ================================================= service admission tests ==

class _SpyLattice:
    """Engine spy: records the admission call, returns a canned result."""
    calls: list = []

    def __init__(self, g, mesh=None, chunk=None, algorithm=None,
                 pipeline=None, deadline_s=None, **kw):
        type(self).calls.append((g.n, algorithm))
        self._res = teng.optimize(g, "auto", **CPU)
        self._res.algorithm = f"lattice_{algorithm}"

    def run_levels(self):
        pass

    def collect(self):
        return [self._res]


@pytest.mark.parametrize("devices", [2])
def test_service_admits_oversized_to_lattice_flight(devices, monkeypatch):
    """A query past the batched cap is admitted to a lattice flight (spy
    engine), as in the reference's report."""
    from repro.core import service as rservice
    _SpyLattice.calls = []
    monkeypatch.setattr(tlattice, "LatticeShardedEngine", _SpyLattice)
    graphs = [rgen.chain(6, 1), rgen.snowflake(17, seed=3), rgen.star(5, 2)]
    res, rep = tservice.optimize_stream([port(g) for g in graphs],
                                        devices=devices, **CPU)
    assert _SpyLattice.calls == [(17, "mpdp_tree")]
    assert rep.lattice == 1
    latt = [f for f in rep.flights if f.lattice]
    assert len(latt) == 1
    assert latt[0].nmax == lattice_bucket(17) and latt[0].queries == [1]
    assert latt[0].telemetry.lattice
    assert res[1].algorithm == "lattice_mpdp_tree"
    assert res[0].algorithm == "batch_mpdp_tree"
    ref_flights, ref_solo = rservice.StreamOptimizer(devices=devices).admit(
        graphs, [0, 1, 2])
    flights, solo = tservice.StreamOptimizer(devices=devices, **CPU).admit(
        [port(g) for g in graphs], [0, 1, 2])
    assert [(f.nmax, f.space, f.queries, f.lattice) for f in flights] == \
        [(f.nmax, f.space, f.queries, f.lattice) for f in ref_flights]
    assert solo == ref_solo


@pytest.mark.parametrize("devices", [2])
def test_service_below_limit_byte_identical(devices, monkeypatch):
    class _Boom:
        def __init__(self, *a, **k):
            raise AssertionError("lattice engine spawned for a small query")

    monkeypatch.setattr(tlattice, "LatticeShardedEngine", _Boom)
    graphs = [port(g) for g in (rgen.chain(6, 1), rgen.cycle(6, 2),
                                rgen.star(5, 3))]
    res, rep = tservice.optimize_stream(graphs, devices=devices, **CPU)
    assert rep.lattice == 0
    many = optimize_many(graphs, devices=devices, **CPU)
    for r, m in zip(res, many):
        assert (r.cost, shape(r.plan), r.algorithm) == \
            (m.cost, shape(m.plan), m.algorithm)


# =========================================== heuristic composite threading ==

@pytest.mark.parametrize("devices", [4])
def test_uniondp_composite_routes_lattice(devices, monkeypatch, frontier):
    """UnionDP blocks past the batched cap ride the lattice through
    ``optimize_many(devices=...)``."""
    from repro_torch.heuristics import uniondp
    spawned = []
    real = tlattice.LatticeShardedEngine

    class _Counting(real):
        def __init__(self, g, *a, **k):
            spawned.append(g.n)
            super().__init__(g, *a, **k)

    monkeypatch.setattr(tlattice, "LatticeShardedEngine", _Counting)
    g, s = frontier
    r = uniondp.solve(g, k=17, devices=devices, reopt_rounds=0, **CPU)
    validate_plan(r.plan, g)
    assert spawned and all(NMAX_BATCH < n <= NMAX_LATTICE for n in spawned)
    assert shape(r.plan) == shape(s.plan)
    plain = uniondp.solve(g, k=17, reopt_rounds=0, **CPU)
    assert (r.cost, shape(r.plan)) == (plain.cost, shape(plain.plan))


# ================================================================ deadline ==

@pytest.mark.parametrize("pipeline", [False, True])
def test_lattice_deadline_fake_clock(pipeline, monkeypatch):
    """Under the fake clock both lattices expire at the same level and
    stitch the same degraded plan from the committed replica."""
    g = rgen.cycle(7, 2)
    for k in (2, 5):
        fake_clocks(monkeypatch)
        ref = rlattice.LatticeShardedEngine(g, 2, algorithm="mpdp_general",
                                            pipeline=pipeline,
                                            deadline_s=k - 1.5).run()
        got = LatticeShardedEngine(port(g), cpu_mesh(2),
                                   algorithm="mpdp_general", pipeline=pipeline,
                                   deadline_s=k - 1.5).run()
        worst = assert_same_degraded(f"lattice k={k}", [g], ref, got)
        assert got[0].info["degraded"]["levels_done"] == k - 1
        print(f"lattice deadline k={k}: largest cost difference {worst} ulp")
    assert math.isfinite(got[0].cost)
