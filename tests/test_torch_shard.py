"""Batch sharding of the port (``core.shard``) vs the JAX reference's, on
the CPU.

The mirror of ``tests/test_shard.py``.  The port's meshes are made of
logical CPU shards (``repro_torch.hostdev.ensure_host_devices(4)``); the
reference's of the 4 emulated host devices ``tests/conftest.py`` asks for.

* ``optimize_many(devices=N)`` on 1, 2 and 4 shards equals the port's
  single-device run bit for bit (cost ``==``, plan shape, ``Counters``,
  ``algorithm``) in all three lane spaces, synchronous and pipelined,
  typed graphs too; and the reference's sharded run on its 4 devices
  (its results are the same at every device count, which its own suite
  holds): ``Counters`` exact, costs within a relative 1e-5 (the largest
  ULP distance printed), plans equal or a shown rounding tie;
* a step over all shards counts once: ``chunks_dispatched`` equals the
  reference's wherever every level's ranks fit one filter chunk;
* the deal, the inert padding, the mesh helpers (never truncating), the
  plan cache, the heuristics, the fake-clock deadline (the reference's
  degraded dicts) and the re-dispatch of a failing sharded flight;
* the kernel wrappers launch with the shard's device current.
"""
import contextlib
import traceback

import numpy as np
import pytest
import torch

from repro.core import batch as rbatch, shard as rshard
from repro.core.plancache import PlanCache as RPlanCache
from repro.workloads import generators as rgen
from repro_torch.core import batch as tbatch, engine as teng
from repro_torch.core import service as tservice, shard as tshard
from repro_torch.core.joingraph import JoinGraph as TJoinGraph
from repro_torch.core.plan import validate_plan
from repro_torch.core.plancache import PlanCache as TPlanCache
from repro_torch.hostdev import ensure_host_devices, host_device_count
from repro_torch.kernels import build, ops
from tests.helpers import given, rand_graph, settings, st
from tests.test_shard import mixed_stream, tree_stream
from tests.test_torch_batch import (assert_same_results, one_torch_thread,  # noqa: F401
                                    port)
from tests.test_torch_faults import assert_same_degraded, fake_clocks

ensure_host_devices(4)
NDEV = host_device_count()
CPU = {"device": "cpu"}
REF: dict = {}                      # reference runs, computed once a module


def ref_run(key, fn):
    if key not in REF:
        REF[key] = fn()
    return REF[key]


def shape(p):
    return p.rel_set if p.is_leaf else (shape(p.left), shape(p.right))


def assert_bit_identical(graphs, a, b):
    """The port against itself: everything observable equal."""
    assert len(a) == len(b)
    for g, ra, rb in zip(graphs, a, b):
        assert ra.cost == rb.cost
        assert shape(ra.plan) == shape(rb.plan)
        assert (ra.counters.evaluated, ra.counters.ccp) == \
            (rb.counters.evaluated, rb.counters.ccp)
        assert ra.algorithm == rb.algorithm
        assert "redispatched" not in ra.info
        validate_plan(ra.plan, g)


def check_against_reference(label, graphs, ref, got):
    worst = assert_same_results(graphs, ref, got)
    print(f"{label}: largest cost difference to the reference {worst} ulp")


def ported(graphs):
    return [port(g) for g in graphs]


def cpu_mesh(n):
    """A mesh of n logical CPU shards."""
    return tshard.batch_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def unsharded():
    """The port's single-device runs, per lane space."""
    return {space: tbatch.optimize_many(
        ported(tree_stream() if space == "mpdp_tree" else mixed_stream()),
        space, **CPU) for space in ("dpsub", "mpdp_general", "mpdp_tree")}


# ==================================================== differential: spaces ==

@pytest.mark.parametrize("devices", [1, 2, 4])
@pytest.mark.parametrize("space", ["dpsub", "mpdp_general"])
def test_sharded_bit_identical_to_sequential(space, devices, unsharded):
    graphs = mixed_stream()
    got = tbatch.optimize_many(ported(graphs), space, devices=devices, **CPU)
    assert_bit_identical(ported(graphs), got, unsharded[space])
    assert all(r.algorithm == f"batch_{space}" for r in got)
    ref = ref_run(("mixed", space), lambda: rbatch.optimize_many(
        graphs, algorithm=space, devices=4))
    check_against_reference(f"{space} on {devices} shards", graphs, ref, got)


@pytest.mark.parametrize("devices", [1, 2, 4])
def test_sharded_tree_space_bit_identical(devices, unsharded):
    graphs = tree_stream()
    got = tbatch.optimize_many(ported(graphs), "mpdp_tree", devices=devices,
                               **CPU)
    assert_bit_identical(ported(graphs), got, unsharded["mpdp_tree"])
    ref = ref_run(("tree",), lambda: rbatch.optimize_many(
        graphs, algorithm="mpdp_tree", devices=4))
    check_against_reference(f"mpdp_tree on {devices} shards", graphs, ref, got)


@pytest.mark.parametrize("devices", [2, 4])
def test_sharded_auto_dispatch_matches_unsharded(devices):
    """``auto`` dispatch under sharding: same spaces, costs and per-query
    lane counters as the unsharded run."""
    graphs = ported(mixed_stream()[:5] + tree_stream()[:4])
    base = tbatch.optimize_many(graphs, **CPU)
    got = tbatch.optimize_many(graphs, devices=devices, **CPU)
    assert_bit_identical(graphs, got, base)


@pytest.mark.parametrize("devices", [2])
def test_sharded_pallas_interpret(devices, monkeypatch):
    """The reference's sharded engine on its Pallas kernels (interpret
    mode) against the port's on the plain versions of its CUDA kernels,
    in the MPDP-general lane space (the lattice's mirror takes DPSUB)."""
    graphs = [rgen.cycle(5, 3), rgen.clique(4, 4), rgen.star(6, 2)]
    monkeypatch.setenv("REPRO_PALLAS", "1")
    ref = rbatch.optimize_many(graphs, algorithm="mpdp_general",
                               devices=devices)
    got = tbatch.optimize_many(ported(graphs), "mpdp_general",
                               devices=devices, **CPU)
    check_against_reference("pallas mpdp_general", graphs, ref, got)


@pytest.mark.parametrize("devices", [1, 2, 4])
def test_sharded_pipelined_and_typed_match_reference(devices):
    """Typed graphs (conflict arrays per shard) and the pipelined loop
    under sharding: bit for bit the port's single-device synchronous run,
    and the reference's sharded pipelined run."""
    graphs = [rgen.typed_query(7, seed=2), rgen.typed_query(9, seed=3),
              rgen.typed_query(8, seed=5, base="star"), rgen.chain(6, 1)]
    base = tbatch.optimize_many(ported(graphs), **CPU)
    for pipeline in (False, True):
        got = tbatch.optimize_many(ported(graphs), devices=devices,
                                   pipeline=pipeline, **CPU)
        assert_bit_identical(ported(graphs), got, base)
    ref = ref_run(("typed",), lambda: rbatch.optimize_many(
        graphs, devices=4, pipeline=True))
    check_against_reference(f"typed on {devices} shards", graphs, ref, got)


@pytest.mark.parametrize("devices", [4])
@pytest.mark.parametrize("space", ["dpsub", "mpdp_general", "mpdp_tree"])
def test_sharded_chunks_dispatched_match_reference(space, devices):
    """One step over all shards is one dispatch: with every level's ranks
    inside one filter chunk, the port's count equals the reference's."""
    graphs = tree_stream()[:5] if space == "mpdp_tree" else mixed_stream()[:5]
    ref = rshard.ShardedBatchEngine(graphs, rshard.batch_mesh(devices),
                                    algorithm=space)
    rs = ref.run()
    eng = tshard.ShardedBatchEngine(ported(graphs), cpu_mesh(devices),
                                    algorithm=space)
    got = eng.run()
    assert eng.chunks_dispatched == ref.chunks_dispatched
    assert eng.stats == {"launches": {k: 0 for k in ops.LAUNCHES},
                         "pipeline": False}
    check_against_reference(f"engine {space} on {devices} shards", graphs,
                            rs, got)


# ================================================= padding property tests ==

_TOPOS = ("chain", "star", "cycle", "clique", "rand")


def _topo_graph(kind_idx, n, seed):
    kind = _TOPOS[kind_idx % len(_TOPOS)]
    if kind == "chain":
        return rgen.chain(n, seed)
    if kind == "star":
        return rgen.star(n, seed)
    if kind == "cycle":
        return rgen.cycle(n, seed)
    if kind == "clique":
        return rgen.clique(min(n, 6), seed)
    return rand_graph(n, seed % 3, seed)


@settings(max_examples=3, deadline=None)
@given(st.integers(1, 6), st.integers(0, 10_000), st.integers(2, 4))
def test_padding_property_uneven_batches(nq, seed, devices):
    """Uneven B (not a shard multiple), single-query buckets, mixed
    topologies of 4-14 relations: the inert pads change no real query's
    result against the port's unsharded run."""
    devices = min(devices, NDEV)
    rng = np.random.RandomState(seed)
    graphs = ported([_topo_graph(int(rng.randint(len(_TOPOS))),
                                 int(rng.randint(4, 15)), seed + 7 * j)
                     for j in range(nq)])
    base = tbatch.optimize_many(graphs, **CPU)
    got = tbatch.optimize_many(graphs, devices=devices, **CPU)
    assert_bit_identical(graphs, got, base)


@pytest.mark.parametrize("devices", [4])
def test_single_query_bucket_pads_to_device_multiple(devices):
    """B = 1 on 4 shards: 3 inert pad queries ride along and are dropped;
    the real result equals the solo engine's and the reference's."""
    g_ref = rand_graph(9, 2, 123)
    g = port(g_ref)
    [r] = tbatch.optimize_many([g], devices=devices, **CPU)
    s = teng.optimize(g, "auto", **CPU)
    assert r.cost == s.cost
    check_against_reference("single query", [g_ref],
                            rbatch.optimize_many([g_ref], devices=devices),
                            [r])
    eng = tshard.ShardedBatchEngine([g], tshard.batch_mesh(devices,
                                                           backend="cpu"),
                                    algorithm="mpdp_general")
    assert eng.Bs == 1 and len(eng.shard_graphs) == devices
    pads = [q for d in range(devices) for q in eng.shard_graphs[d]][1:]
    assert all(p.n == 2 and p.is_tree() for p in pads)


def test_empty_and_leaf_streams_no_device_work():
    assert tbatch.optimize_many([], devices=2, **CPU) == []
    leaf = TJoinGraph.make(1, [], [1000.0], [])
    [r] = tbatch.optimize_many([leaf], devices=2, **CPU)
    assert r.plan.is_leaf and r.levels == 1
    assert r.counters.evaluated == 0


@pytest.mark.parametrize("devices", [2])
def test_round_robin_deal_and_sub_batch_split(devices):
    """Round-robin keeps shard loads within one query of each other, and
    ``max_flight`` (a shard's cap) composes with sharding."""
    graphs = ported([rand_graph(6 + (i % 3), i % 2, 40 + i)
                     for i in range(7)])
    eng = tshard.ShardedBatchEngine(graphs, cpu_mesh(devices))
    sizes = [len(s) for s in eng.shard_graphs]
    assert len(set(sizes)) == 1              # padded to a shard multiple
    assert sum(sizes) - len(graphs) < devices
    assert [eng.shard_graphs[j % devices][j // devices]
            for j in range(len(graphs))] == graphs
    split = tbatch.optimize_many(graphs, devices=devices, max_flight=2, **CPU)
    whole = tbatch.optimize_many(graphs, devices=devices, **CPU)
    assert_bit_identical(graphs, split, whole)


# ============================================================ mesh helpers ==

def test_take_devices_never_truncates_silently():
    assert len(tshard.take_devices(backend="cpu")) == NDEV
    assert len(tshard.take_devices(1, backend="cpu")) == 1
    with pytest.raises(ValueError, match=rf"only {NDEV} .* exist"):
        tshard.take_devices(NDEV + 1, backend="cpu")
    with pytest.raises(ValueError):
        tshard.take_devices(0, backend="cpu")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=rf"only {cards} cuda device"):
        tshard.take_devices(cards + 1)


def test_batch_mesh_shapes_and_passthrough():
    m = tshard.batch_mesh(1, backend="cpu")
    assert m.axis_names == (tshard.BATCH_AXIS,) and tshard.mesh_size(m) == 1
    assert tshard.batch_mesh(m) is m
    assert tshard.mesh_size(tshard.batch_mesh(backend="cpu")) == NDEV
    logical = cpu_mesh(3)
    assert logical.devices == (torch.device("cpu"),) * 3
    assert tshard.mesh_size(logical) == 3


def test_launch_mesh_raises_instead_of_truncating():
    """Every entry point that builds a mesh raises with the actual device
    count instead of shrinking the mesh."""
    graphs = ported([rgen.chain(5, 1)])
    for fn in (lambda: tshard.batch_mesh(NDEV + 1, backend="cpu"),
               lambda: tbatch.optimize_many(graphs, devices=NDEV + 1, **CPU),
               lambda: tservice.StreamOptimizer(devices=NDEV + 1, **CPU)):
        with pytest.raises(ValueError, match=rf"only {NDEV} cpu device"):
            fn()
    with pytest.warns(DeprecationWarning, match="lattice_devices"):
        with pytest.raises(ValueError, match=rf"only {NDEV} cpu device"):
            teng.optimize(graphs[0], lattice_devices=NDEV + 1, **CPU)


# ========================================================== plan cache ==

def test_fully_cached_stream_spawns_no_device_work(monkeypatch):
    graphs = ported([rand_graph(7, 2, 70 + i) for i in range(4)])
    cache = TPlanCache()
    first = tbatch.optimize_many(graphs, cache=cache, devices=2, **CPU)
    assert sum(r.counters.evaluated for r in first) > 0

    def boom(*a, **k):
        raise AssertionError("device engine spawned for a fully-cached stream")

    monkeypatch.setattr(tshard.ShardedBatchEngine, "__init__", boom)
    monkeypatch.setattr(tbatch.BatchEngine, "__init__", boom)
    monkeypatch.setattr(teng, "optimize", boom)
    rs = tbatch.optimize_many(graphs, cache=cache, devices=2, **CPU)
    assert all(r.algorithm.startswith("cache[") for r in rs)
    assert sum(r.counters.evaluated for r in rs) == 0
    for g, r in zip(graphs, rs):
        validate_plan(r.plan, g)


@pytest.mark.parametrize("devices", [2])
def test_cache_misses_then_sharded_compute(devices, monkeypatch):
    """A half-cached stream ships only the misses to the sharded engine,
    and the stream equals the reference's."""
    hits = [rand_graph(7, 1, 90 + i) for i in range(2)]
    misses = [rand_graph(8, 2, 95 + i) for i in range(3)]
    cache, rcache = TPlanCache(), RPlanCache()
    tbatch.optimize_many(ported(hits), cache=cache, devices=devices, **CPU)
    rbatch.optimize_many(hits, cache=rcache, devices=devices)
    seen = []
    orig = tshard.ShardedBatchEngine.__init__

    def spy(self, graphs, *a, **k):
        seen.append(len(graphs))
        return orig(self, graphs, *a, **k)

    monkeypatch.setattr(tshard.ShardedBatchEngine, "__init__", spy)
    got = tbatch.optimize_many(ported(hits + misses), cache=cache,
                               devices=devices, **CPU)
    assert sum(seen) == len(misses)
    ref = rbatch.optimize_many(hits + misses, cache=rcache, devices=devices)
    check_against_reference("half-cached", hits + misses, ref, got)
    assert vars(cache.stats) == vars(rcache.stats)


# ======================================================= heuristics tiers ==

@pytest.mark.parametrize("devices", [2])
def test_uniondp_and_idp_inherit_sharding(devices):
    """The heuristics' rounds shard their subproblems: plans and costs
    equal the unsharded runs' (which ``tests/test_torch_heuristics.py``
    holds against the reference round by round)."""
    from repro_torch.heuristics import idp, uniondp
    g = port(rgen.musicbrainz_query(20, seed=11))
    for mod in (uniondp, idp):
        plain = mod.solve(g, k=8, **CPU)
        got = mod.solve(g, k=8, devices=devices, **CPU)
        assert (got.cost, shape(got.plan)) == (plain.cost, shape(plain.plan))
        assert (got.counters.evaluated, got.counters.ccp) == \
            (plain.counters.evaluated, plain.counters.ccp)


# ================================================= deadline and redispatch ==

@pytest.mark.parametrize("pipeline", [False, True])
def test_sharded_deadline_fake_clock(pipeline, monkeypatch):
    """Under the fake clock both sharded engines expire at the same level:
    the degraded results equal the reference's dicts."""
    graphs = mixed_stream()[:5]
    for k in (2, 4):
        fake_clocks(monkeypatch)
        ref = rshard.ShardedBatchEngine(graphs, rshard.batch_mesh(2),
                                        algorithm="mpdp_general",
                                        pipeline=pipeline,
                                        deadline_s=k - 1.5).run()
        got = tshard.ShardedBatchEngine(ported(graphs), cpu_mesh(2),
                                        algorithm="mpdp_general",
                                        pipeline=pipeline,
                                        deadline_s=k - 1.5).run()
        worst = assert_same_degraded(f"sharded k={k}", graphs, ref, got)
        print(f"sharded deadline k={k}: largest cost difference {worst} ulp")
        assert any(r.info["degraded"]["levels_done"] == k - 1 for r in got
                   if "degraded" in r.info)


def _raising_method(exc) -> str:
    frames = [f.name for f in traceback.extract_tb(exc.__traceback__)
              if f.filename.endswith(("core/shard.py", "core/lattice.py"))]
    return frames[-1]


@pytest.mark.parametrize("nth", [1, 4])
@pytest.mark.parametrize("kind", ["sharded", "lattice"])
def test_chunk_fault_once_a_step(kind, nth):
    """``chunk@nth`` counts steps over all shards: on a small flight (every
    level's ranks in one filter chunk) both packages' engines raise from
    the same method."""
    from repro.core import faults as rfaults, lattice as rlattice
    from repro_torch.core import faults as tfaults, lattice as tlattice
    if kind == "sharded":
        graphs = mixed_stream()[:3]
        makers = (lambda: rshard.ShardedBatchEngine(
                      graphs, rshard.batch_mesh(2), algorithm="mpdp_general"),
                  lambda: tshard.ShardedBatchEngine(
                      ported(graphs), cpu_mesh(2), algorithm="mpdp_general"))
    else:
        g = rgen.cycle(7, 2)
        makers = (lambda: rlattice.LatticeShardedEngine(g, 2,
                                                        algorithm="dpsub"),
                  lambda: tlattice.LatticeShardedEngine(
                      port(g), cpu_mesh(2), algorithm="dpsub"))
    out = []
    for mod, make in zip((rfaults, tfaults), makers):
        mod.install(mod.FaultPlan(rules=(mod.FaultRule("chunk", nth),)))
        try:
            with pytest.raises(mod.InjectedFault) as ei:
                make().run()
        finally:
            mod.uninstall()
        out.append(_raising_method(ei.value))
    assert out[0] == out[1], out


def test_failed_sharded_flight_redispatched(monkeypatch):
    """A sharded flight that raises runs again on the single-device engine:
    results equal the plain run's, marked ``redispatched``, in
    ``optimize_many`` and in the service."""
    graphs = ported(mixed_stream()[:4])
    base = tbatch.optimize_many(graphs, **CPU)

    def boom(self):
        raise RuntimeError("injected shard failure")

    monkeypatch.setattr(tshard.ShardedBatchEngine, "run_levels", boom)
    for got in (tbatch.optimize_many(graphs, devices=2, **CPU),
                tservice.optimize_stream(graphs, devices=2, **CPU)[0]):
        assert all(r.info.pop("redispatched") for r in got)
        assert_bit_identical(graphs, got, base)


# ================================================================ launches ==

def test_run_launches_under_the_shards_device(monkeypatch):
    """``ops._run`` makes the shard's device current around the launch and
    takes that device's current stream."""
    state = {"current": "cuda:0"}
    seen = []

    @contextlib.contextmanager
    def device(dev):
        prev, state["current"] = state["current"], str(dev)
        try:
            yield
        finally:
            state["current"] = prev

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = f"stream of {dev}"

    class Lib:
        def rt_bconnectivity_span(self, *args):
            seen.append((state["current"], args[-1]))
            return 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(build, "library", Lib)
    launches = ops.LAUNCHES["bconnectivity_span"]
    ops._run("bconnectivity_span", torch.device("cuda:1"), 1, 2, 3)
    assert seen == [("cuda:1", "stream of cuda:1")]
    assert state["current"] == "cuda:0"
    assert ops.LAUNCHES["bconnectivity_span"] == launches + 1
    ops.LAUNCHES["bconnectivity_span"] = launches
