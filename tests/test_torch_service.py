"""The service path of the port (pipelined level loop, ``StreamOptimizer``,
telemetry) vs the JAX reference's, on the CPU.

* Within the port the pipelined driver is bit for bit the synchronous one
  (costs ``==``, plan shapes, ``Counters``, ``algorithm``) in all three
  lane spaces, for any ``pend_window``; on the CPU the pipelined schedule
  runs in program order (the card runs its level i+1 work on a second
  stream, which ``chip_smoke.py`` checks);
* each result equals the reference's ``optimize_many(pipeline=True)``:
  ``Counters`` exact, costs within a relative 1e-5 (largest ULP distance
  printed), plans equal or a shown rounding tie;
* ``StreamOptimizer.admit`` gives the reference's flights and solo list,
  ``optimize_stream`` equals the port's ``optimize_many`` bit for bit and
  the reference's stream report (cache hits, solo, flights), and each
  flight's telemetry equals the reference's but for the fields that count
  dispatches or time (``chunks``, ``occupancy``, walls);
* random flight compositions with a mid-stream duplicate give equal
  results synchronous, pipelined and through ``optimize_many``.
"""
import numpy as np
import pytest

from repro.core import batch as rbatch, service as rservice
from repro.core.plancache import PlanCache as RPlanCache
from repro.workloads import generators as rgen
from repro_torch.core import batch as tbatch, engine as teng
from repro_torch.core import service as tservice
from repro_torch.core.plan import validate_plan
from repro_torch.core.plancache import PlanCache as TPlanCache
from tests.helpers import rand_graph
from tests.test_pipeline import mixed_stream, tree_stream
from tests.test_torch_batch import (assert_same_results, one_torch_thread,  # noqa: F401
                                    port)

SPACES = ["dpsub", "mpdp_general", "mpdp_tree"]


def shape(p):
    return p.rel_set if p.is_leaf else (shape(p.left), shape(p.right))


def assert_bit_identical(graphs, a, b):
    """The port against itself: everything observable equal."""
    for g, ra, rb in zip(graphs, a, b):
        assert ra.cost == rb.cost
        assert shape(ra.plan) == shape(rb.plan)
        assert (ra.counters.evaluated, ra.counters.ccp) == \
            (rb.counters.evaluated, rb.counters.ccp)
        assert ra.algorithm == rb.algorithm
        validate_plan(ra.plan, g)


def stream_for(space):
    return tree_stream() if space == "mpdp_tree" else mixed_stream()


@pytest.mark.parametrize("space", SPACES)
def test_pipelined_bit_identical_and_matches_reference(space):
    graphs = stream_for(space)
    ported = [port(g) for g in graphs]
    sync = tbatch.optimize_many(ported, space, pipeline=False, device="cpu")
    pipe = tbatch.optimize_many(ported, space, pipeline=True, device="cpu")
    assert_bit_identical(ported, sync, pipe)
    seq = [teng.optimize(g, space, device="cpu") for g in ported]
    assert [r.cost for r in pipe] == [r.cost for r in seq]
    ref = rbatch.optimize_many(graphs, space, pipeline=True)
    worst = assert_same_results(graphs, ref, pipe)
    print(f"{space}: largest cost difference to the reference {worst} ulp")


@pytest.mark.parametrize("pend_window", [0, 1, 8])
def test_pend_window_results_equal(pend_window):
    """Small chunks give every level several filter spans' worth of
    evaluate chunks, so the window drains mid-level; results do not
    move."""
    graphs = [port(g) for g in mixed_stream()[:4]]
    base = tbatch.BatchEngine(graphs, chunk=256, algorithm="mpdp_general",
                              device="cpu").run()
    eng = tbatch.BatchEngine(graphs, chunk=256, algorithm="mpdp_general",
                             pipeline=True, pend_window=pend_window,
                             device="cpu")
    assert_bit_identical(graphs, base, eng.run())
    assert eng.pend_window == pend_window
    assert eng.stats["pipeline"] is True
    assert eng.chunks_dispatched > 0


def test_engine_pipeline_switch(monkeypatch):
    g = [port(rgen.chain(5, 1))]
    monkeypatch.delenv("REPRO_PIPELINE", raising=False)
    assert tbatch.BatchEngine(g, device="cpu").pipeline is False
    monkeypatch.setenv("REPRO_PIPELINE", "1")
    assert tbatch.BatchEngine(g, device="cpu").pipeline is True
    assert tbatch.BatchEngine(g, pipeline=False, device="cpu").pipeline is False


ADMIT_CASES = {
    "mixed": (lambda: mixed_stream() + tree_stream(), {}),
    "flight_cap": (lambda: [rgen.chain(5, i) for i in range(7)],
                   dict(max_flight=3)),
    "tree_on_cycle": (lambda: [rgen.cycle(5, 1), rgen.chain(6, 2)],
                      dict(algorithm="mpdp_tree")),
    "solo_large": (lambda: [rgen.chain(17, 1), rgen.star(6, 2)], {}),
}


@pytest.mark.parametrize("case", list(ADMIT_CASES))
def test_admit_matches_reference(case):
    make, kw = ADMIT_CASES[case]
    graphs = make()
    idxs = list(range(len(graphs)))
    rf, rs = rservice.StreamOptimizer(**kw).admit(graphs, idxs)
    tf, ts = tservice.StreamOptimizer(device="cpu", **kw).admit(
        [port(g) for g in graphs], idxs)
    assert ts == rs
    assert [(f.nmax, f.space, f.queries, f.lattice) for f in tf] == \
        [(f.nmax, f.space, f.queries, f.lattice) for f in rf]


def test_optimize_stream_matches_optimize_many_and_reference():
    """A cached pipelined stream with a duplicate and a solo query: the
    port's results equal its ``optimize_many`` bit for bit and the
    reference's stream; the reports agree; each flight's telemetry equals
    the reference's but for dispatch counts, times and ``retraces``: the
    port traces nothing (0), and the reference's count includes the XLA
    traces that earlier tests made of the same keys in this process."""
    graphs = mixed_stream() + tree_stream() + [rgen.chain(17, 3)]
    graphs.insert(3, graphs[0])
    ported = [port(g) for g in graphs]
    tc, rc = TPlanCache(), RPlanCache()
    got, rep = tservice.optimize_stream(ported, cache=tc, pipeline=True,
                                        device="cpu")
    many = tbatch.optimize_many(ported, cache=TPlanCache(), device="cpu")
    assert_bit_identical(ported, got, many)
    ref, rrep = rservice.optimize_stream(graphs, cache=rc, pipeline=True)
    assert_same_results(graphs, ref, got)
    assert (rep.cache_hits, rep.solo, len(rep.flights), rep.lattice) == \
        (rrep.cache_hits, rrep.solo, len(rrep.flights), rrep.lattice)
    assert rep.cache_hits >= 1 and rep.solo == 1
    assert vars(tc.stats) == vars(rc.stats)
    admitted = sorted(qi for f in rep.flights for qi in f.queries)
    assert admitted == sorted(qi for f in rrep.flights for qi in f.queries)
    assert all(lat > 0 for lat in rep.latency_s)
    pct = rep.latency_percentiles()
    assert pct[50] <= pct[95] <= pct[99]
    for tf, rf in zip(rep.flights, rrep.flights):
        assert (tf.nmax, tf.space, tf.queries) == (rf.nmax, rf.space, rf.queries)
        assert 0 < tf.finalize_s <= tf.wall_s
        t, r = tf.telemetry.to_dict(), rf.telemetry.to_dict()
        assert t["retraces"] == 0
        for k in ("chunks", "occupancy", "wall_s", "finalize_s", "retraces"):
            t.pop(k), r.pop(k)
        assert np.isclose(t.pop("result_cost"), r.pop("result_cost"),
                          rtol=1e-5, atol=0)
        assert t == r
    summary = rep.telemetry_summary()
    assert summary["flights"] == len(rep.flights)
    assert summary["retraces"] == 0
    assert summary["queries"] == sum(len(f.queries) for f in rep.flights)


def test_service_cache_hits_skip_flights():
    g = port(rand_graph(8, 2, 77))
    cache = TPlanCache()
    rs1, rep1 = tservice.optimize_stream([g], cache=cache, pipeline=True,
                                         device="cpu")
    rs2, rep2 = tservice.optimize_stream([g], cache=cache, pipeline=True,
                                         device="cpu")
    assert rep1.cache_hits == 0 and rep2.cache_hits == 1
    assert not rep2.flights
    assert shape(rs1[0].plan) == shape(rs2[0].plan)


def test_unported_service_options_raise():
    """The options once refused serve a stream equal to the plain one:
    ``devices=2`` and a 2-shard ``mesh=`` (refused until the sharding
    slice; the sharded stream's report also equals the reference's),
    ``policy=`` and ``deadline_s`` (refused until the deadlines-and-faults
    slice; a generous deadline degrades nothing)."""
    from repro.core.shard import batch_mesh as rmesh
    from repro_torch.core.policy import PolicyTable
    from repro_torch.core.shard import batch_mesh as tmesh
    from repro_torch.hostdev import ensure_host_devices
    ensure_host_devices(4)
    graphs = [port(g) for g in mixed_stream()[:4]]
    plain, _ = tservice.optimize_stream(graphs, device="cpu")
    ref, rrep = rservice.optimize_stream(mixed_stream()[:4], mesh=rmesh(2))
    for kw in (dict(devices=2), dict(mesh=tmesh(["cpu"] * 2))):
        got, rep = tservice.StreamOptimizer(device="cpu", **kw) \
            .optimize_stream(graphs)
        assert_bit_identical(graphs, got, plain)
        assert_same_results(mixed_stream()[:4], ref, got)
        assert [(f.nmax, f.space, f.queries, f.lattice) for f in rep.flights] \
            == [(f.nmax, f.space, f.queries, f.lattice)
                for f in rrep.flights]
    for kw in (dict(policy=PolicyTable()),
               dict(config=tbatch.OptimizerConfig(deadline_s=3600.0))):
        got, _ = tservice.StreamOptimizer(device="cpu", **kw) \
            .optimize_stream(graphs)
        assert [(r.cost, shape(r.plan)) for r in got] == \
            [(r.cost, shape(r.plan)) for r in plain]
        assert not any("degraded" in r.info for r in got)


# ============================================= random flight compositions ==

_TOPOS = ("chain", "star", "cycle", "clique", "rand")


def _topo_graph(kind_idx, n, seed):
    kind = _TOPOS[kind_idx % len(_TOPOS)]
    if kind == "clique":
        return rgen.clique(min(n, 6), seed)
    if kind == "rand":
        return rand_graph(n, seed % 4, seed)
    return getattr(rgen, kind)(n, seed)


@pytest.mark.parametrize("example", range(6))
def test_random_flight_compositions_pipelined_vs_sync(example):
    """Seeded mixed-NMAX streams with a duplicate interleaved mid-stream
    (an intra-stream cache hit): the pipelined service gives the
    synchronous service's and ``optimize_many``'s results bit for bit."""
    rng = np.random.default_rng(1000 + example)
    comps = [(int(rng.integers(0, 5)), int(rng.integers(4, 13)),
              int(rng.integers(0, 61)))
             for _ in range(int(rng.integers(1, 8)))]
    graphs = [port(_topo_graph(k, n, s)) for k, n, s in comps]
    graphs.insert(min(int(rng.integers(0, 6)), len(graphs)), graphs[0])
    sync, _ = tservice.optimize_stream(graphs, cache=TPlanCache(),
                                       pipeline=False, device="cpu")
    pipe, rep = tservice.optimize_stream(graphs, cache=TPlanCache(),
                                         pipeline=True, device="cpu")
    many = tbatch.optimize_many(graphs, cache=TPlanCache(), device="cpu")
    for g, rs, rp, rm in zip(graphs, sync, pipe, many):
        assert rs.cost == rp.cost == rm.cost
        assert shape(rs.plan) == shape(rp.plan) == shape(rm.plan)
        assert rs.algorithm == rp.algorithm == rm.algorithm
        validate_plan(rp.plan, g)
    assert rep.cache_hits >= 1
