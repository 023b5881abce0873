"""Deadlines, fault injection and degraded results of the port vs the
reference, on the CPU.

* the port's ``core.faults`` mirrors the reference's plan, spec, install
  and environment behaviour, and a fault plan's spec string means the same
  schedule in both packages;
* under the fake clock of ``tests/test_faults.py`` (``faults.now`` returns
  its call count, so ``deadline_s = k - 1.5`` expires at exactly level k)
  the port's degraded results equal the reference's at every level: the
  batched engine in all three lane spaces, synchronous and pipelined, and
  the solo engine under ``mpdp_tree``, ``mpdp_general`` and ``dpsub``:
  ``info["degraded"]`` (``levels_done``, ``levels_total``, the stitch)
  and ``Counters`` exact, costs within a relative 1e-5 (largest ULP
  distance printed), plans equal or a shown rounding tie;
* the entry points (``optimize``, ``optimize_many``, a stream with a tiny
  deadline), a generous deadline bit for bit the run without one,
  degraded results never cached, non-positive deadlines refused, a torn
  cache write loading cold;
* a ``chunk`` fault raises ``InjectedFault`` from the method the
  reference raises it from, joins the pipelined loop's side stream on the
  way out, leaves no engine state behind, and a clean rerun is bit for bit
  the run without the fault.
"""
import gc
import itertools
import math
import os
import traceback
import weakref

import pytest

from repro.core import batch as rbatch, engine as reng, faults as rfaults
from repro.core.config import OptimizerConfig as RConfig
from repro.heuristics import goo as rgoo
from repro.workloads import generators as rgen
from repro_torch.core import batch as tbatch, engine as teng, faults
from repro_torch.core import service as tservice
from repro_torch.core.config import OptimizerConfig
from repro_torch.core.faults import FaultPlan, FaultRule, InjectedFault
from repro_torch.core.plan import cost_plan, validate_plan
from repro_torch.core.plancache import PlanCache
from repro_torch.heuristics import goo
from tests.test_torch_batch import (REL, one_torch_thread, port,  # noqa: F401
                                    tjg_plan, ulp_diff)

G = rgen.chain(6, 7)                   # acyclic: valid in all 3 lane spaces
SMALL = [rgen.chain(5, 1), rgen.star(6, 2), rgen.musicbrainz_query(8, 3)]
# batched flights: queries of several sizes, so some finish before a late
# expiry and the rest degrade (levels_total is the flight's largest n)
FLIGHTS = {"mpdp_tree": [G, rgen.star(5, 2), rgen.chain(4, 3)],
           "mpdp_general": [G, rgen.cycle(7, 3), rgen.musicbrainz_query(6, 3)],
           "dpsub": [G, rgen.cycle(7, 3), rgen.musicbrainz_query(6, 3)]}
SOLO = {"mpdp_tree": rgen.snowflake(8, 2), "mpdp_general": rgen.cycle(8, 4),
        "dpsub": rgen.musicbrainz_query(8, 5)}


@pytest.fixture(autouse=True)
def _clean_faults():
    """No test may leak an installed plan into the next, in either
    package."""
    faults.uninstall()
    rfaults.uninstall()
    yield
    faults.uninstall()
    rfaults.uninstall()


def fake_clocks(monkeypatch):
    """Both packages' ``faults.now`` return their own call count."""
    a, b = itertools.count(), itertools.count()
    monkeypatch.setattr(faults, "now", lambda: next(a))
    monkeypatch.setattr(rfaults, "now", lambda: next(b))


@pytest.fixture
def fake_clock(monkeypatch):
    fake_clocks(monkeypatch)


def shape(p):
    return p.rel_set if p.is_leaf else (shape(p.left), shape(p.right))


def fingerprint(results):
    return [(r.cost, shape(r.plan), r.counters.evaluated, r.counters.ccp,
             r.algorithm, r.info.get("degraded")) for r in results]


def assert_same_degraded(label, graphs, ref, got) -> int:
    """``info["degraded"]`` and ``Counters`` exact, costs within REL,
    plans equal or a rounding tie (printed); returns the largest ULP
    distance."""
    worst = 0
    for q, (g, r, t) in enumerate(zip(graphs, ref, got)):
        tg = port(g)
        assert t.info.get("degraded") == r.info.get("degraded"), (label, q)
        assert (t.algorithm, t.levels) == (r.algorithm, r.levels), (label, q)
        assert (t.counters.evaluated, t.counters.ccp) == \
            (r.counters.evaluated, r.counters.ccp), (label, q)
        assert math.isclose(t.cost, r.cost, rel_tol=REL), (label, q)
        worst = max(worst, ulp_diff(t.cost, r.cost))
        validate_plan(t.plan, tg)
        if shape(t.plan) != shape(r.plan):
            ct = cost_plan(t.plan, tg).cost
            cr = cost_plan(tjg_plan(r.plan), tg).cost
            print(f"{label} query {q}: rounding tie, port plan {ct!r}, "
                  f"reference plan {cr!r}")
            assert math.isclose(ct, cr, rel_tol=REL), (label, q, ct, cr)
    return worst


# =============================================================== fault plane

class TestFaultPlan:
    def test_rule_spec_roundtrip(self):
        for r in (FaultRule("chunk", 3),
                  FaultRule("cache_write", 1, "corrupt"),
                  FaultRule("socket_send", 7, "stall", 0.25)):
            assert FaultRule.from_spec(r.spec()) == r

    def test_plan_spec_roundtrip(self):
        p = FaultPlan.seeded(5, chunk_failures=2, worker_crashes=1,
                             socket_stalls=1)
        assert FaultPlan.from_spec(p.spec()).rules == p.rules

    def test_seeded_is_deterministic(self):
        a = FaultPlan.seeded(9, chunk_failures=3, slow_chunks=2)
        b = FaultPlan.seeded(9, chunk_failures=3, slow_chunks=2)
        c = FaultPlan.seeded(10, chunk_failures=3, slow_chunks=2)
        assert a.rules == b.rules
        assert a.rules != c.rules

    def test_seeded_spec_equals_reference(self):
        kw = dict(chunk_failures=3, slow_chunks=2, cache_corruptions=1,
                  worker_crashes=1, socket_stalls=2)
        for seed in (0, 5, 9):
            spec = FaultPlan.seeded(seed, **kw).spec()
            assert spec == rfaults.FaultPlan.seeded(seed, **kw).spec()
            assert rfaults.FaultPlan.from_spec(spec).spec() == spec

    def test_bad_specs_rejected(self):
        with pytest.raises(ValueError):
            FaultRule("nope", 1)
        with pytest.raises(ValueError):
            FaultRule("chunk", 0)
        with pytest.raises(ValueError):
            FaultRule.from_spec("garbage")

    def test_install_resets_counters(self):
        faults.install(FaultPlan(rules=(FaultRule("chunk", 1),)))
        with pytest.raises(InjectedFault):
            faults.fire("chunk")
        assert faults.fired() == ["chunk@1:raise"]
        faults.install(FaultPlan(rules=(FaultRule("chunk", 1),)))
        assert faults.fired() == []            # fresh counters: fires again
        with pytest.raises(InjectedFault):
            faults.fire("chunk")

    def test_uninstalled_is_inert(self):
        assert not faults.active()
        assert faults.fire("chunk") is None
        assert faults.check("cache_write") is None

    def test_install_from_env(self, monkeypatch):
        monkeypatch.setenv("REPRO_FAULTS", "worker@2:raise;chunk@1:sleep:0.01")
        assert faults.install_from_env()
        assert faults.active()
        assert faults.fire("chunk") is not None    # sleep rule returned
        faults.uninstall()
        monkeypatch.setenv("REPRO_FAULTS", "")
        assert not faults.install_from_env()


# ========================================================= anytime deadlines

@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("space", ["dpsub", "mpdp_tree", "mpdp_general"])
def test_batched_deadline_every_level(space, pipeline, monkeypatch):
    """Expiry at every level of a three-query flight: the port's results
    equal the reference's under the same fake clock, each valid and no
    worse than GOO; a generous deadline degrades nothing."""
    graphs = FLIGHTS[space]
    ported = [port(g) for g in graphs]
    max_n = max(g.n for g in graphs)
    worst = 0
    for k in range(2, max_n + 1):
        fake_clocks(monkeypatch)
        ref = rbatch.BatchEngine(graphs, algorithm=space, pipeline=pipeline,
                                 deadline_s=k - 1.5).run()
        got = tbatch.BatchEngine(ported, algorithm=space, pipeline=pipeline,
                                 deadline_s=k - 1.5, device="cpu").run()
        worst = max(worst, assert_same_degraded(f"{space} k={k}", graphs,
                                                ref, got))
        deg = got[[g.n for g in graphs].index(max_n)].info["degraded"]
        assert (deg["reason"], deg["levels_done"], deg["levels_total"]) == \
            ("deadline", k - 1, max_n)
        for g, r in zip(ported, got):
            if "degraded" in r.info:       # stitched: never worse than GOO
                assert float(r.cost) <= float(goo.solve(g).cost) + 1e-4
    fake_clocks(monkeypatch)
    eng = tbatch.BatchEngine(ported, algorithm=space, pipeline=pipeline,
                             deadline_s=1e9, device="cpu")
    assert not any("degraded" in r.info for r in eng.run())
    print(f"{space} pipeline={pipeline}: largest cost difference to the "
          f"reference {worst} ulp")


@pytest.mark.parametrize("algorithm", ["mpdp_tree", "mpdp_general", "dpsub"])
def test_solo_deadline_every_level(algorithm, monkeypatch):
    g = SOLO[algorithm]
    worst = 0
    for k in range(2, g.n + 1):
        fake_clocks(monkeypatch)
        ref = reng.optimize(g, config=RConfig(algorithm=algorithm,
                                              deadline_s=k - 1.5))
        got = teng.optimize(port(g), config=OptimizerConfig(
            algorithm=algorithm, deadline_s=k - 1.5), device="cpu")
        worst = max(worst, assert_same_degraded(f"{algorithm} k={k}", [g],
                                                [ref], [got]))
        assert got.info["degraded"]["levels_done"] == k - 1
        assert got.info["degraded"]["levels_total"] == g.n
    print(f"{algorithm}: largest cost difference to the reference {worst} ulp")


def test_solo_dpsize_deadline(monkeypatch):
    g = SOLO["dpsub"]
    fake_clocks(monkeypatch)
    ref = reng.optimize(g, config=RConfig(algorithm="dpsize", deadline_s=3.5))
    got = teng.optimize(port(g), config=OptimizerConfig(
        algorithm="dpsize", deadline_s=3.5), device="cpu")
    assert_same_degraded("dpsize", [g], [ref], [got])
    assert got.info["degraded"]["levels_done"] == 4


class TestDeadlineEntryPoints:
    def test_optimize_solo_degrades(self, fake_clock):
        g = SMALL[0]
        cfg = dict(algorithm="dpsub", deadline_s=1.5)
        ref = reng.optimize(g, config=RConfig(**cfg))
        got = teng.optimize(port(g), config=OptimizerConfig(**cfg),
                            device="cpu")
        assert got.info["degraded"]["reason"] == "deadline"
        assert_same_degraded("optimize", [g], [ref], [got])
        assert float(got.cost) <= float(rgoo.solve(g).cost) + 1e-4

    def test_optimize_many_degrades_every_query(self, fake_clock):
        """One stream-wide deadline: each engine gets what is left."""
        graphs = SMALL + [rgen.chain(17, 1)]          # one solo query
        ref = rbatch.optimize_many(graphs, config=RConfig(
            algorithm="dpsub", deadline_s=6.5))
        got = tbatch.optimize_many([port(g) for g in graphs],
                                   config=OptimizerConfig(
                                       algorithm="dpsub", deadline_s=6.5),
                                   device="cpu")
        # the flight expires at its level 7 (chain(5) and star(6) are done),
        # the solo query finds its budget spent before its level 2
        assert ["degraded" in r.info for r in got] == [False, False, True, True]
        assert got[3].info["degraded"]["levels_done"] == 1
        assert_same_degraded("optimize_many", graphs, ref, got)

    def test_stream_tiny_deadline_degrades(self):
        ported = [port(g) for g in SMALL]
        rs, rep = tservice.optimize_stream(
            ported, config=OptimizerConfig(deadline_s=1e-6), device="cpu")
        assert len(rs) == len(SMALL)
        assert sum(1 for r in rs if "degraded" in r.info) >= 1
        for g, r in zip(ported, rs):
            validate_plan(r.plan, g)
            assert float(r.cost) <= float(goo.solve(g).cost) + 1e-4

    def test_stream_deadline_equals_reference(self, fake_clock):
        """The service arms once, then one ``_left()`` per flight and solo
        run: the port's stream degrades where the reference's does."""
        from repro.core.service import optimize_stream as ropt_stream
        graphs = SMALL + [rgen.cycle(6, 2), rgen.chain(17, 2)]
        ref, rrep = ropt_stream(graphs, config=RConfig(deadline_s=9.5))
        got, trep = tservice.optimize_stream(
            [port(g) for g in graphs], config=OptimizerConfig(deadline_s=9.5),
            device="cpu")
        assert [f.queries for f in trep.flights] == \
            [f.queries for f in rrep.flights]
        assert any("degraded" in r.info for r in got)
        assert_same_degraded("stream", graphs, ref, got)

    def test_generous_deadline_bit_identical_to_no_deadline(self):
        ported = [port(g) for g in SMALL]
        plain = tbatch.optimize_many(ported, algorithm="dpsub", device="cpu")
        rs = tbatch.optimize_many(ported, config=OptimizerConfig(
            algorithm="dpsub", deadline_s=3600.0), device="cpu")
        assert fingerprint(rs) == fingerprint(plain)
        solo = teng.optimize(ported[2], config=OptimizerConfig(
            deadline_s=3600.0), device="cpu")
        assert fingerprint([solo]) == fingerprint(
            [teng.optimize(ported[2], device="cpu")])

    def test_degraded_results_never_cached(self, fake_clock):
        cache = PlanCache()
        rs = tbatch.optimize_many([port(g) for g in SMALL],
                                  config=OptimizerConfig(
                                      algorithm="dpsub", cache=cache,
                                      deadline_s=0.5), device="cpu")
        assert all("degraded" in r.info for r in rs)
        assert cache.stats.inserts == 0
        rs, _ = tservice.optimize_stream(
            [port(g) for g in SMALL],
            config=OptimizerConfig(cache=cache, deadline_s=0.5),
            device="cpu")
        assert all("degraded" in r.info for r in rs)
        assert cache.stats.inserts == 0 and len(cache) == 0

    def test_nonpositive_deadline_rejected(self):
        with pytest.raises(ValueError):
            OptimizerConfig(deadline_s=0.0)
        with pytest.raises(ValueError):
            OptimizerConfig(deadline_s=-1.0)


# ============================================================== chunk faults

def raising_method(exc) -> str:
    """The innermost engine method on the exception's traceback."""
    frames = [f.name for f in traceback.extract_tb(exc.__traceback__)
              if f.filename.endswith(("core/batch.py", "core/engine.py"))]
    return frames[-1]


@pytest.mark.parametrize("nth", [1, 2, 5])
@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipe"])
def test_chunk_fault_same_method_as_reference(nth, pipeline):
    """On a small flight both packages make one dispatch per level filter
    and per evaluate chunk, in the same order, so ``chunk@nth`` raises from
    the same method; the port's filter counts one dispatch per ``SPAN``
    ranks where the reference's counts one per ``chunk`` lanes."""
    graphs = FLIGHTS["mpdp_general"]
    out = []
    for mod, eng_mod, gs, kw in (
            (rfaults, rbatch, graphs, {}),
            (faults, tbatch, [port(g) for g in graphs], {"device": "cpu"})):
        mod.install(mod.FaultPlan(rules=(mod.FaultRule("chunk", nth),)))
        with pytest.raises(mod.InjectedFault) as ei:
            eng_mod.BatchEngine(gs, algorithm="mpdp_general",
                                pipeline=pipeline, **kw).run()
        mod.uninstall()
        out.append(raising_method(ei.value))
    assert out[0] == out[1], out


def test_chunk_fault_in_pipelined_flight_then_clean_run(monkeypatch):
    """A fault in the middle of a pipelined flight: ``InjectedFault``
    escapes, the side stream is joined on the way out, the engine is
    released, and a clean rerun is bit for bit the run without a fault."""
    ported = [port(g) for g in FLIGHTS["mpdp_general"]]
    clean = tbatch.BatchEngine(ported, algorithm="mpdp_general",
                               pipeline=True, device="cpu").run()
    joins = []
    real_join = tbatch._Streams.join

    def spy(self):
        joins.append(len(faults.fired()))
        real_join(self)
    monkeypatch.setattr(tbatch._Streams, "join", spy)
    faults.install(FaultPlan(rules=(FaultRule("chunk", 6),)))
    eng = tbatch.BatchEngine(ported, algorithm="mpdp_general", pipeline=True,
                             device="cpu")
    with pytest.raises(InjectedFault):
        eng.run_levels()
    assert faults.fired() == ["chunk@6:raise"]
    # the levels before the fault joined; the last join came after it (the
    # exception skipped the level's own join: only the ``finally`` is left)
    assert joins[0] == 0 and joins[-1] == 1
    faults.uninstall()
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None               # nothing keeps the failed engine
    again = tbatch.BatchEngine(ported, algorithm="mpdp_general",
                               pipeline=True, device="cpu").run()
    assert fingerprint(again) == fingerprint(clean)


def test_chunk_fault_in_stream_leaves_cache_untouched():
    cache = PlanCache()
    ported = [port(g) for g in SMALL]
    faults.install(FaultPlan(rules=(FaultRule("chunk", 3),)))
    with pytest.raises(InjectedFault):
        tservice.optimize_stream(ported, cache=cache, pipeline=True,
                                 device="cpu")
    faults.uninstall()
    assert len(cache) == 0
    rs, _ = tservice.optimize_stream(ported, cache=cache, pipeline=True,
                                     device="cpu")
    assert fingerprint(rs) == fingerprint(
        tbatch.optimize_many(ported, device="cpu"))


def test_slow_chunk_changes_nothing():
    ported = [port(g) for g in SMALL]
    plain = tbatch.optimize_many(ported, algorithm="dpsub", device="cpu")
    faults.install(FaultPlan(rules=(
        FaultRule("chunk", 1, "sleep", 0.01),
        FaultRule("chunk", 3, "sleep", 0.01))))
    rs = tbatch.optimize_many(ported, algorithm="dpsub", device="cpu")
    assert faults.fired() == ["chunk@1:sleep:0.01", "chunk@3:sleep:0.01"]
    assert fingerprint(rs) == fingerprint(plain)


# ========================================================== checkpoint corrupt

def test_corrupted_write_cold_loads(tmp_path):
    cache = PlanCache()
    g = port(SMALL[0])
    cache.put(g, teng.optimize(g, device="cpu"))
    path = str(tmp_path / "plans.plancache")
    faults.install(FaultPlan(rules=(FaultRule("cache_write", 1, "corrupt"),)))
    cache.save(path)                           # torn write lands on disk
    faults.uninstall()
    loaded = PlanCache.load(path)
    assert loaded.stale_load and len(loaded) == 0
    cache.save(path)                           # clean save heals the file
    healed = PlanCache.load(path)
    assert not healed.stale_load and len(healed) == 1
    assert os.listdir(tmp_path) == ["plans.plancache"]
