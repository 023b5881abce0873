"""The port's ``OptimizerConfig`` vs the reference's, on the CPU.

* mirrors of ``tests/test_config.py``: defaults, validation, ``replace``,
  the wire round trip and its refusals, the legacy-kwarg shim, and every
  entry point giving the same results through ``config=`` as through the
  legacy kwargs (costs ``==``, plan shapes, ``algorithm``);
* across the packages: ``to_wire`` gives equal dicts in both, and a wire
  dict from either builds an equal config in the other.
"""
import json

import pytest

from repro.core.config import OptimizerConfig as RConfig
from repro_torch.core import batch, engine
from repro_torch.core.config import (CHUNK, MAX_FLIGHT, UNSET,
                                     OptimizerConfig, alias_kwarg,
                                     resolve_config)
from repro_torch.core.plancache import PlanCache
from repro_torch.core.policy import PolicyTable
from repro_torch.core.service import StreamOptimizer, optimize_stream
from repro_torch.workloads import generators as gen
from tests.test_torch_batch import one_torch_thread  # noqa: F401


def plan_shape(p):
    if p.is_leaf:
        return p.rel_set
    return (p.rel_set, plan_shape(p.left), plan_shape(p.right))


def fingerprint(results):
    return [(float(r.cost), plan_shape(r.plan), r.algorithm)
            for r in results]


SMALL = [gen.chain(6, 1), gen.star(7, 2), gen.cycle(8, 3),
         gen.musicbrainz_query(9, 4)]
CPU = dict(device="cpu")
WIRE_CASES = [dict(),
              dict(algorithm="dpsub", chunk=1024, devices=4, pipeline=True,
                   max_flight=8, cyc_cap=20, enum="expand", lattice=True),
              dict(algorithm="mpdp", deadline_s=0.25, pipeline=False),
              dict(algorithm="dpsize", chunk=1 << 12, max_flight=1)]


# ============================================================ the dataclass

class TestOptimizerConfig:
    def test_defaults(self):
        cfg = OptimizerConfig()
        assert cfg.algorithm == "auto" and cfg.chunk == CHUNK
        assert cfg.max_flight == MAX_FLIGHT and cfg.enum == "unrank"
        assert cfg.cache is None and cfg.devices is None and cfg.mesh is None
        assert cfg.policy is None and cfg.deadline_s is None

    def test_frozen(self):
        cfg = OptimizerConfig()
        with pytest.raises(Exception):
            cfg.chunk = 1

    def test_validation(self):
        with pytest.raises(ValueError):
            OptimizerConfig(chunk=0)
        with pytest.raises(ValueError):
            OptimizerConfig(max_flight=0)
        with pytest.raises(ValueError):
            OptimizerConfig(enum="nope")
        with pytest.raises(ValueError):
            OptimizerConfig(devices=2, mesh=object())
        with pytest.raises(ValueError):
            OptimizerConfig(deadline_s=0.0)

    def test_replace(self):
        cfg = OptimizerConfig().replace(devices=2, algorithm="mpdp")
        assert (cfg.devices, cfg.algorithm) == (2, "mpdp")
        assert cfg.chunk == CHUNK
        with pytest.raises(ValueError):
            OptimizerConfig().replace(chunk=0)     # validated again

    def test_wire_roundtrip(self):
        cfg = OptimizerConfig(**WIRE_CASES[1])
        assert OptimizerConfig.from_wire(cfg.to_wire()) == cfg

    def test_wire_rejects_process_local_state(self):
        with pytest.raises(ValueError):
            OptimizerConfig(cache=PlanCache()).to_wire()
        with pytest.raises(ValueError):
            OptimizerConfig(mesh=object()).to_wire()
        with pytest.raises(ValueError, match="process-local"):
            OptimizerConfig(policy=PolicyTable()).to_wire()

    def test_wire_rejects_unknown_keys(self):
        with pytest.raises(ValueError):
            OptimizerConfig.from_wire({"algorithm": "auto", "bogus": 1})

    def test_wire_is_json_literal(self):
        wire = OptimizerConfig(devices=2).to_wire()
        assert json.loads(json.dumps(wire)) == wire


# ====================================================== across the packages

@pytest.mark.parametrize("case", range(len(WIRE_CASES)))
def test_wire_dicts_equal_across_packages(case):
    ours = OptimizerConfig(**WIRE_CASES[case])
    theirs = RConfig(**WIRE_CASES[case])
    assert ours.to_wire() == theirs.to_wire()
    assert list(ours.to_wire()) == list(theirs.to_wire())
    # a wire dict from either package builds an equal config in the other
    assert OptimizerConfig.from_wire(
        json.loads(json.dumps(theirs.to_wire()))) == ours
    assert RConfig.from_wire(
        json.loads(json.dumps(ours.to_wire()))) == theirs


def test_unknown_wire_keys_raise_in_both():
    d = {"algorithm": "auto", "bogus": 1}
    for cls in (OptimizerConfig, RConfig):
        with pytest.raises(ValueError, match="bogus"):
            cls.from_wire(d)


# ================================================================= the shim

class TestResolveConfig:
    def test_kwargs_only(self):
        cfg = resolve_config(None, algorithm="mpdp", chunk=64)
        assert (cfg.algorithm, cfg.chunk) == ("mpdp", 64)

    def test_config_only(self):
        src = OptimizerConfig(algorithm="dpsub")
        assert resolve_config(src) is src

    def test_conflict_raises(self):
        with pytest.raises(ValueError, match="not both"):
            resolve_config(OptimizerConfig(), algorithm="mpdp")

    def test_none_is_a_passed_value(self):
        with pytest.raises(ValueError, match="not both"):
            resolve_config(OptimizerConfig(), cache=None)

    def test_wrong_type(self):
        with pytest.raises(TypeError):
            resolve_config({"algorithm": "auto"})

    def test_alias_kwarg(self):
        with pytest.warns(DeprecationWarning, match="max_batch"):
            assert alias_kwarg(UNSET, 7, "max_batch", "max_flight") == 7
        assert alias_kwarg(5, UNSET, "max_batch", "max_flight") == 5
        with pytest.raises(ValueError):
            alias_kwarg(5, 7, "max_batch", "max_flight")


# ==================================== differential: config= == legacy kwargs

class TestEntryPointParity:
    def test_optimize(self):
        g = gen.musicbrainz_query(9, 4)
        legacy = engine.optimize(g, algorithm="mpdp", chunk=4096, **CPU)
        via_cfg = engine.optimize(
            g, config=OptimizerConfig(algorithm="mpdp", chunk=4096), **CPU)
        assert fingerprint([legacy]) == fingerprint([via_cfg])

    def test_optimize_many(self):
        legacy = engine.optimize_many(SMALL, algorithm="auto", max_flight=2,
                                      **CPU)
        via_cfg = engine.optimize_many(
            SMALL, config=OptimizerConfig(max_flight=2), **CPU)
        assert fingerprint(legacy) == fingerprint(via_cfg)

    def test_batch_optimize_many(self):
        legacy = batch.optimize_many(SMALL, algorithm="dpsub", **CPU)
        via_cfg = batch.optimize_many(
            SMALL, config=OptimizerConfig(algorithm="dpsub"), **CPU)
        assert fingerprint(legacy) == fingerprint(via_cfg)

    def test_optimize_stream(self):
        legacy, _ = optimize_stream(SMALL, max_flight=2, **CPU)
        via_cfg, _ = optimize_stream(SMALL,
                                     config=OptimizerConfig(max_flight=2),
                                     **CPU)
        assert fingerprint(legacy) == fingerprint(via_cfg)

    def test_stream_optimizer_keeps_config(self):
        cfg = OptimizerConfig(max_flight=3)
        s = StreamOptimizer(config=cfg, **CPU)
        assert s.config == cfg and s.max_flight == 3

    def test_wired_config_equals_local_config(self):
        """A config that crossed the wire (as the daemon receives it) runs
        the stream exactly as the local one."""
        cfg = OptimizerConfig(algorithm="mpdp", max_flight=2, pipeline=True)
        wired = OptimizerConfig.from_wire(json.loads(json.dumps(
            RConfig.from_wire(cfg.to_wire()).to_wire())))
        a, _ = optimize_stream(SMALL, config=cfg, **CPU)
        b, _ = optimize_stream(SMALL, config=wired, **CPU)
        assert fingerprint(a) == fingerprint(b)

    def test_optimize_lattice_routing_flag_refused(self):
        """``lattice=True`` and its legacy spelling ``lattice_devices=``
        (the alias warning first) both run the lattice on 2 logical CPU
        shards and give the reference's lattice result."""
        from repro.core import engine as rengine
        from repro.workloads import generators as rgen
        from repro_torch.hostdev import ensure_host_devices
        from tests.test_torch_batch import assert_same_results, port
        ensure_host_devices(4)
        g_ref = rgen.musicbrainz_query(9, 4)
        g = port(g_ref)
        ref = rengine.optimize(g_ref, config=RConfig(devices=2, lattice=True))
        a = engine.optimize(g, config=OptimizerConfig(devices=2,
                                                      lattice=True), **CPU)
        with pytest.warns(DeprecationWarning, match="lattice_devices"):
            b = engine.optimize(g, lattice_devices=2, **CPU)
        assert a.algorithm == b.algorithm == "lattice_mpdp_tree"
        assert (a.cost, a.counters.evaluated) == (b.cost, b.counters.evaluated)
        assert_same_results([g_ref], [ref], [a])

    def test_conflict_raises_at_entry(self):
        g = gen.chain(5, 0)
        with pytest.raises(ValueError, match="not both"):
            engine.optimize(g, algorithm="mpdp", config=OptimizerConfig(),
                            **CPU)
        with pytest.raises(ValueError, match="not both"):
            engine.optimize_many([g], max_flight=2,
                                 config=OptimizerConfig(), **CPU)

    def test_max_batch_alias_deprecated(self):
        with pytest.warns(DeprecationWarning, match="max_batch"):
            legacy = engine.optimize_many(SMALL[:2], max_batch=2, **CPU)
        canonical = engine.optimize_many(SMALL[:2], max_flight=2, **CPU)
        assert fingerprint(legacy) == fingerprint(canonical)

    def test_cache_threads_through_config(self):
        cache = PlanCache()
        engine.optimize_many(SMALL, config=OptimizerConfig(cache=cache), **CPU)
        assert len(cache) == len(SMALL)
        r2 = engine.optimize_many(SMALL, config=OptimizerConfig(cache=cache),
                                  **CPU)
        assert cache.stats.hits == len(SMALL)
        assert len(r2) == len(SMALL)
