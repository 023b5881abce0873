"""The port's learned policy table vs the reference's, on the CPU.

* mirrors of ``tests/test_policy.py`` on the port: with no policy, an
  explicit ``policy=None`` or a frozen cold table every dispatcher gives
  the same results; a learning table never moves a cost or a plan; an
  explicit lane space is never overridden; the policy refuses the wire;
* mirrors of ``tests/test_policy_learner.py``: EMA dynamics, bounded row
  corrections, determinism, persistence (byte-exact round trip; corrupt,
  truncated, tampered and drifted files load cold) and the cardinality
  feedback (``cost.np_corrected_graph``, ``PlanCache.invalidate_drift``);
* across the packages: the same telemetry sequence gives equal tables
  (``summary()`` equal, saved files byte for byte equal), table files load
  in either package, ``np_corrected_graph`` gives the reference's graph,
  and ``uniondp.solve(policy=)`` gives the reference's ``round_costs`` and
  learns the same re-optimization budget.
"""
import math
import os

import pytest

from repro.core import policy as rpolicy
from repro.core.telemetry import FlightTelemetry as RTele
from repro.heuristics import uniondp as runiondp
from repro.workloads import generators as rgen
from repro_torch.core import batch as tbatch, cost as tcost
from repro_torch.core import policy as pol
from repro_torch.core import service as tservice
from repro_torch.core.config import OptimizerConfig
from repro_torch.core.joingraph import graph_to_wire
from repro_torch.core.plan import cost_plan
from repro_torch.core.plancache import PlanCache
from repro_torch.core.policy import MAX_STEP_L2, POLICY_FILE_VERSION, PolicyTable
from repro_torch.core.telemetry import FlightTelemetry
from repro_torch.heuristics import uniondp
from repro_torch.workloads import generators as gen
from tests.helpers import given, settings, st
from tests.test_torch_batch import one_torch_thread, port  # noqa: F401


def plan_shape(p):
    if p.is_leaf:
        return p.rel_set
    return (p.rel_set, plan_shape(p.left), plan_shape(p.right))


def fingerprint(results):
    return [(float(r.cost), plan_shape(r.plan), r.algorithm)
            for r in results]


def join_tree(p):
    """The plan as an unordered tree: the lane spaces enumerate a join's
    operands in different orders, so a switch of space may mirror a join
    whose two orientations cost the same (the reference's plans do the
    same)."""
    if p.is_leaf:
        return p.rel_set
    return (p.rel_set, frozenset((join_tree(p.left), join_tree(p.right))))


def assert_same_plans(graphs, got, want):
    """Costs ``==``; each plan the same join tree, or a shown tie: a space
    the policy explores enumerates other candidates, and an equal-cost
    alternative can win the prune (both plans cost the same)."""
    assert [r.cost for r in got] == [r.cost for r in want]
    for g, a, b in zip(graphs, got, want):
        if join_tree(a.plan) != join_tree(b.plan):
            ca, cb = cost_plan(a.plan, g).cost, cost_plan(b.plan, g).cost
            print(f"a tie: plans cost {ca!r} and {cb!r}")
            assert math.isclose(ca, cb, rel_tol=1e-5)


def lane_counts(results):
    return [(int(r.counters.evaluated), int(r.counters.ccp))
            for r in results]


# mixed topologies so the auto dispatcher exercises every lane space
STREAM = [gen.chain(6, 1), gen.star(7, 2), gen.cycle(8, 3),
          gen.musicbrainz_query(9, 4), gen.snowflake(10, 5)]


def run_many(graphs, **kw):
    return tbatch.optimize_many(graphs, device="cpu", **kw)


def frozen_cold_table():
    t = PolicyTable()
    t.freeze()
    return t


def tele(nmax=8, space="mpdp_tree", queries=4, wall_s=0.1, lanes=500,
         chunks=6, cls=FlightTelemetry):
    return cls(nmax=nmax, space=space, queries=queries,
               evaluated_lanes=lanes, ccp_lanes=lanes, chunk=1 << 15,
               chunks=chunks, wall_s=wall_s)


def feed(t, cls, g):
    """The telemetry sequence of the reference's ``learned_table``: entries
    in every sub-structure (arms, profiles, rows, reopt)."""
    for i in range(6):
        t.observe(8, "mpdp_tree", "mpdp_tree", tele(wall_s=0.1 + 0.01 * i,
                                                    cls=cls))
        t.observe(8, "mpdp_tree", "dpsub", tele(wall_s=0.05, cls=cls))
        t.observe(16, "mpdp_general", "mpdp_general",
                  tele(nmax=16, space="mpdp_general", wall_s=0.4,
                       lanes=9000, chunks=20, cls=cls))
    t.record_execution(g, {g.names[0]: 1e6, g.names[1]: 3.0})
    t.observe_reopt(2)
    t.observe_reopt(3)
    return t


def learned_table():
    return feed(PolicyTable(), FlightTelemetry, gen.musicbrainz_query(6, 3))


# ========================================== policy-off identity (port) ====

class TestPolicyOffIdentity:
    @pytest.mark.parametrize("algorithm", ["auto", "mpdp", "dpsub"])
    @pytest.mark.parametrize("pipeline", [False, True],
                             ids=["sync", "pipelined"])
    def test_matrix(self, algorithm, pipeline):
        kw = dict(algorithm=algorithm, pipeline=pipeline)
        static = run_many(STREAM, **kw)
        again = run_many(STREAM, **kw)
        off = run_many(STREAM, policy=None, **kw)
        frozen = run_many(STREAM, policy=frozen_cold_table(), **kw)
        assert fingerprint(static) == fingerprint(again) \
            == fingerprint(off) == fingerprint(frozen)
        assert lane_counts(static) == lane_counts(again) \
            == lane_counts(off) == lane_counts(frozen)

    def test_frozen_cold_table_emits_all_none(self):
        dec = frozen_cold_table().choose(8, "mpdp_tree", default_chunk=1 << 15,
                                         default_pend=8)
        assert dec.space == "mpdp_tree"
        assert dec.chunk is None and dec.pend_window is None

    def test_stream_service_policy_off_identity(self):
        plain, rep_plain = tservice.optimize_stream(STREAM, device="cpu")
        off, rep_off = tservice.optimize_stream(
            STREAM, config=OptimizerConfig(policy=None), device="cpu")
        assert fingerprint(plain) == fingerprint(off)
        assert lane_counts(plain) == lane_counts(off)
        for rep in (rep_plain, rep_off):
            assert all(fl.telemetry is not None for fl in rep.flights)
            agg = rep.telemetry_summary()
            assert agg["queries"] == len(STREAM)
            assert agg["evaluated_lanes"] > 0
            assert agg["flights"] == len(rep.flights)


# =============================================== cost invariance (learning)

class TestLearningInvariance:
    def test_costs_identical_on_every_learning_pass(self):
        static = run_many(STREAM)
        table = PolicyTable()
        explored = set()
        for _ in range(8):      # enough passes to clear every explore phase
            rs = run_many(STREAM, policy=table)
            assert_same_plans(STREAM, rs, static)
            explored.update(r.algorithm for r in rs)
        assert len(table) > 0
        assert table.stats.observations > 0
        assert table.stats.space_overrides > 0
        assert len(explored) > 2

    def test_frozen_table_replays_one_dispatch(self):
        table = PolicyTable()
        for _ in range(8):
            run_many(STREAM, policy=table)
        table.freeze()
        obs0 = table.stats.observations
        a = run_many(STREAM, policy=table)
        b = run_many(STREAM, policy=table)
        assert fingerprint(a) == fingerprint(b)
        assert table.stats.observations == obs0

    def test_stream_service_learning_costs_identical(self):
        plain, _ = tservice.optimize_stream(STREAM, device="cpu")
        table = PolicyTable()
        for _ in range(6):
            learned, rep = tservice.optimize_stream(
                STREAM, config=OptimizerConfig(policy=table), device="cpu")
            assert_same_plans(STREAM, learned, plain)
        assert table.stats.observations > 0
        for fl in rep.flights:
            assert fl.telemetry.space is not None
            assert fl.space in ("dpsub", "mpdp_tree", "mpdp_general")

    def test_shrunk_chunk_keeps_costs(self):
        """A learned table shrinks the chunk (a power of two down to
        ``CHUNK_MIN``): the chunk bodies take it, costs and plans stay."""
        table = PolicyTable(learn_space=False)
        for _ in range(3):
            rs = run_many(STREAM, policy=table)
        dec = table.choose(8, "mpdp_tree", default_chunk=1 << 15)
        assert dec.chunk == pol.CHUNK_MIN
        assert fingerprint(rs) == fingerprint(run_many(STREAM))
        assert lane_counts(rs) == lane_counts(run_many(STREAM))


# ================================================ activation + wire safety

class TestActivationRule:
    def test_explicit_algorithm_never_overridden(self):
        table = PolicyTable()
        for _ in range(8):
            run_many(STREAM, policy=table)
        decisions0 = table.stats.decisions
        rs = run_many(STREAM, algorithm="dpsub", policy=table)
        assert all(r.algorithm == "batch_dpsub" for r in rs)
        assert table.stats.decisions == decisions0

    def test_policy_rejects_wire(self):
        with pytest.raises(ValueError, match="process-local"):
            OptimizerConfig(policy=PolicyTable()).to_wire()

    def test_policy_threads_through_config_replace(self):
        table = PolicyTable()
        cfg = OptimizerConfig().replace(policy=table)
        assert cfg.policy is table
        assert OptimizerConfig().policy is None


# ================================================================ learning

class TestLearningDynamics:
    @given(st.floats(min_value=1e-4, max_value=10.0),
           st.integers(min_value=20, max_value=60))
    @settings(max_examples=25, deadline=None)
    def test_ema_converges_under_stationary_feedback(self, wall, reps):
        t = PolicyTable()
        for _ in range(reps):
            t.observe(8, "mpdp_tree", "mpdp_tree",
                      tele(queries=1, wall_s=wall))
        e = t._entries[(8, "mpdp_tree")]
        assert abs(e["wallq"] - wall) <= 1e-3 * max(wall, 1.0)
        assert abs(e["arms"]["mpdp_tree"][0] - wall) <= 1e-3 * max(wall, 1.0)
        assert e["arms"]["mpdp_tree"][1] == reps

    @given(st.floats(min_value=0.0, max_value=60.0))
    @settings(max_examples=25, deadline=None)
    def test_row_update_bounded_per_observation(self, obs_l2):
        g = gen.chain(5, 7)
        name = g.names[2]
        t = PolicyTable()
        base = float(g.log2_card[2])
        t.record_execution(g, {name: obs_l2}, log2=True)
        moved = t.drift_rows()[name] - base
        assert abs(moved) <= MAX_STEP_L2 + 1e-12
        assert moved * (max(obs_l2, 0.0) - base) >= 0.0

    @given(st.floats(min_value=0.0, max_value=60.0),
           st.integers(min_value=1, max_value=200))
    @settings(max_examples=25, deadline=None)
    def test_row_corrections_converge_and_stay_clamped(self, obs_l2, reps):
        g = gen.chain(5, 7)
        name = g.names[2]
        t = PolicyTable()
        for _ in range(reps):
            t.record_execution(g, {name: obs_l2}, log2=True)
        learned = t.drift_rows()[name]
        lo = min(float(g.log2_card[2]), max(obs_l2, 0.0)) - 1e-9
        hi = max(float(g.log2_card[2]), max(obs_l2, 0.0)) + 1e-9
        assert lo <= learned <= hi
        assert learned >= -1e-12

    @given(st.lists(st.tuples(st.integers(min_value=0, max_value=2),
                              st.floats(min_value=1e-3, max_value=2.0),
                              st.integers(min_value=100, max_value=5000)),
                    min_size=1, max_size=30))
    @settings(max_examples=25, deadline=None)
    def test_table_is_pure_function_of_telemetry_sequence(self, seq):
        """Two port tables and the reference's, fed the same records, hold
        the same state and decide the same."""
        spaces = ("mpdp_tree", "dpsub", "mpdp_general")
        tables = [PolicyTable(), PolicyTable(), rpolicy.PolicyTable()]
        for t, cls in zip(tables, (FlightTelemetry, FlightTelemetry, RTele)):
            for arm_i, wall, lanes in seq:
                t.observe(8, "mpdp_tree", spaces[arm_i],
                          tele(wall_s=wall, lanes=lanes, cls=cls))
        assert tables[0]._entries == tables[1]._entries == tables[2]._entries
        decs = [t.choose(8, "mpdp_tree", default_chunk=1 << 15,
                         default_pend=8) for t in tables]
        assert len({(d.space, d.chunk, d.pend_window) for d in decs}) == 1

    def test_same_sequence_saves_byte_identical_files(self, tmp_path):
        t0, t1 = learned_table(), learned_table()
        p0, p1 = str(tmp_path / "a.policy"), str(tmp_path / "b.policy")
        t0.save(p0)
        t1.save(p1)
        assert open(p0).read() == open(p1).read()

    def test_exploit_picks_fastest_arm(self):
        t = PolicyTable()
        for _ in range(4):
            t.observe(8, "mpdp_tree", "mpdp_tree", tele(wall_s=0.5))
            t.observe(8, "mpdp_tree", "dpsub", tele(wall_s=0.1))
            t.observe(8, "mpdp_tree", "mpdp_general", tele(wall_s=0.3))
        assert t.choose(8, "mpdp_tree", default_chunk=1 << 15).space == "dpsub"

    def test_chunk_rule_shrink_only(self):
        t = PolicyTable()
        for _ in range(5):
            t.observe(8, "mpdp_tree", "mpdp_tree", tele(lanes=500, chunks=3))
        d = t.choose(8, "mpdp_tree", default_chunk=1 << 15, default_pend=8)
        assert d.chunk == pol.CHUNK_MIN
        assert d.pend_window == max(pol.PEND_MIN, 3)
        d2 = t.choose(8, "mpdp_tree", default_chunk=1 << 10, default_pend=2)
        assert d2.chunk is None and d2.pend_window is None

    def test_exact_limit_walks_observed_buckets(self):
        t = PolicyTable()
        for nmax, wall in ((8, 0.01), (12, 0.05), (16, 0.2), (18, 5.0)):
            t.observe(nmax, "mpdp_tree", "mpdp_tree",
                      tele(nmax=nmax, queries=1, wall_s=wall))
        assert t.exact_limit(14, budget_s=1.0) == 16
        assert t.exact_limit(14, budget_s=10.0) == 18
        assert t.exact_limit(14, budget_s=0.02) == 11
        assert PolicyTable().exact_limit(14, budget_s=1.0) == 14

    def test_reopt_rounds_learned(self):
        t = PolicyTable()
        assert t.reopt_rounds_for(3) == 3
        for _ in range(10):
            t.observe_reopt(1)
        assert t.reopt_rounds_for(3) == 2
        for _ in range(40):
            t.observe_reopt(20)
        assert t.reopt_rounds_for(3) == pol.REOPT_MAX


# ====================================================== across the packages

class TestAcrossPackages:
    def test_same_telemetry_equal_tables_and_files(self, tmp_path):
        g = gen.musicbrainz_query(6, 3)
        ours = feed(PolicyTable(), FlightTelemetry, g)
        theirs = feed(rpolicy.PolicyTable(), RTele,
                      rgen.musicbrainz_query(6, 3))
        assert ours.summary() == theirs.summary()
        p0, p1 = str(tmp_path / "port.policy"), str(tmp_path / "ref.policy")
        ours.save(p0)
        theirs.save(p1)
        assert open(p0, "rb").read() == open(p1, "rb").read()

    @pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
    def test_table_files_cross(self, tmp_path, direction):
        src_cls, dst_cls = ((rpolicy.PolicyTable, PolicyTable)
                            if direction == "ref_to_port"
                            else (PolicyTable, rpolicy.PolicyTable))
        tele_cls = RTele if src_cls is rpolicy.PolicyTable else FlightTelemetry
        mod = rgen if src_cls is rpolicy.PolicyTable else gen
        src = feed(src_cls(), tele_cls, mod.musicbrainz_query(6, 3))
        p1, p2 = str(tmp_path / "a.policy"), str(tmp_path / "b.policy")
        src.save(p1)
        loaded = dst_cls.load(p1)
        assert not loaded.stale_load and len(loaded) == len(src)
        loaded.save(p2)
        assert open(p1).read() == open(p2).read()
        da = src.choose(8, "mpdp_tree", default_chunk=1 << 15, default_pend=8)
        db = loaded.choose(8, "mpdp_tree", default_chunk=1 << 15,
                           default_pend=8)
        assert (da.space, da.chunk, da.pend_window) == \
            (db.space, db.chunk, db.pend_window)
        assert loaded.drift_rows() == src.drift_rows()

    def test_corrected_graph_equals_reference(self):
        from repro.core import cost as rcost
        from repro.daemon.protocol import graph_to_wire as rwire
        for g in (rgen.chain(6, 9), rgen.typed_query(8, seed=3)):
            rows = {g.names[0]: float(g.log2_card[0]) + 0.75,
                    g.names[2]: 1.5}
            want = rcost.np_corrected_graph(g, rows)
            got = tcost.np_corrected_graph(port(g), rows)
            assert graph_to_wire(got) == rwire(want)
            assert got.log2_sel.tobytes() == want.log2_sel.tobytes()

    def test_uniondp_policy_round_costs_equal_reference(self):
        """A cold table keeps the static re-optimization budget, then both
        packages learn the same budget from the same accepted passes.  The
        tables learn chunks and drain windows but not lane spaces: a space
        learned from the walls of two machines could break an equal-cost
        tie differently in each package and send the rounds apart.  Plans
        are equal or a shown tie (both cost the same)."""
        from tests.test_torch_batch import tjg_plan
        g = rgen.musicbrainz_query(24, seed=5)
        tg = port(g)
        ours = PolicyTable(learn_space=False)
        theirs = rpolicy.PolicyTable(learn_space=False)
        for _ in range(2):
            ref = runiondp.solve(g, k=8, policy=theirs)
            got = uniondp.solve(tg, k=8, policy=ours, device="cpu")
            assert got.info["round_costs"] == ref.info["round_costs"]
            assert (got.cost, got.algorithm) == (ref.cost, ref.algorithm)
            if join_tree(got.plan) != join_tree(ref.plan):
                ct = cost_plan(got.plan, tg).cost
                cr = cost_plan(tjg_plan(ref.plan), tg).cost
                print(f"uniondp under a policy: a tie, plans cost {ct!r} "
                      f"(port) and {cr!r} (reference)")
                assert math.isclose(ct, cr, rel_tol=1e-5)
            assert ours._reopt == theirs._reopt
            assert ours.reopt_rounds_for(4) == theirs.reopt_rounds_for(4)
        plain = uniondp.solve(port(g), k=8, device="cpu")
        assert plain.cost == got.cost


# ============================================================= persistence

class TestPersistence:
    def test_good_file_roundtrips_byte_exact(self, tmp_path):
        t = learned_table()
        p1, p2 = str(tmp_path / "a.policy"), str(tmp_path / "b.policy")
        t.save(p1)
        loaded = PolicyTable.load(p1)
        assert not loaded.stale_load and len(loaded) == len(t)
        loaded.save(p2)
        assert open(p1).read() == open(p2).read()
        da = t.choose(8, "mpdp_tree", default_chunk=1 << 15, default_pend=8)
        db = loaded.choose(8, "mpdp_tree", default_chunk=1 << 15,
                           default_pend=8)
        assert (da.space, da.chunk, da.pend_window) == \
            (db.space, db.chunk, db.pend_window)
        assert loaded.drift_rows() == t.drift_rows()
        assert loaded.reopt_rounds_for(3) == t.reopt_rounds_for(3)

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            PolicyTable.load(str(tmp_path / "nope.policy"))

    @pytest.mark.parametrize("garbage", [
        b"",
        b"\x00\x01\x02 not a literal at all",
        b"{'header': ",
        b"[1, 2, 3]",
        b"{'header': {'version': 999}}",
        b"__import__('os').system('true')",
    ], ids=["empty", "binary", "unterminated", "wrong-shape", "missing-keys",
            "code-injection"])
    def test_corrupt_file_degrades_to_cold(self, tmp_path, garbage):
        path = str(tmp_path / "bad.policy")
        with open(path, "wb") as f:
            f.write(garbage)
        loaded = PolicyTable.load(path)
        assert loaded.stale_load and len(loaded) == 0
        assert loaded.drift_rows() == {}

    def test_truncated_file_degrades_to_cold(self, tmp_path):
        path = str(tmp_path / "full.policy")
        learned_table().save(path)
        size = os.path.getsize(path)
        for frac in (0.25, 0.5, 0.9):
            head = open(path, "rb").read(int(size * frac))
            tpath = str(tmp_path / f"trunc{frac}.policy")
            with open(tpath, "wb") as f:
                f.write(head)
            loaded = PolicyTable.load(tpath)
            assert loaded.stale_load and len(loaded) == 0, f"frac={frac}"

    def test_version_drift_invalidates_whole_file(self, tmp_path):
        path = str(tmp_path / "ver.policy")
        learned_table().save(path)
        text = open(path).read()
        bumped = text.replace(f"'version': {POLICY_FILE_VERSION}",
                              f"'version': {POLICY_FILE_VERSION + 1}", 1)
        assert bumped != text
        with open(path, "w") as f:
            f.write(bumped)
        loaded = PolicyTable.load(path)
        assert loaded.stale_load and len(loaded) == 0

    def test_hyperparameter_drift_invalidates(self, tmp_path):
        path = str(tmp_path / "alpha.policy")
        learned_table().save(path)
        loaded = PolicyTable.load(path, alpha=0.9)
        assert loaded.stale_load and len(loaded) == 0

    def test_tampered_entry_payload_degrades_to_cold(self, tmp_path):
        path = str(tmp_path / "tamper.policy")
        learned_table().save(path)
        text = open(path).read()
        with open(path, "w") as f:
            f.write(text.replace("'entries': [(", "'entries': [(None, ", 1))
        loaded = PolicyTable.load(path)
        assert loaded.stale_load and len(loaded) == 0

    def test_save_leaves_no_temp_droppings(self, tmp_path):
        path = str(tmp_path / "tidy.policy")
        t = learned_table()
        for _ in range(3):
            t.save(path)
        assert os.listdir(tmp_path) == ["tidy.policy"]


# ============================================== cardinality feedback wiring

class TestCardinalityFeedback:
    def test_catalog_matching_stream_is_noop_correction(self):
        g = gen.chain(6, 9)
        t = PolicyTable()
        obs = {name: float(2.0 ** g.log2_card[v])
               for v, name in enumerate(g.names)}
        t.record_execution(g, obs)
        assert t.corrected(g) is g

    def test_corrected_graph_moves_toward_observation(self):
        g = gen.chain(6, 9)
        t = PolicyTable()
        name = g.names[0]
        for _ in range(30):
            t.record_execution(g, {name: 2.0 ** (g.log2_card[0] + 0.5)},
                               log2=False)
        g2 = t.corrected(g)
        assert g2 is not g
        assert math.isclose(g2.log2_card[0], g.log2_card[0] + 0.5,
                            abs_tol=1e-3)
        assert list(g2.log2_card[1:]) == list(g.log2_card[1:])

    def test_drift_invalidates_cached_plans(self):
        g = gen.musicbrainz_query(8, 11)
        cache = PlanCache()
        run_many([g], cache=cache)
        assert len(cache) == 1
        t = PolicyTable()
        dropped = 0
        for _ in range(20):
            dropped += t.record_execution(
                g, {g.names[0]: 2.0 ** (float(g.log2_card[0]) + 6.0)},
                cache=cache)
        assert dropped >= 1 and len(cache) == 0

    def test_frozen_table_ignores_feedback(self):
        g = gen.chain(5, 3)
        t = PolicyTable()
        t.freeze()
        t.record_execution(g, {g.names[0]: 12345.0})
        assert t.drift_rows() == {} and t.stats.row_updates == 0
