"""The port's executor (``repro_torch.execution.executor``) vs the JAX
reference's (``repro.execution.executor``), on the CPU.

* ``generate_data`` gives the reference's key arrays bit for bit (the same
  numpy draws, placed on the device);
* ``execute`` on the same graph (through the wire codec), the same data
  seed and the same plan (the reference's, carried across) gives the
  reference's raw ``rows`` (join order and every column) and
  ``canonical()`` bit for bit, also where the key packing wraps in int64
  and on typed graphs, which both execute as inner equi-joins; where a
  join packs four predicates the wrapped keys collide, and the port finds
  the reference's extra rows;
* the mirror of ``tests/test_executor.py``: the port's ``mpdp``, ``dpsub``,
  GOO, IDP2 and UnionDP plans all give the same canonical rows.
"""
import numpy as np
import pytest
import torch

from repro.core import dpccp as rdpccp, engine as reng
from repro.core.plan import join_plans as rjoin_plans, leaf_plan as rleaf_plan
from repro.core.joingraph import JoinGraph as RJoinGraph
from repro.execution import executor as rex
from repro.heuristics import goo as rgoo
from repro.workloads import generators as rgen
from repro_torch.core import engine as teng
from repro_torch.core.plan import Plan
from repro_torch.execution import executor as tex
from repro_torch.heuristics import goo, idp, uniondp
from tests.helpers import rand_graph
from tests.test_torch_batch import one_torch_thread, port, tjg_plan  # noqa: F401


def k4_wrap():
    """K4 whose bushy plan's last join, (0 1) x (2 3), packs four
    predicates with key domains of 16: k0 * 2^60 overflows int64 for
    k0 >= 8, so the packed keys wrap."""
    g = RJoinGraph.make(4, [(0, 1), (2, 3), (0, 2), (0, 3), (1, 2), (1, 3)],
                        [1e4] * 4, [0.5, 0.5] + [1 / 16] * 4)
    leaves = [rleaf_plan(v, g) for v in range(4)]
    plan = rjoin_plans(rjoin_plans(leaves[0], leaves[1], g),
                       rjoin_plans(leaves[2], leaves[3], g), g)
    return g, plan


CASES = {
    "mb9": (rgen.musicbrainz_query(9, 5), None),
    "job8": (rgen.job_like(8, 2), None),
    "rand8": (rand_graph(8, 3, 9), None),
    "k4wrap": k4_wrap(),
    "typed9": (rgen.typed_query(9, seed=1), None),         # 44 result rows
    "hyper8": (rgen.hypergraph_query(8, seed=0), None),    # 16 result rows
}


def ref_plan(g):
    return reng.optimize(g, "mpdp").plan if not g.typed else rdpccp.solve(g).plan


def assert_same_data(rd, td):
    assert sorted(rd) == sorted(td)
    for v in rd:
        assert td[v]["n"] == rd[v]["n"]
        assert sorted(td[v]["cols"]) == sorted(rd[v]["cols"])
        for e, a in rd[v]["cols"].items():
            t = td[v]["cols"][e]
            assert t.dtype == torch.int64 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("case", list(CASES))
def test_execute_matches_reference(case):
    g, plan = CASES[case]
    plan = plan or ref_plan(g)
    rd = rex.generate_data(g, max_rows=250, seed=1)
    td = tex.generate_data(port(g), max_rows=250, seed=1, device="cpu")
    assert_same_data(rd, td)
    want = rex.execute(plan, g, rd)
    got = tex.execute(tjg_plan(plan), port(g), td)
    assert got.rels == want.rels
    assert got.rows.dtype == torch.int64
    assert got.numpy().shape == want.rows.shape
    assert got.numpy().tobytes() == want.rows.tobytes()
    assert got.canonical().numpy().tobytes() == want.canonical().tobytes()
    assert got.count == want.count


def test_key_packing_wraps_as_the_reference():
    """The k4wrap case really wraps: some packed key of its last join
    exceeds int64 before wrapping, and the result is not empty."""
    g, plan = CASES["k4wrap"]
    rd = rex.generate_data(g, max_rows=250, seed=1)
    left = rex.execute(plan.left, g, rd)
    preds = [e for e, (u, v) in enumerate(g.edges) if (u < 2) != (v < 2)]
    assert len(preds) == 4
    unwrapped = np.zeros(left.count)
    for e in preds:
        u = g.edges[e][0]
        col = rd[u]["cols"][e][left.rows[:, left.rels.index(u)]]
        unwrapped = unwrapped * float(1 << 20) + col
    assert (unwrapped >= 2.0 ** 63).any()
    assert rex.execute(plan, g, rd).count > 0


def test_wrapped_key_collisions_match_reference():
    """The packing's wrap collides where a join packs four predicates:
    on ``hypergraph_query(20, seed=0)`` GOO's plan then finds rows that
    fail a predicate, in both packages alike; the mpdp plan's join packs
    three and finds exactly the rows that satisfy every predicate."""
    g = rgen.hypergraph_query(20, seed=0)
    rd = rex.generate_data(g, max_rows=300, seed=12)
    td = tex.generate_data(port(g), max_rows=300, seed=12, device="cpu")
    goo_plan, mpdp_plan = rgoo.solve(g).plan, reng.optimize(g, "mpdp").plan
    got = {}
    for name, plan in (("goo", goo_plan), ("mpdp", mpdp_plan)):
        want = rex.execute(plan, g, rd)
        got[name] = tex.execute(tjg_plan(plan), port(g), td)
        assert got[name].numpy().tobytes() == want.rows.tobytes()
    rows = got["goo"].numpy()
    true = np.ones(len(rows), bool)
    for e, (u, v) in enumerate(g.edges):
        true &= (rd[u]["cols"][e][rows[:, u]] == rd[v]["cols"][e][rows[:, v]])
    assert got["goo"].count > true.sum() == got["mpdp"].count > 0
    np.testing.assert_array_equal(
        tex.ExecResult(got["goo"].rels,
                       torch.from_numpy(rows[true])).canonical().numpy(),
        got["mpdp"].canonical().numpy())


@pytest.mark.parametrize("case", ["mb9", "job8", "rand8"])
def test_all_plans_same_result(case):
    """The mirror of ``tests/test_executor.py``: every optimizer's plan
    gives the same canonical rows on the port."""
    g = port(CASES[case][0])
    data = tex.generate_data(g, max_rows=250, seed=1, device="cpu")
    plans = [teng.optimize(g, "mpdp", device="cpu").plan,
             teng.optimize(g, "dpsub", device="cpu").plan,
             goo.solve(g).plan, idp.solve(g, k=5, device="cpu").plan,
             uniondp.solve(g, k=5, device="cpu").plan]
    ref = None
    for p in plans:
        c = tex.execute(p, g, data).canonical()
        if ref is None:
            ref = c
        else:
            assert c.shape == ref.shape and torch.equal(c, ref)


def test_rowcounts_track_selectivity():
    g = port(rgen.chain(5, 1))
    data = tex.generate_data(g, max_rows=500, seed=2, device="cpu")
    r = tex.execute(teng.optimize(g, "mpdp", device="cpu").plan, g, data)
    assert r.count >= 0


def test_canonical_is_numpy_lexsort():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 4, (500, 5)).astype(np.int64)   # many equal keys
    res = tex.ExecResult(list(range(5)), torch.from_numpy(rows))
    want = rows[np.lexsort(rows.T[::-1])]
    assert res.canonical().numpy().tobytes() == want.tobytes()


def test_execute_timed_and_cross_product():
    g = port(rgen.chain(4, 3))
    data = tex.generate_data(g, max_rows=100, seed=0, device="cpu")
    p = teng.optimize(g, "mpdp", device="cpu").plan
    res, secs = tex.execute_timed(p, g, data)
    assert secs >= 0 and torch.equal(res.rows, tex.execute(p, g, data).rows)
    # relations 0 and 2 of a chain share no predicate
    a, b = (Plan(rel_set=1 << v, cost=0.0, rows_log2=0.0) for v in (0, 2))
    with pytest.raises(ValueError, match="cross product"):
        tex.execute(Plan(rel_set=0b101, cost=0.0, rows_log2=0.0, left=a,
                         right=b), g, data)


def test_no_card_without_device_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.generate_data(port(rgen.chain(4, 3)))
