"""Typed (non-inner) joins in the port vs the JAX reference, on the CPU.

* the port's ``typed_query``, ``mixed_joins_stream``, ``_bridges`` and
  ``TOPOLOGIES`` give the reference's graphs through the wire codec, seed
  for seed;
* ``cost.join_cost_kind`` (costs to a relative 1e-5, largest ULP distance
  printed), ``conflicts.lane_valid_kinds``, ``joingraph.typed_edge_arrays``
  and the typed ``DeviceGraph`` fields (exact), and
  ``chunks._typed_lane_cost`` (costs to 1e-5, chosen left bitmaps exact)
  against the reference's on the same numpy-seeded inputs;
* the typed branches of the chunk bodies (``chunks._beval_*``, batched
  and, MPDP:Tree and MPDP-general, solo on one-row tables, and the solo
  DPSUB ``engine._eval_dpsub_chunk``) against the reference's six
  (batched and solo DPSUB, MPDP:Tree, MPDP-general) call for call on
  ``typed_pool`` and ``mixed_joins_stream`` graphs: integers exact, costs
  within a relative 1e-5, largest ULP distance printed;
* ``optimize`` and ``optimize_many`` on ``device="cpu"`` against the
  reference's engines (``Counters`` exact, costs to 1e-5, plans equal or a
  tie) and against the brute-force oracle ``tests/oracle.py`` (n <= 7).
  The oracle's ``<= 2`` ulp of ``tests/test_reorderability.py`` is a bound
  between XLA programs: here it holds against the oracle run on the port's
  own torch arithmetic (the ``oracle_costs`` fixture), while against the
  oracle on the reference's XLA arithmetic costs agree to 1e-5 (torch's
  and XLA's ``exp2`` and FMA contraction differ) with the distance printed;
  DPccp at 1e-4 as there;
* ``dpsize`` refuses typed graphs with the reference's ``ValueError``.
"""
import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import batch as rbatch, conflicts as rcf, cost as rcost
from repro.core import engine as reng
from repro.core.joingraph import DeviceGraph as RefDeviceGraph
from repro.core.joingraph import typed_edge_arrays as ref_typed_edge_arrays
from repro.daemon.protocol import graph_to_wire
from repro.workloads import generators as rgen
from repro_torch.core import batch as tbatch, bitset as tbs, chunks as tchunks
from repro_torch.core import conflicts as tcf
from repro_torch.core import cost as tcost
from repro_torch.core import dpccp as tdpccp, engine as teng
from repro_torch.core import joingraph as tjg
from repro_torch.core.plan import validate_plan
from repro_torch.workloads import generators as tgen
from tests import oracle
from tests.helpers import typed_pool
from tests.test_torch_batch import (assert_same_results, one_torch_thread,  # noqa: F401
                                    port)
from tests.test_torch_kernels import PruneLanes, _hold_chunk

REL = 1e-5
POOL = typed_pool(10, sizes=(3, 4, 5, 6, 6, 7))
TREES = typed_pool(6, sizes=(3, 4, 5, 6), seed0=300, tree=True)
STREAM = rgen.mixed_joins_stream(6, seed=0)          # sizes 6..10, nmax 8/16


def max_ulps(got, want) -> int:
    got = np.asarray(got, np.float32).ravel()
    want = np.asarray(want, np.float32).ravel()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=REL)
    return int(np.abs(got[fin].view(np.int32).astype(np.int64)
                      - want[fin].view(np.int32).astype(np.int64)).max(initial=0))


# -------------------------------------------------------------- generators --

TYPED_CASES = [(n, seed, base, knobs) for n, seed, base, knobs in [
    (7, 2, "job", {}), (9, 3, "job", {}), (8, 5, "star", {}),
    (10, 1, "chain", {}), (9, 4, "cycle", {}), (6, 7, "clique", {}),
    (13, 2, "snowflake", {}), (12, 1, "musicbrainz", {}),
    (20, 11, "musicbrainz", {}), (17, 11, "musicbrainz", {}),
    (11, 6, "job", dict(noninner=0.8, mn=0.0)),
    (10, 8, "chain", dict(noninner=0.0, mn=0.0))]]


@pytest.mark.parametrize("n,seed,base,knobs", TYPED_CASES,
                         ids=[f"{c[2]}{c[0]}_{c[1]}" for c in TYPED_CASES])
def test_typed_query_matches_seed_for_seed(n, seed, base, knobs):
    want = rgen.typed_query(n, seed=seed, base=base, **knobs)
    got = tgen.typed_query(n, seed=seed, base=base, **knobs)
    assert tjg.graph_to_wire(got) == graph_to_wire(want)
    assert (got.typed, got.tes_l, got.tes_r) == \
        (want.typed, tuple(want.tes_l), tuple(want.tes_r))
    assert got.log2_sel.tobytes() == np.asarray(want.log2_sel).tobytes()
    assert tgen._bridges(n, list(got.edges)) == rgen._bridges(n, list(want.edges))


@pytest.mark.parametrize("nq,seed,sizes", [(8, 0, (6, 7, 8, 9, 10)),
                                           (16, 0, (12, 13, 14, 15, 16))])
def test_mixed_joins_stream_matches(nq, seed, sizes):
    assert set(tgen.TOPOLOGIES) == set(rgen.TOPOLOGIES)
    for want, got in zip(rgen.mixed_joins_stream(nq, seed=seed, sizes=sizes),
                         tgen.mixed_joins_stream(nq, seed=seed, sizes=sizes)):
        assert tjg.graph_to_wire(got) == graph_to_wire(want)


# ----------------------------------------------------------------- pieces --

def test_join_cost_kind_matches_reference():
    rng = np.random.default_rng(0)
    L = 4096
    rl, rr = (rng.uniform(0.0, 60.0, L).astype(np.float32) for _ in range(2))
    ro = rng.uniform(0.0, 90.0, L).astype(np.float32)
    kind = rng.integers(0, 5, L).astype(np.int32)
    got = tcost.join_cost_kind(*map(torch.from_numpy, (rl, rr, ro, kind)))
    want = rcost.join_cost_kind(*map(jnp.asarray, (rl, rr, ro, kind)))
    assert got.dtype == torch.float32
    u = max_ulps(got.numpy(), want)
    # semi/anti lanes are the hash plan, asymmetric in the operands
    hj = (kind >= 3) & (np.abs(rl - rr) > 1)
    assert (got.numpy()[hj] != tcost.join_cost_kind(
        *map(torch.from_numpy, (rr, rl, ro, kind))).numpy()[hj]).any()
    print(f"join_cost_kind: largest difference {u} ulp")


def conflict_lanes(g, L: int, seed: int):
    """Random (lb, rb) splits of subsets of g's relations (some empty)."""
    rng = np.random.default_rng(seed)
    S = rng.integers(0, 1 << g.n, L)
    lb = S & rng.integers(0, 1 << g.n, L)
    return lb.astype(np.int32), (S & ~lb).astype(np.int32)


@pytest.mark.parametrize("gi", range(6))
def test_lane_valid_kinds_matches_reference(gi):
    """Solo ``(emax,)`` and batched ``(chunk, emax)`` edge arrays."""
    g = (POOL + STREAM)[gi * 2]
    emax = max(8, -(-g.m // 8) * 8)
    arrs = ref_typed_edge_arrays(g, emax)
    lb, rb = conflict_lanes(g, 2048, gi)
    want = rcf.lane_valid_kinds(*map(jnp.asarray, (lb, rb, *arrs)))
    got = tcf.lane_valid_kinds(*map(torch.from_numpy, (lb, rb, *arrs)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got[0].all() and got[2].any()        # the mask bites
    # batched: a stack of queries gathered per lane
    graphs = (POOL + STREAM)[gi: gi + 4]
    emax = max(8, -(-max(h.m for h in graphs) // 8) * 8)
    stack = np.stack([np.stack(ref_typed_edge_arrays(h, emax)) for h in graphs])
    qid = np.random.default_rng(gi).integers(0, len(graphs), 2048)
    per_lane = [stack[qid, k] for k in range(5)]
    want = rcf.lane_valid_kinds(*map(jnp.asarray, (lb, rb, *per_lane)))
    got = tcf.lane_valid_kinds(*map(torch.from_numpy, (lb, rb, *per_lane)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("g", POOL[:3] + STREAM[:3] + [rgen.chain(6, 1)],
                         ids=[f"g{i}" for i in range(7)])
def test_typed_edge_arrays_and_device_graph_match_reference(g):
    emax = max(8, -(-g.m // 8) * 8)
    for a, b in zip(tjg.typed_edge_arrays(port(g), emax),
                    ref_typed_edge_arrays(g, emax)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    want = RefDeviceGraph.from_graph(g)
    got = tjg.DeviceGraph.from_graph(port(g), "cpu")
    assert got.typed == want.typed
    for f in ("ekind", "elm", "erm", "etes_l", "etes_r"):
        if g.typed:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        else:                       # inner-only: no conflict arrays at all
            assert getattr(got, f) is None
            assert not np.asarray(getattr(want, f)).any()


def test_typed_lane_cost_matches_reference():
    """Random memo values and splits over the typed graphs, solo and
    batched edge arrays; ccp masks some lanes off."""
    worst = 0
    for gi, g in enumerate(POOL[:4] + STREAM[:4]):
        emax = max(8, -(-g.m // 8) * 8)
        arrs = ref_typed_edge_arrays(g, emax)
        rng = np.random.default_rng(gi)
        L = 2048
        lb, rb = conflict_lanes(g, L, gi + 10)
        rows_S = rng.uniform(0.0, 80.0, L).astype(np.float32)
        ccp = rng.random(L) < 0.8
        cl, cr = (rng.uniform(1.0, 1e9, L).astype(np.float32) for _ in range(2))
        rl, rr = (rng.uniform(0.0, 50.0, L).astype(np.float32) for _ in range(2))
        args = (lb, rb, rows_S, ccp, cl, cr, rl, rr, *arrs)
        want = reng._typed_lane_cost(*map(jnp.asarray, args))
        got = tchunks._typed_lane_cost(*map(torch.from_numpy, args))
        worst = max(worst, max_ulps(got[0].numpy(), want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert (got[1].numpy() == rb).any()      # some lanes turn around
    print(f"_typed_lane_cost: largest difference {worst} ulp")


# ------------------------------------------------------------ chunk bodies --

def _j(x):
    return jnp.asarray(x.numpy()) if torch.is_tensor(x) else x


def run_held(module, name, want_fn, run):
    """Run ``run()`` with ``module.name`` held against ``want_fn`` call for
    call (``_hold_chunk``: a segment's left bitmap may differ only in a
    tie it shows); returns (calls, largest ULP distance, ties)."""
    real = getattr(module, name)
    worst, ties = [0, 0], []
    mp = pytest.MonkeyPatch()
    lanes = PruneLanes(mp)

    def held(*args, **kw):
        got = real(*args, **kw)
        want = want_fn(args, kw)
        worst[0] = max(worst[0], _hold_chunk(got, want,
                                             f"{name} call {worst[1]}",
                                             lanes.last, ties))
        worst[1] += 1
        return got

    mp.setattr(module, name, held)
    try:
        run()
    finally:
        mp.undo()
    return worst[1], worst[0], ties


BATCH_SETS = {"pool": (POOL[:6], 64), "stream": (STREAM, 1024),
              "trees": (TREES, 64)}


@pytest.mark.parametrize("space,which", [("dpsub", "pool"), ("dpsub", "stream"),
                                         ("mpdp_tree", "trees"),
                                         ("mpdp_tree", "stream"),
                                         ("mpdp_general", "pool"),
                                         ("mpdp_general", "stream")])
def test_batched_typed_chunk_bodies_match_reference(space, which):
    graphs, chunk = BATCH_SETS[which]
    if space == "mpdp_tree":
        graphs = [g for g in graphs if g.is_tree()]
    pgraphs = [port(g) for g in graphs]
    nmax = max(tbs.nmax_bucket(g.n) for g in graphs)
    bcap = rbatch._bcap(len(graphs))
    static = dict(nmax=nmax, chunk=chunk, bcap=bcap, pallas=False, typed=True)
    if space == "mpdp_general":
        name = "_beval_general_chunk"
        ref_fn = jax.jit(partial(rbatch._beval_general_chunk, **static),
                         static_argnames=("pcap",))

        def want_fn(args, kw):
            pairs, n_pairs, lane_count, adj_b, mc, mr = args
            return ref_fn(*[jnp.asarray(x) for x in pairs.numpy()], n_pairs,
                          lane_count, *map(_j, (adj_b, mc, mr)),
                          *map(_j, kw["targs"]), pcap=pairs.shape[1])
    else:
        name = "_beval_dpsub_chunk" if space == "dpsub" else "_beval_tree_chunk"
        ref_fn = jax.jit(partial(getattr(rbatch, name), nseg=chunk + 2,
                                 **static))

        def want_fn(args, kw):
            return ref_fn(*map(_j, args), *map(_j, kw["targs"]))

    calls, worst, ties = run_held(
        tchunks, name, want_fn, lambda: tbatch.BatchEngine(
            pgraphs, chunk=chunk, algorithm=space, device="cpu").run())
    assert calls >= max(g.n for g in graphs) - 1
    print(f"{space} {which}: {calls} typed chunks, largest cost difference "
          f"{worst} ulp, {len(ties)} segments tied by rounding "
          f"(first: {ties[:3]})")


SOLO_CASES = [("dpsub", POOL[5]), ("dpsub", STREAM[4]), ("mpdp_tree", TREES[3]),
              ("mpdp_tree", STREAM[1]), ("mpdp_general", POOL[9]),
              ("mpdp_general", STREAM[0])]


@pytest.mark.parametrize("space,g", SOLO_CASES,
                         ids=[f"{s}_{g.n}" for s, g in SOLO_CASES])
def test_solo_typed_chunk_bodies_match_reference(space, g):
    chunk = 256
    tg = port(g)
    module = tchunks
    if space == "dpsub":
        module, name = teng, "_eval_dpsub_chunk"

        def want_fn(args, kw):
            return reng._eval_dpsub_chunk(*map(_j, args),
                                          *[_j(a[0]) for a in kw["targs"]],
                                          nmax=kw["nmax"], chunk=kw["chunk"],
                                          nseg=kw["nseg"], typed=True)
    elif space == "mpdp_tree":
        name = "_beval_tree_chunk"

        def want_fn(args, kw):
            all_sets, eoff, loff, soff, seg0, m1, adj1, emu1, emv1, mc, mr = args
            assert (kw["bcap"], seg0, int(soff[0])) == (1, 0, 0)
            return reng._eval_tree_chunk(
                _j(all_sets), jnp.int32(int(loff[0])), jnp.int32(0),
                jnp.int32(-int(eoff[0])), jnp.int32(int(m1[0])),
                jnp.int32(int(eoff[1])),
                *map(_j, (adj1[0], emu1[0], emv1[0], mc, mr)),
                *[_j(a[0]) for a in kw["targs"]], nmax=kw["nmax"],
                chunk=kw["chunk"], nseg=kw["nseg"], typed=True)
    else:
        name = "_beval_general_chunk"

        def want_fn(args, kw):
            pairs, n_pairs, lane_count, adj1, mc, mr = args
            assert kw["bcap"] == 1
            rows = [jnp.asarray(x) for x in pairs.numpy()]
            return reng._eval_general_chunk(
                rows[0], rows[1], rows[3], jnp.int32(n_pairs),
                jnp.int32(lane_count), *map(_j, (adj1[0], mc, mr)),
                *[_j(a[0]) for a in kw["targs"]], nmax=kw["nmax"],
                chunk=kw["chunk"], pcap=pairs.shape[1], typed=True)

    calls, worst, ties = run_held(module, name, want_fn, lambda: teng.optimize(
        tg, space, chunk=chunk, device="cpu"))
    assert calls >= g.n - 1
    print(f"solo {space} n={g.n}: {calls} typed chunks, largest cost "
          f"difference {worst} ulp, {len(ties)} segments tied by rounding "
          f"(first: {ties[:3]})")


# --------------------------------------------------------------- engines --

def _graphs_for(algo):
    return TREES if algo == "mpdp_tree" else POOL


@pytest.fixture(scope="module")
def oracle_costs():
    """Oracle minima of POOL and TREES: on the reference's XLA arithmetic,
    and on the port's torch arithmetic."""
    def port_cand(base, rl, rr, ro, kinds, *, typed):
        t = [torch.from_numpy(np.asarray(x)) for x in (rl, rr)]
        ro = torch.full_like(t[0], float(ro))
        jc = (tcost.join_cost_kind(t[0], t[1], ro, torch.from_numpy(kinds))
              if typed else tcost.join_cost(t[0], t[1], ro))
        return (torch.from_numpy(base) + jc).numpy()

    out = {}
    for key, graphs in (("pool", POOL), ("trees", TREES)):
        out[key] = [np.float32(oracle.solve(g)[0]) for g in graphs]
        mp = pytest.MonkeyPatch()
        mp.setattr(oracle, "_cand_kernel", port_cand)
        try:
            out[key + "_port"] = [np.float32(oracle.solve(g)[0])
                                  for g in graphs]
        finally:
            mp.undo()
    return out


def hold_oracle(g, r, xla_cost, port_cost) -> int:
    """Valid plan under the oracle's own rules and the port's; the cost
    within the reorderability suite's 2 ulp of the oracle on the port's
    arithmetic and within 1e-5 of it on the reference's.  Returns the
    latter distance in ulps."""
    assert oracle.plan_valid(g, r.plan)
    validate_plan(r.plan, port(g))
    assert oracle.ulp_diff(r.cost, port_cost) <= 2, (r.cost, float(port_cost))
    assert math.isclose(r.cost, float(xla_cost), rel_tol=REL)
    return oracle.ulp_diff(r.cost, xla_cost)


@pytest.mark.parametrize("algo", ["dpsub", "mpdp_general", "mpdp_tree", "mpdp",
                                  "auto"])
def test_solo_matches_oracle_and_reference(algo, oracle_costs):
    key = "trees" if algo == "mpdp_tree" else "pool"
    graphs = _graphs_for(algo)
    worst = [0, 0]
    for g, oc, pc in zip(graphs, oracle_costs[key], oracle_costs[key + "_port"]):
        got = teng.optimize(port(g), algo, device="cpu")
        worst[0] = max(worst[0], hold_oracle(g, got, oc, pc))
        worst[1] = max(worst[1], assert_same_results(
            [g], [reng.optimize(g, algo)], [got]))
    print(f"solo {algo}: largest difference {worst[0]} ulp to the oracle, "
          f"{worst[1]} ulp to the reference")


def test_dpccp_matches_oracle_and_reference(oracle_costs):
    for g, oc in zip(POOL, oracle_costs["pool"]):
        got = teng.optimize(port(g), "dpccp", device="cpu")
        assert abs(got.cost - float(oc)) <= 1e-4 * max(1.0, float(oc))
        assert oracle.plan_valid(g, got.plan)
        assert_same_results([g], [reng.optimize(g, "dpccp")], [got])
        assert got.cost == tdpccp.solve(port(g)).cost


@pytest.mark.parametrize("algo", ["dpsub", "mpdp_general", "mpdp_tree", "auto"])
def test_batched_matches_oracle_and_reference(algo, oracle_costs):
    key = "trees" if algo == "mpdp_tree" else "pool"
    graphs = _graphs_for(algo)
    got = tbatch.optimize_many([port(g) for g in graphs], algo, device="cpu")
    worst = max(hold_oracle(g, r, oc, pc) for g, r, oc, pc in zip(
        graphs, got, oracle_costs[key], oracle_costs[key + "_port"]))
    ref = rbatch.optimize_many(graphs, algo)
    u = assert_same_results(graphs, ref, got)
    # a typed query batched equals the same query solo, bit for bit
    for g, r in zip(graphs, got):
        solo = teng.optimize(port(g), algo, device="cpu")
        assert np.float32(r.cost) == np.float32(solo.cost)
    print(f"batched {algo}: largest difference {worst} ulp to the oracle, "
          f"{u} ulp to the reference")


@pytest.mark.parametrize("algo", ["auto", "dpsub"])
def test_mixed_stream_matches_reference(algo):
    """Typed and inner queries in one stream: they fly apart, the inner
    ones exactly as in an inner-only run."""
    inner = [rgen.chain(8, 1), rgen.cycle(7, 2), rgen.star(9, 3)]
    graphs = STREAM + inner
    got = tbatch.optimize_many([port(g) for g in graphs], algo, device="cpu")
    u = assert_same_results(graphs, rbatch.optimize_many(graphs, algo), got)
    alone = tbatch.optimize_many([port(g) for g in inner], algo, device="cpu")
    for a, b in zip(got[len(STREAM):], alone):
        assert a.cost == b.cost and a.counters == b.counters
    print(f"{algo}: largest cost difference {u} ulp")


def test_dpsize_refuses_typed_graphs():
    g = port(POOL[0])
    with pytest.raises(ValueError, match="dpsize"):
        teng.optimize(g, "dpsize", device="cpu")
    with pytest.raises(ValueError, match="dpsize"):
        tbatch.optimize_many([g], "dpsize", device="cpu")
    with pytest.raises(ValueError, match="dpsize"):
        reng.optimize(POOL[0], "dpsize")
