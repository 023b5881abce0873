"""The solo slice of the port (``ExactEngine`` / ``optimize``) vs the JAX
reference, on the CPU.

* ``optimize(..., device="cpu")`` equals the reference's ``optimize`` on
  the ``tests/test_exact.py`` graphs under mpdp, dpsub, dpsize and dpccp,
  and under the options that change the engine's path (frontier
  expansion, the host-oracle phase A, chunks smaller than a level, the
  nmax-24 bucket, forced lane spaces): ``algorithm`` strings and
  ``Counters`` exactly, costs to a relative 1e-5 (the largest ULP distance
  is printed), plans equal or a tie broken by rounding;
* the paper's Theorem 3 (tree: every evaluated pair is a CCP) and Lemma 9
  (clique: the same for MPDP-general) hold;
* ``optimize_many`` routes the queries no batched lane space serves to the
  solo engine, as the reference does;
* the options once refused (a typed graph, a deadline, the lattice) now
  equal the reference, and no card without ``device="cpu"`` raises;
* the chunk layer's accumulator (``chunks.ChunkResults``), under every
  engine's level loop, equals a direct NumPy fold of the same chunk
  results in both of its modes and at drain limits 0, 1 and 8.
"""
import numpy as np
import pytest
import torch

from repro.core import batch as rbatch, engine as reng
from repro.workloads import generators as rgen
from repro_torch.core import chunks as tchunks, engine as teng
from repro_torch.core.config import OptimizerConfig
from repro_torch.kernels import ref as tref
from tests.helpers import rand_graph
from tests.test_torch_batch import (assert_same_results, one_torch_thread,  # noqa: F401
                                    port)

CASES = [
    ("star8", rgen.star(8, 1)),
    ("snow9", rgen.snowflake(9, 2)),
    ("chain8", rgen.chain(8, 3)),
    ("cycle7", rgen.cycle(7, 4)),
    ("clique6", rgen.clique(6, 5)),
    ("mb10", rgen.musicbrainz_query(10, 6)),
    ("rand9", rand_graph(9, 4, 7)),
]
GRAPHS = dict(CASES)


def check_same(g, **kw):
    ref = reng.optimize(g, **kw)
    got = teng.optimize(port(g), device="cpu", **kw)
    worst = assert_same_results([g], [ref], [got])
    print(f"{kw}: n={g.n} {got.algorithm} largest cost difference {worst} ulp")
    return ref, got


@pytest.mark.parametrize("name,g", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("algo", ["mpdp", "dpsub", "dpsize", "dpccp"])
def test_optimize_matches_reference(name, g, algo):
    check_same(g, algorithm=algo)


OPTIONS = {
    "expand_mpdp_mb10": (GRAPHS["mb10"], dict(algorithm="mpdp", enum="expand")),
    "expand_dpsub_rand9": (GRAPHS["rand9"], dict(algorithm="dpsub",
                                                 enum="expand")),
    "cyc_cap2_host_oracle": (rand_graph(8, 12, 11), dict(algorithm="mpdp",
                                                          cyc_cap=2)),
    "chunk512_general": (GRAPHS["rand9"], dict(algorithm="mpdp", chunk=512)),
    "chunk512_tree": (GRAPHS["snow9"], dict(algorithm="mpdp", chunk=512)),
    "chunk512_dpsub": (GRAPHS["mb10"], dict(algorithm="dpsub", chunk=512)),
    "chunk512_dpsize": (GRAPHS["cycle7"], dict(algorithm="dpsize", chunk=512)),
    "nmax24_chain17": (rgen.chain(17, 1), dict(algorithm="mpdp")),
    "tree_forced": (GRAPHS["snow9"], dict(algorithm="mpdp_tree")),
    "general_forced_on_tree": (GRAPHS["star8"], dict(algorithm="mpdp_general")),
}


@pytest.mark.parametrize("case", list(OPTIONS))
def test_optimize_options_match_reference(case):
    g, kw = OPTIONS[case]
    check_same(g, **kw)


def test_theorem3_tree_no_invalid_pairs():
    ref, got = check_same(rgen.star(10, 2), algorithm="mpdp")
    assert got.algorithm == "mpdp_tree"
    assert got.counters.evaluated == got.counters.ccp


def test_lemma9_clique_no_invalid_pairs():
    ref, got = check_same(rgen.clique(7, 3), algorithm="mpdp")
    assert got.algorithm == "mpdp_general"
    assert got.counters.evaluated == got.counters.ccp


def test_timings_name_the_stages():
    got = teng.optimize(port(GRAPHS["rand9"]), "mpdp", device="cpu")
    assert got.algorithm == "mpdp_general"
    assert set(got.timings) == {"filter", "blocks", "evaluate"}
    assert all(v >= 0 for v in got.timings.values())


def test_leaf_query():
    one = port(rgen.chain(1, 1))
    got = teng.optimize(one, device="cpu")
    assert got.plan.is_leaf and got.algorithm == "auto"


# ------------------------------------------------------------ optimize_many --

def test_optimize_many_mixes_batched_and_solo():
    """n <= 16 queries batch, the 17-relation one goes solo."""
    graphs = [rgen.chain(8, 1), rgen.cycle(7, 2), rgen.chain(17, 3),
              rgen.musicbrainz_query(10, 4), rgen.star(6, 5)]
    ref = rbatch.optimize_many(graphs, "auto")
    got = teng.optimize_many([port(g) for g in graphs], "auto", device="cpu")
    assert [r.algorithm for r in got] == \
        ["batch_mpdp_tree", "batch_mpdp_general", "mpdp_tree",
         "batch_mpdp_general", "batch_mpdp_tree"]
    assert_same_results(graphs, ref, got)


# --------------------------------------------------------- outside the slice --

G6_REF = rgen.cycle(6, 1)
G6 = port(G6_REF)
OUTSIDE = {
    "deadline": (G6, dict(config=OptimizerConfig(deadline_s=1.0))),
    "lattice": (G6, dict(config=OptimizerConfig(lattice=True, devices=2))),
    "typed": (rgen.typed_query(7, seed=2), {}),
}


@pytest.mark.parametrize("case", list(OUTSIDE))
def test_outside_slice_raises(case, monkeypatch):
    g, kw = OUTSIDE[case]
    if case == "typed":                  # ported: equals the reference
        assert check_same(g)[1].algorithm == "mpdp_tree"
        return
    if case == "deadline":               # ported: equals the reference
        import itertools
        from repro.core import faults as rfaults
        from repro.core.config import OptimizerConfig as RConfig
        from repro_torch.core import faults as tfaults
        for mod in (rfaults, tfaults):   # the clock ticks once a call, so
            clock = itertools.count()    # deadline_s=1.0 expires at level 2
            monkeypatch.setattr(mod, "now", lambda c=clock: next(c))
        ref = reng.optimize(G6_REF, config=RConfig(deadline_s=1.0))
        got = teng.optimize(g, device="cpu", **kw)
        assert got.info["degraded"] == ref.info["degraded"]
        assert got.info["degraded"]["levels_done"] == 1
        assert_same_results([G6_REF], [ref], [got])
        return
    # the lattice, on 2 logical CPU shards: equals the reference's
    from repro.core.config import OptimizerConfig as RConfig
    from repro_torch.hostdev import ensure_host_devices
    ensure_host_devices(4)
    ref = reng.optimize(G6_REF, config=RConfig(lattice=True, devices=2))
    got = teng.optimize(g, device="cpu", **kw)
    assert got.algorithm == "lattice_mpdp_general"
    assert_same_results([G6_REF], [ref], [got])


def test_lattice_devices_kwarg_raises():
    """The legacy spelling warns and runs the lattice, as the config
    does."""
    from repro_torch.hostdev import ensure_host_devices
    ensure_host_devices(4)
    with pytest.warns(DeprecationWarning):
        got = teng.optimize(G6, lattice_devices=2, device="cpu")
    want = teng.optimize(G6, config=OptimizerConfig(lattice=True, devices=2),
                         device="cpu")
    assert (got.algorithm, got.cost, got.counters.evaluated) == \
        (want.algorithm, want.cost, want.counters.evaluated)


def test_no_card_raises_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.optimize(G6)


# ------------------------------------------------------- chunk results --

def _made_up_chunk(rng, nseg: int, bcap: int):
    """One chunk body's results as the torch epilogue returns them:
    segment minima with ties (costs from a few values) and all-``INF``
    segments (left 0 or the empty segment's int32 min, as ``_prune``
    leaves them), and per-query counts of ``bcap`` rows."""
    cost = rng.choice(np.float32([1.0, 2.0, 3.0, np.inf]), nseg)
    left = rng.integers(1, 1 << 20, nseg).astype(np.int32)
    inf = ~np.isfinite(cost)
    left[inf] = rng.choice(np.int32([0, -(1 << 31)]), int(inf.sum()))
    ev, ccp = (rng.integers(0, 1 << 16, bcap).astype(np.int32)
               for _ in range(2))
    return cost, left, ev, ccp


@pytest.mark.parametrize("limit", [0, 1, 8])
@pytest.mark.parametrize("mode", ["contiguous", "pair"])
def test_chunk_results_equal_a_direct_fold(mode, limit, monkeypatch):
    """``chunks.ChunkResults`` over random chunk results (torch epilogue
    tensors and fused ``Pruned`` buffers alternately): fetched in launch
    order down to the drain limit, and its best arrays and per-query
    counts equal a direct lexicographic (min cost, then max left) fold of
    the same candidates, where a set with no finite candidate keeps
    (``INF``, 0).  Contiguous chunks start at random segments, some
    partly outside the level; pair chunks cover overlapping windows of
    pairs, several pairs a set, padded past their last pair; set 7 gets
    only ``INF`` candidates."""
    rng = np.random.default_rng(limit * 2 + (mode == "pair"))
    nsets, nq, bcap = 40, 3, 4
    pk = np.sort(rng.integers(0, nsets, 120)).astype(np.int64)
    acc = tchunks.ChunkResults(nsets, nq, pk if mode == "pair" else None)
    fetched, real = [], tchunks._fetch
    monkeypatch.setattr(tchunks, "_fetch",
                        lambda out: fetched.append(id(out)) or real(out))
    keys, costs, lefts, launched = [], [], [], []
    ev, ccp = np.zeros(nq, np.int64), np.zeros(nq, np.int64)
    p0 = 0
    for c in range(30):
        if mode == "contiguous":
            nseg = 10
            key = int(rng.integers(-3, nsets - 4))
            seg = key + np.arange(nseg)
            ok = (seg >= 0) & (seg < nsets)
        else:
            npair = int(rng.integers(1, 12))
            if p0 + npair > len(pk):
                p0 = 0
            nseg = tchunks._cap(npair, 16)
            key = (p0, npair)
            seg = np.full(nseg, -1)
            seg[:npair] = pk[p0: p0 + npair]
            ok = seg >= 0
            p0 += npair - int(rng.integers(0, 2))      # a pair may straddle
        sc, sl, e, cc = _made_up_chunk(rng, nseg, bcap)
        if mode == "pair":
            sc[npair:], sl[npair:] = np.inf, -(1 << 31)
        sc[seg == 7], sl[seg == 7] = np.inf, 0     # set 7: all-INF segments
        keys.append(seg[ok])
        costs.append(sc[ok])
        lefts.append(sl[ok])
        ev += e[:nq]
        ccp += cc[:nq]
        t = [torch.from_numpy(x) for x in (sc, sl, e, cc)]
        out = (tchunks.Pruned(tref.pack_pruned(*t), bcap) if c % 2
               else tuple(t))
        launched.append(id(out))
        acc.add(key, out)
        acc.drain(limit)
        assert fetched == launched[: max(0, len(launched) - limit)]
    best_cost, best_left, got_ev, got_ccp = acc.finish()
    assert fetched == launched
    want_cost = np.full(nsets, np.inf, np.float32)
    want_left = np.zeros(nsets, np.int32)
    for k, c, lf in zip(*map(np.concatenate, (keys, costs, lefts))):
        if np.isfinite(c) and (c, -lf) < (want_cost[k], -want_left[k]):
            want_cost[k], want_left[k] = c, lf
    assert best_cost.dtype == np.float32 and best_left.dtype == np.int32
    np.testing.assert_array_equal(best_cost, want_cost)
    np.testing.assert_array_equal(best_left, want_left)
    assert np.isinf(want_cost[7]) and (want_left[np.isfinite(want_cost)]
                                       > 0).all()
    np.testing.assert_array_equal(got_ev, ev)
    np.testing.assert_array_equal(got_ccp, ccp)
