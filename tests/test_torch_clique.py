"""Clique join graphs (MPDP paper, SIGMOD 2022, §7.1) in the port, on the
CPU.

* the batched and the solo engines' costs equal the plain reference
  (``portbench.reference.exact``, NumPy float64 over csg-cmp pairs)
  within 1e-5 relative, with valid join trees, under ``auto``,
  ``mpdp_general`` and ``dpsub``, on seeded cliques of 4-10 relations;
* phase A's dense path (``blocks.np_pairs_for_sets`` past ``cyc_cap``)
  gives the (set, block) pairs of the host oracle ``np_find_blocks`` on
  cliques and on two 8-cliques sharing one vertex, whose crossing sets
  have a cut vertex and go to the oracle;
* with the recorder on, ``blocks.dense`` lies inside ``engine.phase_a``
  with ``engine.fetch`` inside it, ``engine.chunk`` inside
  ``engine.evaluate``, with no fetch inside it (the fused chunks fold on
  the device) and, where chunks are read back (the host fold), as a leaf
  (the fetches it times keep ``engine.evaluate`` as their parent), the
  ``engine.chunks`` counter equals the engine's
  ``chunks_dispatched``, and a clique's counters are the same for every
  seed; with it off nothing is recorded.

This file imports no JAX.  Every test leaves the recorder off and empty.
"""
from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from portbench.reference import exact
from portbench.reference.plans import invalid_reason
from portbench.stream import plan_shape
from repro_torch.core import batch, chunks as tchunks, engine, telemetry
from repro_torch.core import blocks as bl
from repro_torch.core.joingraph import JoinGraph, graph_to_wire
from repro_torch.workloads import generators as gen

SEEDS = (3, 2**31 + 7)


@pytest.fixture(autouse=True)
def one_torch_thread_recorder_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.disable()
    telemetry.clear()
    yield
    telemetry.disable()
    telemetry.clear()
    torch.set_num_threads(n)


def two_cliques() -> JoinGraph:
    """Two 8-cliques sharing vertex 7: 15 relations, 56 edges, mu = 42."""
    edges = [(u, v) for part in (range(8), range(7, 15))
             for u in part for v in part if u < v]
    rng = np.random.default_rng(5)
    return JoinGraph.make(15, edges, list(rng.uniform(1e2, 1e6, 15)),
                          list(10.0 ** rng.uniform(-4, -1, len(edges))))


def assert_matches_reference(g: JoinGraph, res) -> None:
    w = graph_to_wire(g)
    opt, _ = exact.solve(w)
    assert abs(float(res.cost) - opt) <= 1e-5 * opt, (res.cost, opt)
    assert invalid_reason(plan_shape(res.plan), w) is None


@pytest.mark.parametrize("algorithm", ["auto", "mpdp_general", "dpsub"])
@pytest.mark.parametrize("n", range(4, 11))
def test_clique_cost_equals_reference(n, algorithm):
    graphs = [gen.clique(n, seed=s) for s in SEEDS]
    for g, r in zip(graphs, batch.optimize_many(graphs, algorithm=algorithm,
                                                device="cpu")):
        assert_matches_reference(g, r)
    assert_matches_reference(
        graphs[0], engine.optimize(graphs[0], algorithm, device="cpu"))


def level_sets(g: JoinGraph) -> list[np.ndarray]:
    """The connected sets of each size 2..n, ascending."""
    levels = exact.connected_sets(exact.adjacency(graph_to_wire(g)))
    return [lv.astype(np.int32) for lv in levels[1:]]


def oracle_pairs(g: JoinGraph, sets: np.ndarray):
    pairs = sorted((int(s), b) for s in sets
                   for b in bl.np_find_blocks(int(s), g.edges, g.n))
    return (np.array([p[0] for p in pairs], np.int32),
            np.array([p[1] for p in pairs], np.int32))


@pytest.mark.parametrize("graph,cyc_cap,oracle", [
    ("clique9", 24, False), ("clique12", 24, False),
    ("clique6", 2, False), ("two_cliques", 24, True)])
def test_dense_pairs_equal_the_oracle(graph, cyc_cap, oracle):
    g = {"clique9": lambda: gen.clique(9, seed=1),
         "clique12": lambda: gen.clique(12, seed=2),
         "clique6": lambda: gen.clique(6, seed=3),
         "two_cliques": two_cliques}[graph]()
    assert g.m - g.n + 1 > cyc_cap                 # the dense path
    nmax = 16
    adj = np.zeros(nmax, np.int32)
    eu = np.full(g.m, -1, np.int32)
    ev = np.full(g.m, -1, np.int32)
    for i, (u, v) in enumerate(g.edges):
        adj[u] |= 1 << v
        adj[v] |= 1 << u
        eu[i], ev[i] = u, v
    tensors = [torch.from_numpy(a) for a in (adj, eu, ev)]
    telemetry.enable()
    total = 0
    for sets in level_sets(g):
        ps, pb = bl.np_pairs_for_sets(
            sets, g, *tensors, torch.ones(g.m, dtype=torch.bool),
            nmax=nmax, emax=g.m, cyc_cap=cyc_cap)
        want_s, want_b = oracle_pairs(g, sets)
        order = np.lexsort((pb, ps))
        assert np.array_equal(ps[order], want_s)
        assert np.array_equal(pb[order], want_b)
        total += len(sets)
    counts = collections.Counter()
    for (name, _), k in telemetry.counts().items():
        counts[name] += k
    assert counts["blocks.dense_sets"] == total
    assert (counts["blocks.oracle_sets"] > 0) == oracle
    dense = [s for s in telemetry.spans() if s.name == "blocks.dense"]
    assert len(dense) == g.n - 1


def totals() -> dict:
    out = collections.Counter()
    for (name, _), k in telemetry.counts().items():
        out[name] += k
    return dict(out)


def under(spans, child: str, parent: str) -> bool:
    """Every ``child`` span has a ``parent`` span as its parent."""
    ids = {s.id: s for s in spans}
    kids = [s for s in spans if s.name == child]
    return bool(kids) and all(
        s.parent in ids and ids[s.parent].name == parent for s in kids)


def clique_run(g, solo: bool):
    """One request's run of ``g`` under MPDP-general, chunks of 1,024
    lanes (several a level); returns the engine and the spans."""
    with telemetry.span("test.request"):       # one request, as a daemon's
        if solo:
            eng = engine.ExactEngine(g, chunk=1024, device="cpu")
            eng.run_mpdp_general()
        else:
            eng = batch.BatchEngine([g], chunk=1024,
                                    algorithm="mpdp_general", device="cpu")
            eng.run()
    return eng, telemetry.spans()


def fetches_in_chunks(spans):
    chunks = [s for s in spans if s.name == "engine.chunk"]
    return [f for f in spans if f.name == "engine.fetch" and any(
        c.t0 <= f.t0 and f.t1 <= c.t1 for c in chunks)]


@pytest.mark.parametrize("solo", [False, True], ids=["batched", "solo"])
def test_spans_nest_and_the_chunk_counter_is_the_engines(solo, monkeypatch):
    g = gen.clique(10, seed=4)
    telemetry.enable()
    eng, spans = clique_run(g, solo)
    assert under(spans, "blocks.dense", "engine.phase_a")
    assert under(spans, "engine.chunk", "engine.evaluate")
    ids = {s.id: s.name for s in spans}
    fetch_in = collections.Counter(ids.get(s.parent) for s in spans
                                   if s.name == "engine.fetch")
    assert fetch_in["blocks.dense"] > 0 and fetch_in["engine.chunk"] == 0
    # the fused chunks fold on the device: no read-back inside a chunk
    assert not fetches_in_chunks(spans)
    c = totals()
    assert c["engine.chunks"] == eng.chunks_dispatched > 0
    assert c["blocks.dense_sets"] == 2**10 - 1 - 10   # sets of sizes 2..n
    assert c.get("blocks.oracle_sets", 0) == 0
    # every counter under the request its spans share
    (rid,) = {s.request for s in spans}
    assert {r for _, r in telemetry.counts()} == {rid}
    # a chunk is a leaf: where chunks are read back (the host fold of
    # typed, DPSUB and lattice flights), the fetches inside it keep
    # engine.evaluate as their parent, so engine.fetch_share reads them
    telemetry.clear()
    monkeypatch.setattr(tchunks, "_folds", lambda algorithm, targs: False)
    _, spans = clique_run(g, solo)
    ids = {s.id: s.name for s in spans}
    inside = fetches_in_chunks(spans)
    assert inside and {ids[f.parent] for f in inside} == {"engine.evaluate"}


@pytest.mark.parametrize("n", [9, 11])
def test_clique_counters_do_not_depend_on_the_seed(n):
    got = []
    telemetry.enable()
    for seed in (1, 77, 2**33 + 9):
        telemetry.clear()
        eng = batch.BatchEngine([gen.clique(n, seed=seed)],
                                algorithm="mpdp_general", device="cpu")
        eng.run()
        names = collections.Counter(s.name for s in telemetry.spans())
        got.append((totals(), eng.chunks_dispatched, names["engine.chunk"],
                    names["blocks.dense"], names["engine.fetch"]))
    assert got[0] == got[1] == got[2]


def test_off_records_nothing():
    res = batch.optimize_many([gen.clique(9, seed=1)], device="cpu")
    eng = engine.ExactEngine(gen.clique(9, seed=2), device="cpu")
    eng.run_mpdp_general()
    assert res[0].cost > 0 and eng.chunks_dispatched > 0
    assert telemetry.spans() == [] and telemetry.counts() == {}
