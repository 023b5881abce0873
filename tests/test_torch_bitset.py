"""Port lane primitives vs the JAX reference on random seeded lanes.

Integer outputs (popcount, lsb, pdep, neighbours, grow, connectivity,
unranking) must be equal bit for bit; the lane cost ``join_cost`` agrees to
a relative 1e-5 (``exp2`` and FMA contraction differ between XLA and
torch); the host numpy twins (``np_rows_for_sets``, ``np_join_cost``) are
copies and must be bit-identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitset as rbs, cost as rcm, unrank as rur
from repro.workloads import generators as rgen
from repro_torch.core import bitset as tbs, cost as tcm, unrank as tur
from repro_torch.core.joingraph import graph_from_wire
from repro.daemon.protocol import graph_to_wire

L = 1000


def _adj_rows(nmax, seed):
    """Per-lane adjacency rows from real generator graphs, plus lanes."""
    gs = [rgen.musicbrainz_query(min(nmax, 12), seed), rgen.star(min(nmax, 9), seed),
          rgen.clique(min(nmax, 7), seed), rgen.chain(nmax, seed)]
    adj = np.zeros((len(gs), nmax), np.int32)
    for q, g in enumerate(gs):
        for (u, v) in g.edges:
            adj[q, u] |= 1 << v
            adj[q, v] |= 1 << u
    rng = np.random.default_rng(seed)
    qid = rng.integers(0, len(gs), L)
    return adj[qid], rng


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_popcount_lsb_match(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 31), 1 << 31, L, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    _eq(tbs.popcount(torch.from_numpy(x)), rbs.popcount(jnp.asarray(x)))
    _eq(tbs.lsb(torch.from_numpy(x)), rbs.lsb(jnp.asarray(x)))


@pytest.mark.parametrize("nmax", [8, 16])
@pytest.mark.parametrize("seed", [3, 4])
def test_pdep_matches(nmax, seed):
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 1 << nmax, L).astype(np.int32)
    rank = rng.integers(0, 1 << 20, L).astype(np.int32)
    _eq(tbs.pdep(torch.from_numpy(rank), torch.from_numpy(mask), nmax),
        rbs.pdep(jnp.asarray(rank), jnp.asarray(mask), nmax))


@pytest.mark.parametrize("nmax", [8, 16])
@pytest.mark.parametrize("seed", [5, 6])
def test_rows_primitives_match(nmax, seed):
    adjq, rng = _adj_rows(nmax, seed)
    S = rng.integers(0, 1 << nmax, L).astype(np.int32)
    src = (S & rng.integers(0, 1 << nmax, L)).astype(np.int32)
    tS, ta, tsrc = map(torch.from_numpy, (S, adjq, src))
    jS, ja, jsrc = map(jnp.asarray, (S, adjq, src))
    _eq(tbs.neighbors_rows(tS, ta), rbs.neighbors_rows(jS, ja))
    _eq(tbs.grow_rows(tsrc, tS, ta), rbs.grow_rows(jsrc, jS, ja))
    _eq(tbs.is_connected_rows(tS, ta), rbs.is_connected_rows(jS, ja))
    # shared (nmax,) table, as the solo filter and phase A use it
    _eq(tbs.grow(tsrc, tS, ta[0]), rbs.grow(jsrc, jS, ja[0]))
    _eq(tbs.is_connected(tS, ta[0]), rbs.is_connected(jS, ja[0]))
    # edge-deleted grow with one-bit endpoint masks (0 = padding edge)
    u = rng.integers(0, nmax, L)
    v = (u + 1 + rng.integers(0, nmax - 1, L)) % nmax
    ub = np.where(rng.random(L) < 0.9, 1 << u, 0).astype(np.int32)
    vb = np.where(ub != 0, 1 << v, 0).astype(np.int32)
    _eq(tbs.grow_excl_edge_rows(torch.from_numpy(ub), tS, ta,
                                torch.from_numpy(ub), torch.from_numpy(vb)),
        rbs.grow_excl_edge_rows(jnp.asarray(ub), jS, ja, jnp.asarray(ub),
                                jnp.asarray(vb)))


@pytest.mark.parametrize("nmax", [8, 16])
def test_unrank_matches(nmax):
    binom = tur.binom_table(nmax)
    np.testing.assert_array_equal(binom, rur.binom_table(nmax))
    rng = np.random.default_rng(nmax)
    for k in (1, 2, nmax // 2, nmax - 1, nmax):
        total = int(binom[nmax, k])
        rank = rng.integers(0, total, L).astype(np.int32)
        _eq(tur.unrank_ksubset(torch.from_numpy(rank), k,
                               torch.from_numpy(binom), nmax),
            rur.unrank_ksubset(jnp.asarray(rank), k, jnp.asarray(binom), nmax))


@pytest.mark.parametrize("seed", [7, 8])
def test_join_cost_matches_to_1e5(seed):
    rng = np.random.default_rng(seed)
    rl = rng.uniform(0, 60, L).astype(np.float32)
    rr = rng.uniform(0, 60, L).astype(np.float32)
    ro = rng.uniform(0, 110, L).astype(np.float32)
    got = tcm.join_cost(*map(torch.from_numpy, (rl, rr, ro))).numpy()
    want = np.asarray(rcm.join_cost(*map(jnp.asarray, (rl, rr, ro))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tcm.scan_cost(torch.from_numpy(rl)).numpy(),
                               np.asarray(rcm.scan_cost(jnp.asarray(rl))),
                               rtol=1e-5, atol=0)
    # host twins are copies: bit-identical
    np.testing.assert_array_equal(tcm.np_join_cost(rl, rr, ro),
                                  rcm.np_join_cost(rl, rr, ro))


@pytest.mark.parametrize("make", [lambda: rgen.musicbrainz_query(14, 3),
                                  lambda: rgen.clique(9, 4),
                                  lambda: rgen.snowflake(16, 5)],
                         ids=["mb14", "clique9", "snow16"])
def test_rows_for_sets_bit_identical(make):
    g = make()
    tg = graph_from_wire(graph_to_wire(g))
    sets = np.random.default_rng(g.n).integers(1, 1 << g.n, 5000).astype(np.int32)
    np.testing.assert_array_equal(tcm.np_rows_for_sets(sets, tg),
                                  rcm.np_rows_for_sets(sets, g))
    for s in sets[:50]:
        assert tcm.np_rows_log2(int(s), tg) == rcm.np_rows_log2(int(s), g)
