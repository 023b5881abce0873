"""Phase A of MPDP-general in the port: ``kernels.ops.phase_a_blocks``.

* CPU tensors go to the plain version (``kernels.ref.phase_a_blocks_ref``,
  the torch ``blocks_chunk`` with its compaction) and launch nothing;
* the plain version's (set, block) pairs, through ``np_pairs_for_sets``,
  are the blocks the host oracle ``np_find_blocks`` finds, on random
  graphs at nmax 8/16/24/30 with cyclomatic numbers 1 to 24;
* the launch checks refuse a bad dtype, shape, mixed devices, ``eff_cap``
  above ``CYC_CAP_HARD`` and a bad ``width``;
* ``gpu``-marked: the CUDA kernel equals the plain version bit for bit, and
  ``np_pairs_for_sets`` on the card equals its CPU run.

This file imports no JAX and nothing from ``tests``, so it runs on the
card too.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import bitset as bs
from repro_torch.core import blocks as bl
from repro_torch.core.joingraph import JoinGraph
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_graph(n: int, mu: int, seed: int) -> JoinGraph:
    """A connected graph on n vertices with cyclomatic number mu: a random
    spanning tree and mu more edges."""
    rng = np.random.default_rng(seed)
    edges = {(int(rng.integers(0, v)), v) for v in range(1, n)}
    free = [(u, v) for u in range(n) for v in range(u + 1, n)
            if (u, v) not in edges]
    for i in rng.choice(len(free), mu, replace=False):
        edges.add(free[i])
    edges = sorted(edges)
    return JoinGraph.make(n, edges, [100.0] * n, [0.1] * len(edges))


def edge_arrays(g: JoinGraph, nmax: int):
    """The engines' tables of one query: adj int32[nmax], endpoints
    int32[emax] (-1 pad) and the live mask."""
    emax = max(8, ((g.m + 7) // 8) * 8)
    adj = np.zeros(nmax, np.int32)
    eu = np.full(emax, -1, np.int32)
    ev = np.full(emax, -1, np.int32)
    live = np.zeros(emax, bool)
    for i, (u, v) in enumerate(g.edges):
        adj[u] |= 1 << v
        adj[v] |= 1 << u
        eu[i], ev[i], live[i] = u, v, True
    return adj, eu, ev, live


def connected_sets(g: JoinGraph, count: int, seed: int) -> np.ndarray:
    """``count`` distinct connected vertex sets of g grown at random from
    random roots (sizes 2..n), ascending, and the whole vertex set."""
    rng = np.random.default_rng(seed)
    adj = g.adjacency()
    out = {(1 << g.n) - 1}
    for _ in range(count):
        s = 1 << int(rng.integers(0, g.n))
        for _ in range(int(rng.integers(1, g.n))):
            nb = bs.np_neighbors(s, adj) & ~s
            if not nb:
                break
            cand = [v for v in range(g.n) if (nb >> v) & 1]
            s |= 1 << int(rng.choice(cand))
        out.add(s)
    return np.array(sorted(out), np.int32)


def random_sets(n: int, count: int, seed: int) -> np.ndarray:
    """Any subsets of the n vertices, disconnected ones and 0 included."""
    return np.random.default_rng(seed).integers(0, 1 << n, count) \
        .astype(np.int32)


def args_of(g, nmax, sets, device="cpu"):
    return (torch.from_numpy(sets).to(device),
            *[torch.from_numpy(a).to(device) for a in edge_arrays(g, nmax)])


# cyclomatic numbers 1..24 at each nmax bucket (nmax 8 holds at most 21)
ORACLE_CASES = [(nmax, mu) for nmax in (8, 16, 24, 30)
                for mu in (1, 2, 3, 5, 8, 13, 21 if nmax == 8 else 24)]


@pytest.mark.parametrize("nmax,mu", ORACLE_CASES,
                         ids=[f"nmax{n}-mu{m}" for n, m in ORACLE_CASES])
def test_plain_version_pairs_match_find_blocks_oracle(nmax, mu):
    n = nmax if mu < 21 or nmax > 8 else 8
    g = random_graph(n, mu, seed=nmax * 100 + mu)
    assert g.m - g.n + 1 == mu and bs.nmax_bucket(g.n) == nmax
    sets = connected_sets(g, 48, seed=mu)
    S, adj, eu, ev, live = args_of(g, nmax, sets)
    emax = eu.shape[0]
    eff_cap = max(1, min(24, mu))
    width = eff_cap + nmax
    rows = ops.phase_a_blocks(S, adj, eu, ev, live, nmax, eff_cap,
                              width).numpy()
    ps, pb = bl.np_pairs_for_sets(sets, g, adj, eu, ev, live, nmax=nmax,
                                  emax=emax, cyc_cap=24)
    nz = rows != 0
    np.testing.assert_array_equal(ps, np.repeat(sets, nz.sum(axis=1)))
    np.testing.assert_array_equal(pb, rows[nz])
    for s, row in zip(sets.tolist(), rows):
        got = sorted(int(b) for b in row if b)
        assert got == sorted(bl.np_find_blocks(s, g.edges, g.n)), hex(s)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    g = random_graph(14, 3, seed=5)
    sets = random_sets(14, 300, seed=6)
    args = args_of(g, 16, sets)
    before = dict(ops.LAUNCHES)
    got = ops.phase_a_blocks(*args, 16, 3, 12)
    want = ref.phase_a_blocks_ref(*args, 16, 3, 12)
    assert got.dtype == torch.int32 and tuple(got.shape) == (300, 12)
    assert torch.equal(got, want)
    assert ops.LAUNCHES == before            # no kernel ran, none counted


def test_phase_a_launch_checks_refuse_bad_inputs():
    g = random_graph(10, 2, seed=1)
    S, adj, eu, ev, live = args_of(g, 16, random_sets(10, 8, seed=2))

    def refuse(match, **repl):
        a = dict(S=S, adj=adj, eu_idx=eu, ev_idx=ev, edge_live=live, nmax=16,
                 eff_cap=2, width=8)
        a.update(repl)
        with pytest.raises(ValueError, match=match):
            ops._launch_phase_a(*a.values())

    refuse("S must be", S=S.long())
    refuse("S must be", S=S[None])
    refuse("S must be", S=S[::2])
    refuse("adj must be", adj=adj.long())
    refuse("adj must be", adj=adj[:8])
    refuse("eu_idx", eu_idx=eu.long())
    refuse("eu_idx", eu_idx=eu[None])
    refuse("ev_idx", ev_idx=ev[:-1])
    refuse("edge_live", edge_live=live.to(torch.int32))
    refuse("edge_live", edge_live=live[:-1])
    refuse("unsupported edge arrays",
           eu_idx=torch.zeros(8192, dtype=torch.int32),
           ev_idx=torch.zeros(8192, dtype=torch.int32),
           edge_live=torch.zeros(8192, dtype=torch.bool))
    refuse("eff_cap = 25", eff_cap=ops.CYC_CAP_HARD + 1)
    refuse("eff_cap = 0", eff_cap=0)
    refuse("width = 0", width=0)
    refuse("width = 19", width=19)
    with pytest.raises(ValueError, match="devices"):
        ops.phase_a_blocks(S.to("meta"), adj, eu, ev, live, 16, 2, 8)


# ----------------------------------------------------------------- card --

CARD_CASES = [(nmax, n, mu) for nmax, n in ((8, 8), (16, 12), (16, 16),
                                            (24, 20), (30, 30))
              for mu in (1, 2, 3, 7, 21 if nmax == 8 else 24)]


@pytest.mark.gpu
def test_cuda_phase_a_blocks_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for i, (nmax, n, mu) in enumerate(CARD_CASES):
        g = random_graph(n, mu, seed=i)
        eff = max(1, min(ops.CYC_CAP_HARD, mu))
        for N in (1, 129, 4097, 20000):
            sets = (connected_sets(g, N, seed=N) if N % 2
                    else random_sets(n, N, seed=N))
            args = args_of(g, nmax, sets, "cuda")
            # np_pairs_for_sets' width, narrower rows, the widest, other caps
            for eff_cap, width in ((eff, eff + n - 1), (eff, 1),
                                   (eff, eff + nmax), (1, nmax),
                                   (ops.CYC_CAP_HARD, ops.CYC_CAP_HARD + nmax)):
                n0 = ops.LAUNCHES["phase_a_blocks"]
                got = ops.phase_a_blocks(*args, nmax, eff_cap, width)
                assert ops.LAUNCHES["phase_a_blocks"] == n0 + 1
                want = ref.phase_a_blocks_ref(*args, nmax, eff_cap, width)
                torch.cuda.synchronize()
                assert got.dtype == torch.int32
                assert torch.equal(got, want), (nmax, n, mu, N, eff_cap,
                                                width)
        level = connected_sets(g, 600, seed=n)
        emax = edge_arrays(g, nmax)[1].shape[0]
        on_card, on_cpu = (
            bl.np_pairs_for_sets(level, g, *args_of(g, nmax, level, dev)[1:],
                                 nmax=nmax, emax=emax, cyc_cap=24)
            for dev in ("cuda", "cpu"))
        for a, b in zip(on_card, on_cpu):
            np.testing.assert_array_equal(a, b)
