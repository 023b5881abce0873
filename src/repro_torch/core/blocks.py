"""Biconnected components ("blocks", paper §2.4/§3.2) of induced subgraphs.

Phase A of MPDP-general, as in ``repro.core.blocks``:

* ``np_find_blocks`` — host Hopcroft-Tarjan (DFS lowpoint) oracle, and
  ``np_cut_vertices``, the cut-vertex oracle by component counting;
* ``np_pairs_for_sets`` — the host side turning a level's sets into
  sorted (set, block) pair arrays, equal to the reference's.  Its sparse
  path runs ``kernels.ops.phase_a_blocks`` over the whole level (the
  kernel on a card; on the CPU its plain version, the torch
  ``kernels.ref.blocks_chunk`` of the reference's jitted chunk function):
      1. BFS spanning tree (parent/depth) of G[S];
      2. fundamental cycle per non-tree edge (LCA walk, vertex bitmaps);
      3. merge cycles sharing >= 2 vertices (transitive closure);
      4. tree edges no fundamental cycle covers are bridges => 2-vertex
         blocks;
  its dense path (the query's cyclomatic number past ``cyc_cap``, as on
  cliques) ``has_cut_vertex_batch`` and the oracle, under the span
  ``blocks.dense`` and the counters ``blocks.dense_sets`` and
  ``blocks.oracle_sets`` (``core.telemetry``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitset as bs
from . import telemetry as _telemetry
from ..kernels import ops


# ------------------------------------------------------------------ oracle --

def np_find_blocks(s: int, edges, n: int) -> list[int]:
    """Blocks of G[s] as vertex bitmaps (Hopcroft-Tarjan, iterative DFS)."""
    verts = [v for v in range(n) if (s >> v) & 1]
    adj = {v: [] for v in verts}
    for (u, v) in edges:
        if ((s >> u) & 1) and ((s >> v) & 1):
            adj[u].append(v)
            adj[v].append(u)
    disc, low = {}, {}
    blocks, stack, time = [], [], [0]

    for root in verts:
        if root in disc:
            continue
        it = {v: 0 for v in verts}
        dfs = [(root, None)]
        disc[root] = low[root] = time[0]
        time[0] += 1
        while dfs:
            v, parent = dfs[-1]
            advanced = False
            while it[v] < len(adj[v]):
                w = adj[v][it[v]]
                it[v] += 1
                if w not in disc:
                    stack.append((v, w))
                    disc[w] = low[w] = time[0]
                    time[0] += 1
                    dfs.append((w, v))
                    advanced = True
                    break
                elif w != parent and disc[w] < disc[v]:
                    stack.append((v, w))
                    low[v] = min(low[v], disc[w])
            if advanced:
                continue
            dfs.pop()
            if dfs:
                p = dfs[-1][0]
                low[p] = min(low[p], low[v])
                if low[v] >= disc[p]:
                    blk = 0
                    while stack:
                        (a, b) = stack.pop()
                        blk |= (1 << a) | (1 << b)
                        if (a, b) == (p, v):
                            break
                    if blk:
                        blocks.append(blk)
    return blocks


def np_cut_vertices(s: int, adj_np: np.ndarray) -> int:
    """Bitmap of cut vertices of G[s] (oracle, via component counting)."""
    out = 0
    for v in bs.iter_bits(s):
        rest = s & ~(1 << v)
        if rest == 0:
            continue
        if bs.np_grow(rest & (-rest), rest, adj_np) != rest:
            out |= 1 << v
    return out


# ---------------------------------------------------------- dense path --

def has_cut_vertex_batch(S, adj, nmax: int):
    """True per set iff G[S] has a cut vertex (the dense-graph early-out)."""
    vbits = (1 << torch.arange(nmax, dtype=torch.int32, device=S.device))[None, :]
    rest = S[:, None] & ~vbits                               # (B, nmax)
    in_s = (S[:, None] & vbits) != 0
    reach = bs.grow(bs.lsb(rest), rest, adj)
    cut = in_s & (reach != rest) & (rest != 0)
    return cut.any(dim=1)


# --------------------------------------------- phase A (MPDP-general) host --

def np_pairs_for_sets(sets_np, g, adj, eu_idx, ev_idx, edge_live,
                      *, nmax: int, emax: int, cyc_cap: int):
    """Phase A host driver: compacted (set, block) pair arrays for a level.

    ``adj``/``eu_idx``/``ev_idx``/``edge_live`` are the query's tensors on
    the engine's device (one query at a time; the lane fusion happens in
    phase B).  Pairs come back sorted by set, as numpy int32 arrays.
    ``emax`` is the edge-array width (the tensors carry it).
    """
    mu = g.m - g.n + 1
    dev = adj.device
    pair_set, pair_block = [], []
    if mu <= cyc_cap:
        # the cyclomatic number of any induced subgraph is <= mu(G): size
        # the fundamental-cycle slots to the query, not the ceiling
        eff_cap = max(1, min(cyc_cap, mu))
        sets_np = np.ascontiguousarray(sets_np, np.int32)
        # a set's blocks: at most eff_cap merged cycles and a bridge for
        # each of its vertices but the BFS root
        width = eff_cap + int(bs.np_popcount(sets_np).max(initial=1)) - 1
        rows = ops.phase_a_blocks(torch.from_numpy(sets_np).to(dev), adj,
                                  eu_idx, ev_idx, edge_live, nmax, eff_cap,
                                  width)
        with _telemetry.span("engine.fetch"):
            rows = rows.cpu().numpy()
        nz = rows != 0
        pair_set.append(np.repeat(sets_np, np.count_nonzero(nz, axis=1)))
        pair_block.append(rows[nz])
    else:
        # dense path: no-cut-vertex sets are single blocks (cliques); rare
        # cut-vertex sets go to the host oracle
        with _telemetry.span("blocks.dense"):
            scap = 4096
            flags = np.zeros(len(sets_np), bool)
            for s0 in range(0, len(sets_np), scap):
                Sd = torch.from_numpy(np.ascontiguousarray(
                    sets_np[s0: s0 + scap], np.int32)).to(dev)
                cut = has_cut_vertex_batch(Sd, adj, nmax)
                with _telemetry.span("engine.fetch"):
                    flags[s0: s0 + len(Sd)] = cut.cpu().numpy()
            easy = sets_np[~flags]
            pair_set.append(easy)
            pair_block.append(easy)
            for s in sets_np[flags]:
                for b in np_find_blocks(int(s), g.edges, g.n):
                    pair_set.append(np.array([s], np.int32))
                    pair_block.append(np.array([b], np.int32))
            _telemetry.count("blocks.dense_sets", len(sets_np))
            _telemetry.count("blocks.oracle_sets", int(flags.sum()))
    ps = np.concatenate(pair_set).astype(np.int32) if pair_set else np.zeros(0, np.int32)
    pb = np.concatenate(pair_block).astype(np.int32) if pair_block else np.zeros(0, np.int32)
    order = np.argsort(ps, kind="stable")
    return ps[order], pb[order]
