"""Biconnected components ("blocks", paper §2.4/§3.2) of induced subgraphs.

Phase A of MPDP-general, as in ``repro.core.blocks``:

* ``np_find_blocks`` — host Hopcroft-Tarjan (DFS lowpoint) oracle, and
  ``np_cut_vertices``, the cut-vertex oracle by component counting;
* ``blocks_chunk`` — branch-free torch version over a batch of sets, run
  on the engine's device:
      1. BFS spanning tree (parent/depth) of G[S];
      2. fundamental cycle per non-tree edge (LCA walk, vertex bitmaps);
      3. merge cycles sharing >= 2 vertices (transitive closure);
      4. tree edges no fundamental cycle covers are bridges => 2-vertex
         blocks;
* ``np_pairs_for_sets`` — the host driver compacting a level's sets into
  sorted (set, block) pair arrays, equal to the reference's.

The reference ``vmap``s one set's functions over the batch; here the batch
is the leading dimension of every tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitset as bs
from . import telemetry as _telemetry


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


# ----------------------------------------------------------- torch batched --

def _bit(v: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(v) << v


def _bfs_tree(S, adj, nmax: int):
    """BFS tree of each G[S] from lsb(S): parent idx and depth, (B, nmax)."""
    sh = torch.arange(nmax, dtype=torch.int32, device=S.device)
    vbits = _bit(sh)
    root = bs.lsb(S)
    visited, frontier = root, root
    parent = torch.full((S.shape[0], nmax), -1, dtype=torch.int32,
                        device=S.device)
    depth = torch.where(((root[:, None] >> sh) & 1) == 1, 0, 1 << 20) \
        .to(torch.int32)
    for d in range(nmax):
        new = bs.neighbors(frontier, adj) & S & ~visited
        isnew = (new[:, None] & vbits) != 0
        # each newly visited v picks its lowest-index neighbour inside the
        # frontier as parent: popcount(lsb(bm) - 1), 0 for an empty bm
        pbm = adj[None, :] & frontier[:, None]
        pidx = bs.popcount(bs.lsb(pbm) - 1) * (pbm != 0)
        parent = torch.where(isnew, pidx, parent)
        depth = torch.where(isnew, d + 1, depth)
        visited = visited | new
        frontier = new
    return parent, depth


def _fundamental_cycles(parent, depth, eu_idx, ev_idx, active, nmax: int):
    """Vertex bitmap of the fundamental cycle of each (non-tree) edge slot;
    every tensor is (B, slots) except parent/depth (B, nmax)."""
    a = eu_idx.clamp(min=0)
    b = ev_idx.clamp(min=0)
    cyc = torch.zeros_like(a)
    for _ in range(2 * nmax):
        da = depth.gather(1, a.long())
        db = depth.gather(1, b.long())
        ne = a != b
        step_a = ne & (da >= db)
        step_b = ne & (db > da)
        both = ne & (da == db)
        cyc = cyc | _bit(a) | _bit(b)
        na = torch.where(step_a | both, parent.gather(1, a.long()), a)
        nb = torch.where(step_b | both, parent.gather(1, b.long()), b)
        a = na.clamp(min=0)
        b = nb.clamp(min=0)
    cyc = cyc | _bit(a)                                      # the LCA
    return torch.where(active, cyc, 0)


def _merge_cycles(cycles):
    """Transitive closure of 'share >= 2 vertices' by iterated bitmap OR,
    then duplicates of an earlier slot zeroed.  cycles: (B, slots)."""
    cur = cycles
    while True:
        nz = cur != 0
        inter = bs.popcount(cur[:, :, None] & cur[:, None, :])
        share = (inter >= 2) & nz[:, :, None] & nz[:, None, :]
        nxt = bs._or_last(torch.where(share, cur[:, None, :], 0)) | cur
        if torch.equal(nxt, cur):
            break
        cur = nxt
    idx = torch.arange(cur.shape[1], device=cur.device)
    dup = ((cur[:, :, None] == cur[:, None, :])
           & (idx[None, :] < idx[:, None]) & (cur[:, :, None] != 0))
    return torch.where(dup.any(dim=2), 0, cur)


def blocks_chunk(S, adj, eu_idx, ev_idx, edge_live, *, nmax: int,
                 cyc_cap: int):
    """Phase A of MPDP-general: blocks of every set of ``S`` (int32[B]).

    Returns ``(merged int32[B, cyc_cap], bridge int32[B, nmax])``; zero
    entries are padding.  ``adj`` is the query's int32[nmax] table and the
    edge arrays its int32[emax] endpoint indices (-1 pad) and live mask.
    """
    B = S.shape[0]
    parent, depth = _bfs_tree(S, adj, nmax)
    eu_c, ev_c = eu_idx.clamp(min=0), ev_idx.clamp(min=0)
    ubit = torch.where(eu_idx >= 0, _bit(eu_c), 0)
    vbit = torch.where(ev_idx >= 0, _bit(ev_c), 0)
    Sc = S[:, None]
    in_s = edge_live[None, :] & ((ubit & Sc) != 0) & ((vbit & Sc) != 0)
    pu = parent[:, eu_c.long()]
    pv = parent[:, ev_c.long()]
    non_tree = in_s & ~((pu == ev_idx) | (pv == eu_idx))
    # compact non-tree edge endpoints into cyc_cap slots; slot cyc_cap is
    # the drop column (JAX's mode="drop") and is cut off below
    pos = torch.cumsum(non_tree.to(torch.int32), dim=1) - 1
    slot = torch.where(non_tree, pos, cyc_cap).clamp(max=cyc_cap).long()

    def compact(vals, fill):
        buf = torch.full((B, cyc_cap + 1), fill, dtype=torch.int32,
                         device=S.device)
        return buf.scatter_(1, slot, vals.to(torch.int32).expand(B, -1)
                            .contiguous())[:, :cyc_cap]

    cu = compact(eu_idx, -1)
    cv = compact(ev_idx, -1)
    act = compact(non_tree, 0) != 0
    cycles = _fundamental_cycles(parent, depth, cu, cv, act, nmax)
    merged = _merge_cycles(cycles)
    sh = torch.arange(nmax, dtype=torch.int32, device=S.device)
    vbits = _bit(sh)
    has_parent = (parent >= 0) & ((Sc & vbits) != 0)
    pbits = torch.where(has_parent, _bit(parent.clamp(min=0)), 0)
    pair = vbits | pbits                                     # (B, nmax)
    cov = (((cycles[:, None, :] & pair[:, :, None]) == pair[:, :, None])
           & (cycles[:, None, :] != 0))
    bridge = torch.where(has_parent & ~cov.any(dim=2), pair, 0)
    return merged, bridge


def has_cut_vertex_batch(S, adj, nmax: int):
    """True per set iff G[S] has a cut vertex (the dense-graph early-out)."""
    vbits = _bit(torch.arange(nmax, dtype=torch.int32, device=S.device))[None, :]
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
    scap = 4096
    pair_set, pair_block = [], []
    if mu <= cyc_cap:
        # the cyclomatic number of any induced subgraph is <= mu(G): size
        # the fundamental-cycle slots to the query, not the ceiling
        eff_cap = max(1, min(cyc_cap, mu))
        for s0 in range(0, len(sets_np), scap):
            Sd = torch.from_numpy(np.ascontiguousarray(
                sets_np[s0: s0 + scap], np.int32)).to(dev)
            merged, bridge = blocks_chunk(Sd, adj, eu_idx, ev_idx, edge_live,
                                          nmax=nmax, cyc_cap=eff_cap)
            both = torch.cat([merged, bridge], dim=1)
            nz = both != 0
            with _telemetry.span("engine.fetch"):
                got = torch.stack([Sd[:, None].expand_as(both)[nz],
                                   both[nz]]).cpu().numpy()
            pair_set.append(got[0])
            pair_block.append(got[1])
    else:
        # dense path: no-cut-vertex sets are single blocks (cliques); rare
        # cut-vertex sets go to the host oracle
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
    ps = np.concatenate(pair_set).astype(np.int32) if pair_set else np.zeros(0, np.int32)
    pb = np.concatenate(pair_block).astype(np.int32) if pair_block else np.zeros(0, np.int32)
    order = np.argsort(ps, kind="stable")
    return ps[order], pb[order]
