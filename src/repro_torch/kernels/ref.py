"""Plain PyTorch versions of the kernels (bit-exact oracles).

Each function computes what its CUDA kernel in ``csrc/ccp_eval.cu``
computes, on the port's lane-vectorised ``bitset`` helpers, and equals the
reference bit for bit: the seven lane kernels its ``repro.kernels.ref``,
the six forms that build their own lanes (``connectivity_span``,
``ccp_eval_dpsub``, ``bconnectivity_span``, ``bccp_eval_decode``,
``btree_eval_decode``, ``bgeneral_eval_decode``) the unrank or lane decode
of its chunk bodies
followed by the lane kernel, and ``phase_a_blocks`` the reference's
``blocks.blocks_chunk`` (phase A of MPDP-general) with its compaction.
``ops`` routes CPU tensors here; ``chip_smoke.py`` holds each kernel
against these on the card.

Lanes are ``int32[L]``.  The solo-engine kernels take one query's
``int32[nmax]`` adjacency table; the batched ones take the stacked
``int32[bcap, nmax]`` table ``adj_b`` and each lane's query row ``qid``.
The reference clamps an out-of-range gather index, so ``qid`` is clamped
to ``[0, bcap)``, and the DPSUB set index to ``[0, len(all_sets))``, here
and in the kernels alike.
"""
from __future__ import annotations

import torch

from ..core import bitset as bs
from ..core import unrank as ur


def _rows(qid: torch.Tensor, adj_b: torch.Tensor) -> torch.Tensor:
    return adj_b[qid.clamp(0, adj_b.shape[0] - 1)]


def _lane_query(off: torch.Tensor, t: torch.Tensor, bcap: int) -> torch.Tensor:
    """Owner of lane t: ``searchsorted(off, t, side="right") - 1``, clamped
    to ``[0, bcap)``."""
    return (torch.searchsorted(off, t, right=True, out_int32=True) - 1
            ).clamp(0, bcap - 1)


def _ccp(lb, rb, adjq):
    conn_l = bs.is_connected_rows(lb, adjq)
    conn_r = bs.is_connected_rows(rb, adjq)
    cross = (bs.neighbors_rows(lb, adjq) & rb) != 0
    return ((lb != 0) & (rb != 0) & conn_l & conn_r & cross).to(torch.int32)


# -- solo engine: one query's (nmax,) table shared by every lane --------------

def connectivity_ref(S, adj, nmax: int):
    """1 where G[S] is connected."""
    return bs.is_connected(S, adj).to(torch.int32)


def connectivity_span_ref(k: int, rank0: int, count: int, binom, adj,
                          nmax: int):
    """Colex ranks ``rank0 + t`` (t < count) of the k-subsets -> (S, 1 where
    G[S] is connected)."""
    ranks = rank0 + torch.arange(count, dtype=torch.int32, device=adj.device)
    S = ur.unrank_ksubset(ranks, k, binom, nmax)
    return S, connectivity_ref(S, adj, nmax)


def ccp_eval_ref(S, sub, adj, nmax: int):
    """DPSUB lane: ``lb = pdep(sub, S)``, ``rb = S & ~lb``, ccp."""
    lb = bs.pdep(sub, S, nmax)
    rb = S & ~lb
    return lb, rb, _ccp(lb, rb, adj)


def ccp_eval_dpsub_ref(all_sets, level_off: int, base_set: int,
                       base_sub: int, i: int, adj, nmax: int, chunk: int):
    """DPSUB chunk lane t: set ``base_set + ((base_sub + t) >> i)`` of the
    level at ``level_off`` (clamped gather from ``all_sets``) and subset
    rank ``(base_sub + t) & (2^i - 1)``, then ``ccp_eval_ref``."""
    t = torch.arange(chunk, dtype=torch.int32, device=adj.device)
    sub_g = base_sub + t
    set_idx = base_set + (sub_g >> i)
    sub = sub_g & ((1 << i) - 1)
    S = all_sets[(level_off + set_idx).clamp(0, all_sets.shape[0] - 1)]
    return ccp_eval_ref(S, sub, adj, nmax)


def grow_pair_ref(S, lb, rb, adj, nmax: int):
    """MPDP-general split: ``S_left = grow(lb)`` inside ``S & ~rb`` and
    ``S_right = S & ~S_left``."""
    sl = bs.grow(lb, S & ~rb, adj)
    return sl, S & ~sl


# -- batched engine: per-lane rows of the stacked (bcap, nmax) table ----------

def bconnectivity_ref(S, qid, adj_b, nmax: int):
    """1 where G_q[S] is connected, per (query, set) lane."""
    return bs.is_connected_rows(S, _rows(qid, adj_b)).to(torch.int32)


def bconnectivity_span_ref(k: int, foff, count: int, binom, adj_b,
                           nmax: int):
    """The batched filter of a level span: lane t (t < count) belongs to
    query ``q = searchsorted(foff, t) - 1`` (foff the int32[bcap+1] rank
    prefix), unranks colex rank ``max(t - foff[q], 0)`` of the k-subsets
    and is live below ``foff[bcap]`` -> (S, conn, qid), conn 1 where the
    lane is live and G_q[S] is connected."""
    bcap = adj_b.shape[0]
    t = torch.arange(count, dtype=torch.int32, device=adj_b.device)
    qid = _lane_query(foff, t, bcap)
    S = ur.unrank_ksubset((t - foff[qid]).clamp(min=0), k, binom, nmax)
    conn = (bconnectivity_ref(S, qid, adj_b, nmax) != 0) & (t < foff[bcap])
    return S, conn.to(torch.int32), qid


def bccp_eval_ref(S, sub, qid, adj_b, nmax: int):
    """Batched DPSUB lane: ``lb = pdep(sub, S)``, ``rb = S & ~lb``, ccp."""
    adjq = _rows(qid, adj_b)
    lb = bs.pdep(sub, S, nmax)
    rb = S & ~lb
    return lb, rb, _ccp(lb, rb, adjq)


def bccp_eval_decode_ref(all_sets, eoff, loff, soff, seg0: int, i: int,
                         adj_b, nmax: int, nseg: int, chunk: int):
    """Batched DPSUB chunk lane t (t < chunk): query ``q =
    searchsorted(eoff, t) - 1``, ``local = t - eoff[q]``, set ``local >> i``
    of the query's level at ``loff[q]`` (clamped gather from ``all_sets``)
    and subset rank ``local & (2^i - 1)``, then ``bccp_eval_ref`` -> (lb,
    rb, ccp, qid, seg): ccp masked by ``t < eoff[bcap]``, seg ``soff[q] +
    set - seg0`` clamped to ``[0, nseg)``.  Dead lanes are decoded all the
    same."""
    bcap = adj_b.shape[0]
    t = torch.arange(chunk, dtype=torch.int32, device=adj_b.device)
    qid = _lane_query(eoff, t, bcap)
    local = t - eoff[qid]
    set_idx = local >> i
    S = all_sets[(loff[qid] + set_idx).clamp(0, all_sets.shape[0] - 1)]
    lb, rb, ccp_i = bccp_eval_ref(S, local & ((1 << i) - 1), qid, adj_b, nmax)
    ccp = ((t < eoff[bcap]) & (ccp_i != 0)).to(torch.int32)
    seg = (soff[qid] + set_idx - seg0).clamp(0, nseg - 1)
    return lb, rb, ccp, qid, seg


def btree_eval_ref(S, ub, vb, qid, adj_b, nmax: int):
    """Batched MPDP:Tree lane: ``S_left`` = grow of ``ub`` inside S with the
    edge (u, v) deleted, and whether both endpoints lie in S."""
    adjq = _rows(qid, adj_b)
    edge_in = ((S & ub) != 0) & ((S & vb) != 0)
    sl = bs.grow_excl_edge_rows(ub, S, adjq, ub, vb)
    return sl, edge_in.to(torch.int32)


def btree_eval_decode_ref(all_sets, eoff, loff, soff, seg0: int, m_b,
                          emu_b, emv_b, adj_b, nmax: int, nseg: int,
                          chunk: int):
    """MPDP:Tree chunk lane t (t < chunk): query ``q = searchsorted(eoff,
    t) - 1``, ``local = t - eoff[q]``, set ``local // max(m_b[q], 1)`` of the
    query's level at ``loff[q]`` (clamped gather from ``all_sets``) and edge
    ``local % max(m_b[q], 1)`` of ``emu_b``/``emv_b``, then
    ``btree_eval_ref`` -> (S, S_left, edge_in, qid, seg): edge_in masked by
    ``t < eoff[bcap]``, seg ``soff[q] + set - seg0`` clamped to
    ``[0, nseg)``.  Dead lanes are decoded all the same."""
    bcap = adj_b.shape[0]
    t = torch.arange(chunk, dtype=torch.int32, device=adj_b.device)
    qid = _lane_query(eoff, t, bcap)
    local = t - eoff[qid]
    mq = m_b[qid].clamp(min=1)
    set_idx = torch.div(local, mq, rounding_mode="floor")
    e = torch.remainder(local, mq).clamp(0, emu_b.shape[1] - 1)
    S = all_sets[(loff[qid] + set_idx).clamp(0, all_sets.shape[0] - 1)]
    S_left, in_i = btree_eval_ref(S, emu_b[qid, e], emv_b[qid, e], qid,
                                  adj_b, nmax)
    edge_in = ((t < eoff[bcap]) & (in_i != 0)).to(torch.int32)
    seg = (soff[qid] + set_idx - seg0).clamp(0, nseg - 1)
    return S, S_left, edge_in, qid, seg


def bgeneral_eval_ref(S, block, r, qid, adj_b, nmax: int):
    """Batched MPDP-general lane: ``lb = pdep(r, block)``, the ccp of
    (lb, block & ~lb), and ``S_left = grow(lb)`` inside ``S & ~rb``."""
    adjq = _rows(qid, adj_b)
    lb = bs.pdep(r, block, nmax)
    rb = block & ~lb
    sl = bs.grow_rows(lb, S & ~rb, adjq)
    return lb, sl, _ccp(lb, rb, adjq)


def bgeneral_eval_decode_ref(pairs, n_pairs: int, lane_count: int, adj_b,
                             nmax: int, chunk: int):
    """MPDP-general chunk lane t (t < chunk) over the int32[4, pcap] pair
    table ``pairs`` (rows set, block, query, chunk-local lane offset): pair
    ``p = searchsorted(off, t) - 1`` clamped to ``[0, n_pairs)``, rank ``r
    = t - off[p]`` of its block, query clamped to ``[0, bcap)``; then
    ``lb = pdep(r, block)``, ``rb = block & ~lb`` -> (S, S_left, enum_ok,
    ccp, qid, p): enum_ok where ``t < lane_count`` and both sides are
    non-empty, ccp where enum_ok and (lb, rb) is a csg-cmp pair, ``S_left
    = grow(lb)`` inside ``S & ~rb``.  Dead lanes are decoded all the
    same."""
    set_row, block_row, qid_row, off = pairs
    t = torch.arange(chunk, dtype=torch.int32, device=adj_b.device)
    p = _lane_query(off, t, n_pairs)
    r = t - off[p]
    S = set_row[p]
    block = block_row[p]
    qid = qid_row[p].clamp(0, adj_b.shape[0] - 1)
    adjq = adj_b[qid]
    lb = bs.pdep(r, block, nmax)
    rb = block & ~lb
    enum_ok = (t < lane_count) & (lb != 0) & (rb != 0)
    ccp = enum_ok & (_ccp(lb, rb, adjq) != 0)
    S_left = bs.grow_rows(lb, S & ~rb, adjq)
    return (S, S_left, enum_ok.to(torch.int32), ccp.to(torch.int32), qid, p)


# -- phase A of MPDP-general: one query's (nmax,) table and edge arrays -------

_PHASE_A_SLICE = 4096    # sets a slice: bounds the (B, slots, slots) temporaries


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
    """Phase A of MPDP-general: blocks of every set of ``S`` (int32[B]):
    1. BFS spanning tree (parent/depth) of G[S];
    2. fundamental cycle per non-tree edge (LCA walk, vertex bitmaps);
    3. merge cycles sharing >= 2 vertices (transitive closure);
    4. tree edges no fundamental cycle covers are bridges => 2-vertex
       blocks.

    Returns ``(merged int32[B, cyc_cap], bridge int32[B, nmax])``; zero
    entries are padding.  ``adj`` is the query's int32[nmax] table and the
    edge arrays its int32[emax] endpoint indices (-1 pad) and live mask.
    The reference ``vmap``s one set's functions over the batch; here the
    batch is the leading dimension of every tensor.
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


def phase_a_blocks_ref(S, adj, eu_idx, ev_idx, edge_live, nmax: int,
                       eff_cap: int, width: int):
    """Row t: the blocks of G[S[t]] from ``blocks_chunk`` with ``cyc_cap =
    eff_cap``, its merged blocks in slot order then its bridges by
    ascending vertex, left-justified and zero after, the first ``width``
    of them (``width <= eff_cap + nmax``) -> int32[N, width].  Slices of
    ``_PHASE_A_SLICE`` sets; a set's row does not depend on the others."""
    rows = [torch.zeros((0, width), dtype=torch.int32, device=S.device)]
    for s0 in range(0, S.shape[0], _PHASE_A_SLICE):
        merged, bridge = blocks_chunk(S[s0: s0 + _PHASE_A_SLICE], adj,
                                      eu_idx, ev_idx, edge_live, nmax=nmax,
                                      cyc_cap=eff_cap)
        both = torch.cat([merged, bridge], dim=1)
        # the non-zero entries first, each part in its order
        order = torch.sort((both == 0).to(torch.int8), dim=1,
                           stable=True).indices
        rows.append(both.gather(1, order)[:, :width])
    return torch.cat(rows)
