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
``btree_eval_prune`` and ``bgeneral_eval_prune`` are the last two decodes
followed by the eager epilogue that the chunk bodies of ``core`` run on
typed and DPSUB chunks (``lane_cost``, ``prune``, ``segment_sum``, kept
here), whose costs agree with the reference's to a relative 1e-5
(``core.cost``), and folded into the caller's key and count buffers by
``fold_into`` where it gives them; ``commit_keys_ref`` is the commit of
such a buffer to the memo.
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
from ..core import cost as cm
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


# -- the chunk bodies' eager epilogue -----------------------------------------
# ``core.batch`` and ``core.engine`` run these after the decode forms (typed
# and DPSUB chunks); the fused forms' plain versions run them after the
# last two decodes.

_I32_MIN = -(1 << 31)


def take(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``buf[idx]`` with the reference's gather semantics (indices clamped)."""
    return buf[idx.clamp(0, buf.shape[0] - 1)]


def memo_reads(S, S_left, S_right, qid, nmax: int, memo_cost, memo_rows):
    """The lanes' memo reads at ``(qid << nmax) | x``, clamped: the costs
    of S_left and S_right, then the rows of S_left, S_right and S."""
    mbase = qid << nmax
    return (take(memo_cost, mbase | S_left), take(memo_cost, mbase | S_right),
            take(memo_rows, mbase | S_left), take(memo_rows, mbase | S_right),
            take(memo_rows, mbase | S))


def lane_cost(S, S_left, S_right, ccp, qid, nmax: int, memo_cost, memo_rows):
    """Candidate cost of each lane's inner-join (S_left, S_right) split,
    ``(cl + cr) + cost.join_cost(rl, rr, rows_S)`` on ``memo_reads``
    (``INF`` off the ccp mask), and the left bitmap the prune keeps."""
    cl, cr, rl, rr, rows_S = memo_reads(S, S_left, S_right, qid, nmax,
                                        memo_cost, memo_rows)
    return (torch.where(ccp, cl + cr + cm.join_cost(rl, rr, rows_S),
                        float("inf")), S_left)


def prune(seg: torch.Tensor, cand_cost: torch.Tensor, cand_left: torch.Tensor,
          nseg: int):
    """Two-pass in-chunk prune: segment-min cost then max-left among ties;
    an empty segment keeps the reference's identities (``INF``,
    ``INT32_MIN``) and a lane of ``INF`` cost offers left 0."""
    seg = seg.long()
    seg_cost = torch.full((nseg,), float("inf"), dtype=torch.float32,
                          device=cand_cost.device)
    seg_cost.scatter_reduce_(0, seg, cand_cost, "amin")
    is_best = cand_cost == seg_cost[seg]
    left_cand = torch.where(is_best & torch.isfinite(cand_cost), cand_left, 0)
    seg_left = torch.full((nseg,), _I32_MIN, dtype=torch.int32,
                          device=cand_left.device)
    seg_left.scatter_reduce_(0, seg, left_cand, "amax")
    return seg_cost, seg_left


def segment_sum(x: torch.Tensor, qid: torch.Tensor, bcap: int) -> torch.Tensor:
    """Per query row the sum of its lanes' ``x``, int32[bcap]."""
    return torch.zeros(bcap, dtype=torch.int32, device=x.device).index_add_(
        0, qid, x.to(torch.int32))


def pack_pruned(seg_cost, seg_left, enum_q, ccp_q):
    """A chunk's own buffer of the fused forms from the eager epilogue's
    outputs: int64 keys ``(0x7F800000 - bits(cost)) << 32 | (left ^
    INT32_MIN)`` a segment, then the counts as int64, enumerated then ccp
    (``ops.unpack_pruned`` reads it back).  A finite or ``INF`` cost
    (>= +0; a split's is never -0.0) makes a key >= 0 that orders as
    ``prune`` does: larger is cheaper, then the larger left bitmap."""
    hi = 0x7F800000 - seg_cost.view(torch.int32)
    keys = torch.stack([seg_left ^ _I32_MIN, hi], dim=1).view(torch.int64)
    return torch.cat([keys.reshape(-1), enum_q.long(), ccp_q.long()])


def fold_into(buf, nseg: int, keys=None, counts=None):
    """The fused forms' output from a chunk's packed buffer
    (``pack_pruned``, ``nseg`` keys): the buffer itself without targets;
    else its keys folded into ``keys[:nseg]`` (the maximum with what is
    there, as the kernels' ``atomicMax``) and its counts added to
    ``counts`` (int64, as their ``atomicAdd``), and ``keys`` back."""
    if keys is None:
        return buf
    torch.maximum(keys[:nseg], buf[:nseg], out=keys[:nseg])
    counts[: len(buf) - nseg] += buf[nseg:]
    return keys


def commit_keys_ref(keys, idx, memo_cost, memo_left) -> None:
    """``commit_keys_kernel``: the keys of one memo entry (consecutive in
    ``idx``, int32[n]) folded to their maximum, and each entry whose
    maximum holds a finite cost written, cost and left bitmap, to
    ``memo_cost``/``memo_left`` in place; indices outside the memo are
    dropped.  Raises where one entry's keys are not consecutive."""
    n = idx.numel()
    if not n:
        return
    idx = idx.long()
    head = torch.ones(n, dtype=torch.bool, device=idx.device)
    head[1:] = idx[1:] != idx[:-1]
    at = idx[head]
    if at.numel() != torch.unique(idx).numel():
        raise ValueError("commit_keys: the keys of one memo entry must be "
                         "consecutive")
    best = torch.zeros(at.numel(), dtype=torch.int64, device=idx.device)
    best.scatter_reduce_(0, torch.cumsum(head, 0) - 1, keys[:n], "amax")
    w = best.view(torch.int32).reshape(-1, 2)        # (low, high) words
    cost = (0x7F800000 - w[:, 1]).view(torch.float32)
    keep = torch.isfinite(cost) & (at >= 0) & (at < memo_cost.numel())
    memo_cost[at[keep]] = cost[keep]
    memo_left[at[keep]] = w[keep, 0] ^ _I32_MIN


def tree_epilogue(lanes, adj_b, memo_cost, memo_rows, nmax: int,
                  nseg: int):
    """The eager epilogue (``lane_cost``, ``prune``, ``segment_sum``) on
    the lanes of ``btree_eval_decode``, packed by ``pack_pruned``."""
    S, S_left, in_i, qid, seg = lanes
    edge_in = in_i != 0
    cand, lbx = lane_cost(S, S_left, S & ~S_left, edge_in, qid, nmax,
                          memo_cost, memo_rows)
    ev_q = segment_sum(edge_in, qid, adj_b.shape[0])
    return pack_pruned(*prune(seg, cand, lbx, nseg), ev_q, ev_q)


def general_epilogue(lanes, pcap: int, adj_b, memo_cost, memo_rows,
                     nmax: int):
    """The eager epilogue on the lanes of ``bgeneral_eval_decode``, one
    segment a pair of the table, packed by ``pack_pruned``."""
    S, S_left, enum_i, ccp_i, qid, p = lanes
    cand, lbx = lane_cost(S, S_left, S & ~S_left, ccp_i != 0, qid, nmax,
                          memo_cost, memo_rows)
    bcap = adj_b.shape[0]
    return pack_pruned(*prune(p, cand, lbx, pcap),
                       segment_sum(enum_i, qid, bcap),
                       segment_sum(ccp_i, qid, bcap))


def btree_eval_prune_ref(all_sets, eoff, loff, soff, seg0: int, m_b, emu_b,
                         emv_b, adj_b, memo_cost, memo_rows, nmax: int,
                         nseg: int, chunk: int):
    """``btree_eval_decode_ref``'s lanes through ``tree_epilogue``."""
    return tree_epilogue(
        btree_eval_decode_ref(all_sets, eoff, loff, soff, seg0, m_b, emu_b,
                              emv_b, adj_b, nmax, nseg, chunk),
        adj_b, memo_cost, memo_rows, nmax, nseg)


def bgeneral_eval_prune_ref(pairs, n_pairs: int, lane_count: int, adj_b,
                            memo_cost, memo_rows, nmax: int, chunk: int):
    """``bgeneral_eval_decode_ref``'s lanes through ``general_epilogue``."""
    return general_epilogue(
        bgeneral_eval_decode_ref(pairs, n_pairs, lane_count, adj_b, nmax,
                                 chunk),
        pairs.shape[1], adj_b, memo_cost, memo_rows, nmax)


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
