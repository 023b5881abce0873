"""Plain PyTorch versions of the kernels (bit-exact oracles).

Each function computes what its CUDA kernel in ``csrc/ccp_eval.cu``
computes, on the port's lane-vectorised ``bitset`` helpers, and equals the
reference bit for bit: the seven lane kernels its ``repro.kernels.ref``,
the six forms that build their own lanes (``connectivity_span``,
``ccp_eval_dpsub``, ``bconnectivity_span``, ``bccp_eval_decode``,
``btree_eval_decode``, ``bgeneral_eval_decode``) the unrank or lane decode
of its chunk bodies
followed by the lane kernel.
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
