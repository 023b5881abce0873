"""The chunk layer: everything between ``kernels.ops`` and the level loops.

Every level loop of the port (``engine.ExactEngine``,
``batch.BatchEngine``, ``shard.ShardedBatchEngine`` and
``lattice.LatticeShardedEngine``) launches its evaluate chunks through the
bodies here and folds them through one of two accumulators:

  bodies     ``_beval_dpsub_chunk``, ``_beval_tree_chunk`` and
             ``_beval_general_chunk``, the port of the ``repro.core.batch``
             bodies of the same names: a batched flight's at its ``bcap``,
             a lattice shard's and the solo engine's MPDP:Tree and
             MPDP-general ones at ``bcap = 1`` on one-row tables (the solo
             DPSUB body, a kernel of its own, stays in ``engine``)
  lane cost  ``_lane_cost`` (inner joins: ``kernels.ref.lane_cost``) and
             ``_typed_lane_cost`` (both operand orientations under the
             conflict mask)
  epilogue   an inner-join MPDP:Tree or MPDP-general chunk costs, prunes
             and counts inside its kernel (``ops.btree_eval_prune``,
             ``ops.bgeneral_eval_prune``: ``Pruned``); typed flights and
             DPSUB keep the epilogue in torch ops (``_fused``), those of
             the kernels' plain versions (``kernels.ref``)
  fold       on the device (``DeviceFold``, the single-device engines'
             fused chunks, ``_folds``): the kernels fold every chunk of a
             level into one key buffer and the flight's counts, and one
             ``ops.commit_keys`` launch a level writes the memo; nothing is
             read back until the engine fetches its memo.  On the host
             (``ChunkResults``: typed flights, DPSUB and the lattice, whose
             commit is the cross-device ``min_left_commit``): ``_fetch``,
             one device-to-host copy a chunk, then the level's best (cost,
             left) per set (min cost, ties to the larger left bitmap) and
             its per-query counts folded in launch order.  Both count each
             chunk they take in the recorder's ``engine.eval_chunks``, a
             fused one in ``engine.fused_chunks`` and one folded on the
             device in ``engine.folded_chunks``
  tables     ``_offset_rows`` (a level's chunk-local offsets, one copy a
             level) and the MPDP-general pair windows (``_pair_offsets``,
             ``_pair_window``, ``_pair_table``)

The drivers look the bodies up here at call time (``chunks._beval_*``), so
what replaces one here reaches every engine.  Where the reference's array
semantics and torch differ, this module spells them out: out-of-range
gathers clamp (``kernels.ref.take``), memo scatters drop indices outside
the table (``_scatter_into``), and ``_prune`` starts its segments from the
reference's empty-segment identities (``+inf`` for cost, int32 min for the
left bitmap).  Min and max do not depend on the order of the reduction,
so ``_prune`` gives the same result on the CPU and on the card, run after
run.
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from . import bitset as bs
from . import conflicts as cf
from . import cost as cm
from . import faults
from . import telemetry as _telemetry
from ..kernels import ops, ref
from ..kernels.ref import memo_reads, prune as _prune, segment_sum as _segment_sum

INF = np.float32(np.inf)
_I32 = torch.int32
_CLIP = 1 << 30          # offset clip keeps chunk-local offsets int32


def _cap(n: int, lo: int = 1024) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


def _scatter_into(buf: torch.Tensor, idx_np: np.ndarray, val_np) -> None:
    """``buf[idx] = val`` in place; indices outside ``buf`` are dropped (the
    reference's ``mode="drop"``)."""
    idx_np = np.asarray(idx_np)
    keep = (idx_np >= 0) & (idx_np < buf.shape[0])
    idx = torch.from_numpy(idx_np[keep].astype(np.int64))
    val = torch.from_numpy(np.asarray(val_np)[keep]).to(buf.dtype)
    buf[idx.to(buf.device)] = val.to(buf.device)


# ============================================================ level hooks ==

class _LevelHooks:
    """What every level loop shares (``engine.ExactEngine``,
    ``batch._LevelLoop``): the cooperative deadline, armed once when a run
    starts and read once at the top of every level, and the count of
    dispatched chunks.  The engine holds ``deadline_s``, ``_deadline_at``,
    ``degraded`` and ``chunks_dispatched``."""

    def _arm_deadline(self) -> None:
        """Start the cooperative deadline clock (one ``faults.now()`` call;
        nothing without ``deadline_s``)."""
        self._deadline_at = (None if self.deadline_s is None
                             else faults.now() + self.deadline_s)

    def _count_chunk(self) -> None:
        """One filter span or evaluate chunk dispatched (the recorder's
        ``engine.chunks`` counter beside ``chunks_dispatched``)."""
        self.chunks_dispatched += 1
        _telemetry.count("engine.chunks")

    def _expired(self, i: int, levels_total: int) -> bool:
        """Checked once at the top of every DP level: past the deadline the
        run abandons levels >= i and the engine's result stitches a
        best-effort plan from the committed memo levels; with
        ``deadline_s=None`` a single attribute test."""
        if self._deadline_at is None:
            return False
        if faults.now() < self._deadline_at:
            return False
        self.degraded = {"reason": "deadline", "deadline_s": self.deadline_s,
                         "levels_done": i - 1, "levels_total": levels_total}
        return True


# =================================================================== fold ==

class Pruned(NamedTuple):
    """A fused chunk's result on the device: what ``ops.btree_eval_prune``
    or ``ops.bgeneral_eval_prune`` returned (the chunk's own buffer, or the
    level's keys it folded into) and its number of query rows."""
    buf: torch.Tensor
    bcap: int


def _fused(targs) -> bool:
    """Whether an MPDP:Tree or MPDP-general chunk runs the fused evaluate
    epilogue: on a flight without conflict arrays.  A typed flight costs
    both operand orientations of a lane and keeps the epilogue in torch
    ops."""
    return not targs


def _folds(algorithm: str, targs) -> bool:
    """Whether a single-device engine folds a level's evaluate chunks on
    the device (``DeviceFold``): where their body returns ``Pruned``, the
    inner-join MPDP:Tree and MPDP-general chunks."""
    return algorithm in ("mpdp_tree", "mpdp_general") and _fused(targs)


def _count_eval(out) -> None:
    """An evaluate chunk's result taken: ``engine.eval_chunks``, and for a
    fused one ``engine.fused_chunks``."""
    _telemetry.count("engine.eval_chunks")
    if isinstance(out, Pruned):
        _telemetry.count("engine.fused_chunks")


def _fetch(out):
    """One device->host copy of a chunk's results -> (seg_cost, seg_left,
    ev_q, ccp_q) numpy arrays; ``out`` is a fused chunk's ``Pruned`` (its
    own buffer) or the four tensors of the torch epilogue."""
    with _telemetry.span("engine.fetch"):
        if isinstance(out, Pruned):
            return ops.unpack_pruned(out.buf.cpu().numpy(), out.bcap)
        seg_cost, seg_left, ev_q, ccp_q = out
        n = seg_cost.shape[0]
        k = ev_q.numel()
        buf = torch.cat([seg_cost.view(_I32), seg_left, ev_q.reshape(-1),
                         ccp_q.reshape(-1)]).cpu().numpy()
    return (buf[:n].view(np.float32), buf[n: 2 * n], buf[2 * n: 2 * n + k],
            buf[2 * n + k:])


def _merge_best(best_cost, best_left, base, seg_cost, seg_left):
    """Fold a chunk's per-segment minima into the level's host-side best
    arrays (min cost, ties broken by max left bitmap)."""
    nseg = len(seg_cost)
    idx = base + np.arange(nseg)
    ok = (idx >= 0) & (idx < len(best_cost))
    idx = idx[ok]
    sc = seg_cost[ok]
    sl = seg_left[ok]
    better = (sc < best_cost[idx]) | ((sc == best_cost[idx]) & (sl > best_left[idx]))
    upd = idx[better]
    best_cost[upd] = sc[better]
    best_left[upd] = sl[better]


def _merge_scattered(best_cost, best_left, ks, cs, ls):
    """Fold scattered per-key candidate (cost, left) pairs into host-side
    best arrays: min cost per key, ties broken by max left bitmap."""
    np.minimum.at(best_cost, ks, cs)
    tie = cs == best_cost[ks]
    np.maximum.at(best_left, ks[tie], ls[tie])


class ChunkResults:
    """One device's pending evaluate chunks in one level, and the level's
    best (cost, left) per set and per-query counts they fold into, on the
    host.

    ``add(key, out)`` queues a chunk body's result (``into`` gives the body
    no target: a fused chunk fills its own buffer).  Without ``pk`` the
    chunk's segments are contiguous and ``key`` is its first one (``seg0``);
    each fetched chunk folds through ``_merge_best``.  With ``pk`` (pair
    mode: MPDP-general's scattered per-pair candidates, ``pk`` each pair's
    set index) ``key`` is ``(p0, npair)``, the chunk's pairs, and their
    finite candidates collect for one ``_merge_scattered`` in ``finish``;
    a contiguous chunk never goes through ``np.minimum.at``.

    ``drain(limit)`` fetches pending results in launch order (``_fetch``)
    until ``limit`` remain, adding ``ev``/``ccp`` of the first ``nq``
    query rows; ``finish()`` drains them all and returns ``(best_cost,
    best_left, ev, ccp)``; ``commit(memo_cost, memo_left)`` finishes,
    writes each set's finite best at its memo index ``idx`` (one a set)
    and returns ``(ev, ccp)``."""

    def __init__(self, nsets: int, nq: int, pk: np.ndarray | None = None,
                 idx: np.ndarray | None = None):
        self.best_cost = np.full(nsets, INF, np.float32)
        self.best_left = np.zeros(nsets, np.int32)
        self.ev = np.zeros(nq, np.int64)
        self.ccp = np.zeros(nq, np.int64)
        self.pk = pk
        self.idx = idx
        self._pend = deque()
        self._cand = ([], [], [])                # pair mode: keys, costs, lefts

    def into(self, k0: int) -> dict:
        return {}

    def add(self, key, out) -> None:
        _count_eval(out)
        self._pend.append((key, out))

    def drain(self, limit: int) -> None:
        nq = len(self.ev)
        while len(self._pend) > limit:
            key, out = self._pend.popleft()
            sc, sl, ev_q, ccp_q = _fetch(out)
            self.ev += ev_q[:nq]
            self.ccp += ccp_q[:nq]
            if self.pk is None:
                _merge_best(self.best_cost, self.best_left, key, sc, sl)
                continue
            p0, npair = key
            fin = np.isfinite(sc[:npair])
            for got, a in zip(self._cand, (self.pk[p0: p0 + npair],
                                           sc[:npair], sl[:npair])):
                got.append(a[fin])

    def finish(self):
        self.drain(0)
        if self._cand[0]:
            _merge_scattered(self.best_cost, self.best_left,
                             *map(np.concatenate, self._cand))
        return self.best_cost, self.best_left, self.ev, self.ccp

    def commit(self, memo_cost, memo_left):
        best_cost, best_left, ev, ccp = self.finish()
        fin = np.isfinite(best_cost)
        _scatter_into(memo_cost, self.idx[fin], best_cost[fin])
        _scatter_into(memo_left, self.idx[fin], best_left[fin])
        return ev, ccp


class DeviceFold:
    """A single-device engine's fused evaluate chunks (``_folds``), folded
    on its device: the host fetches, merges and scatters nothing a chunk
    or a level.

    ``level(idx, slack)`` starts a level: one zeroed int64 key buffer of
    ``len(idx) + slack`` keys and one upload of ``idx``, the memo index
    ``(q << nmax) | S`` of each of the first ``len(idx)`` keys (a
    contiguous level: one a set, and ``slack`` keys past them for the
    clamped segments of its last chunk; MPDP-general: one a (set, block)
    pair, the pairs sorted by set, and ``slack`` for a chunk's padding
    pairs).  ``into(k0)`` is the ``keys``/``counts`` the chunk body
    launches into, the chunk's first segment or pair at key ``k0``: its
    kernel folds its keys there with ``atomicMax`` and its per-query
    counts into one int64 ``counts[2 * bcap]`` (enumerated, then ccp)
    kept for the whole flight.  ``add(key, out)`` only counts the chunk,
    ``drain`` does nothing, and ``commit(memo_cost, memo_left)`` writes
    the level's best to the memo in one ``ops.commit_keys`` launch: for
    each set the largest key of its segment or of its pairs, where it
    holds a finite cost.  The counts reach the host with the engine's
    memo fetch: ``pending()`` is what to fetch with it, ``settle(words,
    counters)`` adds the fetched counts to each query's ``Counters``, once.
    The maximum does not depend on the order of the chunks, so the memo
    and counts are ``ChunkResults``' bit for bit."""

    def __init__(self, bcap: int, device):
        self.bcap = bcap
        self.device = device
        self.counts = None
        self.keys = self.idx = None

    def level(self, idx: np.ndarray, slack: int) -> "DeviceFold":
        if self.counts is None:
            self.counts = torch.zeros(2 * self.bcap, dtype=torch.int64,
                                      device=self.device)
        self.keys = torch.zeros(len(idx) + slack, dtype=torch.int64,
                                device=self.device)
        self.idx = torch.from_numpy(
            np.ascontiguousarray(idx, np.int32)).to(self.device)
        return self

    def into(self, k0: int) -> dict:
        return {"keys": self.keys[k0:], "counts": self.counts}

    def add(self, key, out) -> None:
        _count_eval(out)
        _telemetry.count("engine.folded_chunks")

    def drain(self, limit: int) -> None:
        pass

    def commit(self, memo_cost, memo_left) -> None:
        ops.commit_keys(self.keys, self.idx, memo_cost, memo_left)
        self.keys = self.idx = None

    def pending(self) -> list:
        return [] if self.counts is None else [self.counts.view(_I32)]

    def settle(self, words: np.ndarray, counters) -> None:
        if self.counts is None:
            return
        got = np.ascontiguousarray(words).view(np.int64)
        for q, c in enumerate(counters):
            c.evaluated += int(got[q])
            c.ccp += int(got[self.bcap + q])
        self.counts = None


# ================================================================= tables ==

def _offset_rows(off: np.ndarray, lane0s: np.ndarray, bcap: int) -> np.ndarray:
    """``int32[len(lane0s), bcap+1]``: row j holds the chunk-local offsets
    ``off - lane0s[j]`` of the chunk at lane ``lane0s[j]`` (``off`` the
    level's int64 per-query prefix, B + 1 entries), clipped to ``+-_CLIP``
    and padded with its last value; one copy to the device serves a
    level."""
    B = len(off) - 1
    el = np.clip(off[None, :] - lane0s[:, None], -_CLIP, _CLIP)
    rows = np.empty((len(lane0s), bcap + 1), np.int32)
    rows[:, : B + 1] = el
    rows[:, B + 1:] = el[:, B: B + 1]
    return rows


def _pair_offsets(pb: np.ndarray) -> np.ndarray:
    """The MPDP-general lane prefix of a level's (set, block) pairs: pair p
    owns lanes ``[offs[p], offs[p+1])``, ``2^|block|`` of them (int64,
    ``len(pb) + 1`` entries)."""
    offs = np.zeros(len(pb) + 1, np.int64)
    np.cumsum(np.int64(1) << bs.np_popcount(pb).astype(np.int64),
              out=offs[1:])
    return offs


def _pair_table(ps, pb, pq, offs, p0: int, p1: int, lane0: int) -> np.ndarray:
    """The ``int32[4, pcap]`` pair table of the MPDP-general chunk at lane
    ``lane0``: rows (set, block, query, chunk-local lane offset) of pairs
    ``p0 .. p1 - 1`` (``pq`` None: query 0), padded to ``pcap = _cap(p1 -
    p0, 256)`` with zeros and offset ``_CLIP``; offsets clipped to
    ``+-_CLIP``, so every entry stays inside int32."""
    npair = p1 - p0
    pairs = np.zeros((4, _cap(npair, 256)), np.int64)
    pairs[0, :npair] = ps[p0:p1]
    pairs[1, :npair] = pb[p0:p1]
    if pq is not None:
        pairs[2, :npair] = pq[p0:p1]
    pairs[3] = _CLIP
    pairs[3, :npair] = np.clip(offs[p0:p1] - lane0, -_CLIP, _CLIP)
    return pairs.astype(np.int32)


def _pair_window(ps, pb, pq, offs, lane0: int, lane1: int):
    """The MPDP-general chunk over lanes ``[lane0, lane1)`` of the prefix
    ``offs`` (``_pair_offsets``): ``(p0, npair, table)``, its first pair,
    its number of pairs and its ``_pair_table``."""
    p0 = int(np.searchsorted(offs, lane0, side="right")) - 1
    p1 = int(np.searchsorted(offs, lane1, side="left"))
    return p0, p1 - p0, _pair_table(ps, pb, pq, offs, p0, p1, lane0)


# ============================================================ chunk bodies ==
# Every tensor lives on the engine's device.  ``targs`` are a typed
# flight's stacked (bcap, emax) conflict arrays (kind, operand masks, TES
# bitmaps), empty for an inner-only one.

def _typed_lane_cost(lb, rb, S_rows, ccp, cl, cr, rl, rr,
                     ekind, elm, erm, etes_l, etes_r):
    """Typed twin of ``_lane_cost``: costs both operand orientations of the
    (lb, rb) split under the conflict mask and returns the cheaper valid
    candidate and its left bitmap (a tie keeps lb, the enumeration-order
    operand).  ``cl``/``cr``/``rl``/``rr`` are the lanes' memo costs and
    rows of lb/rb, gathered by the caller; the addition order is
    ``_lane_cost``'s, ``(cl + cr) + jc``."""
    va, vb, lk = cf.lane_valid_kinds(lb, rb, ekind, elm, erm, etes_l, etes_r)
    base = cl + cr
    cand_a = torch.where(ccp & va, base + cm.join_cost_kind(rl, rr, S_rows, lk),
                         float(INF))
    cand_b = torch.where(ccp & vb, base + cm.join_cost_kind(rr, rl, S_rows, lk),
                         float(INF))
    return torch.minimum(cand_a, cand_b), torch.where(cand_b < cand_a, rb, lb)


def _lane_cost(S, S_left, S_right, ccp, qid, nmax: int, memo_cost, memo_rows,
               targs=()):
    """Candidate cost of each lane's (S_left, S_right) split (INF off-CCP)
    and the left bitmap the prune keeps, from the memo entries at ``(qid
    << nmax) | x`` (``qid`` 0: the solo engine's one query); a typed
    flight costs both operand orientations under the conflict mask of the
    lane's query; an inner-only one is ``kernels.ref.lane_cost``."""
    if not targs:
        return ref.lane_cost(S, S_left, S_right, ccp, qid, nmax, memo_cost,
                             memo_rows)
    cl, cr, rl, rr, rows_S = memo_reads(S, S_left, S_right, qid, nmax,
                                        memo_cost, memo_rows)
    return _typed_lane_cost(S_left, S_right, rows_S, ccp, cl, cr, rl, rr,
                            *[a[qid] for a in targs])


def _beval_dpsub_chunk(all_sets, eoff, loff, soff, seg0, i, adj_b, memo_cost,
                       memo_rows, targs=(), *, nmax: int, chunk: int,
                       nseg: int, bcap: int):
    """Batched DPSUB evaluate: the ``bccp_eval_decode`` kernel decodes each
    lane's (query, set, subset), splits S and tests the pair; the cost, the
    prune and the segment sums stay here.

    eoff: i32[bcap+1] chunk-local per-query lane offsets (prefix of ns_q<<i,
                      ``eoff[0] <= 0``).
    loff: i32[bcap]   per-query base into all_sets (region + level offset).
    soff: i32[bcap]   per-query global set-index prefix (segment ids).
    The evaluated lanes of query q are its live lanes, ``[eoff[q],
    eoff[q+1])`` inside the chunk.
    """
    lb, rb, ccp_i, qid, seg = ops.bccp_eval_decode(
        all_sets, eoff, loff, soff, seg0, i, adj_b, nmax, nseg, chunk)
    ccp = ccp_i != 0
    cand, lbx = _lane_cost(lb | rb, lb, rb, ccp, qid, nmax, memo_cost,
                           memo_rows, targs)
    seg_cost, seg_left = _prune(seg, cand, lbx, nseg)
    ev_q = eoff[1:].clamp(0, chunk) - eoff[:-1].clamp(0, chunk)
    return seg_cost, seg_left, ev_q, _segment_sum(ccp, qid, bcap)


def _beval_tree_chunk(all_sets, eoff, loff, soff, seg0, m_b, adj_b, emu_b,
                      emv_b, memo_cost, memo_rows, targs=(), *, nmax: int,
                      chunk: int, nseg: int, bcap: int, keys=None,
                      counts=None):
    """Batched MPDP:Tree evaluate: the ``btree_eval_decode`` kernel decodes
    each lane's (query, set, edge) and splits S; the cost and the prune
    stay here.  An inner-join flight runs them in the kernel as well: one
    ``btree_eval_prune`` launch (``Pruned``), into ``keys``/``counts``
    where the accumulator gives them (``DeviceFold.into``).

    m_b: i32[bcap] per-query edge count (lane-minor dimension);
    emu_b/emv_b: i32[bcap, emax] per-query edge endpoint bitmaps (0 pad).
    Every enumerated in-set edge IS a CCP pair (Theorem 3).  The solo
    engine passes one-row tables (``engine._tree_offsets``).
    """
    if _fused(targs):
        return Pruned(ops.btree_eval_prune(
            all_sets, eoff, loff, soff, seg0, m_b, emu_b, emv_b, adj_b,
            memo_cost, memo_rows, nmax, nseg, chunk, keys=keys,
            counts=counts), bcap)
    S, S_left, in_i, qid, seg = ops.btree_eval_decode(
        all_sets, eoff, loff, soff, seg0, m_b, emu_b, emv_b, adj_b, nmax,
        nseg, chunk)
    edge_in = in_i != 0
    cand, lbx = _lane_cost(S, S_left, S & ~S_left, edge_in, qid, nmax,
                           memo_cost, memo_rows, targs)
    seg_cost, seg_left = _prune(seg, cand, lbx, nseg)
    ev_q = _segment_sum(edge_in, qid, bcap)              # Theorem 3: all CCP
    return seg_cost, seg_left, ev_q, ev_q.clone()


def _beval_general_chunk(pairs, n_pairs, lane_count, adj_b, memo_cost,
                         memo_rows, targs=(), *, nmax: int, chunk: int,
                         bcap: int, keys=None, counts=None):
    """Batched MPDP-general evaluate: the ``bgeneral_eval_decode`` kernel
    decodes each lane's (query, set, block, rank) and splits S; the cost
    and the prune stay here.  An inner-join flight runs them in the kernel
    as well: one ``bgeneral_eval_prune`` launch (``Pruned``), into
    ``keys``/``counts`` where the accumulator gives them.

    Phase A compacted every set's blocks into sorted (set, block) pairs;
    the fused lane space is the block prefix-sum over all queries' pairs,
    and ``pairs`` is the chunk's ``int32[4, pcap]`` (set, block, query,
    chunk-local lane offset) table (``_pair_window``), one segment per
    pair.
    """
    if _fused(targs):
        return Pruned(ops.bgeneral_eval_prune(
            pairs, n_pairs, lane_count, adj_b, memo_cost, memo_rows, nmax,
            chunk, keys=keys, counts=counts), bcap)
    S, S_left, enum_i, ccp_i, qid, p = ops.bgeneral_eval_decode(
        pairs, n_pairs, lane_count, adj_b, nmax, chunk)
    cand, lbx = _lane_cost(S, S_left, S & ~S_left, ccp_i != 0, qid, nmax,
                           memo_cost, memo_rows, targs)
    seg_cost, seg_left = _prune(p, cand, lbx, pairs.shape[1])
    return (seg_cost, seg_left, _segment_sum(enum_i, qid, bcap),
            _segment_sum(ccp_i, qid, bcap))
