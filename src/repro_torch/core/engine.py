"""Level-synchronous exact DP over one query (paper Alg. 5).

The port of ``repro.core.engine``.  The pipeline *unrank -> filter ->
evaluate -> prune -> scatter* runs on the engine's torch device:

  unrank    the ``connectivity_span`` kernel unranks a span of up to
            ``SPAN`` colex ranks of one level (combinatorial number
            system) and tests each set's connectivity in one launch; the
            host compacts the connected ones (``enum="expand"`` grows the
            previous level's sets by one neighbour instead)
  evaluate  one flat lane space per DP level, in fixed-size chunks: DPSUB
            ``sets x 2^i`` (``ccp_eval_dpsub``, which decodes the chunk's
            lanes itself), MPDP:Tree ``sets x m`` and MPDP-general over
            the block prefix-sum of phase-A (set, block) pairs (the chunk
            layer's batched bodies ``chunks._beval_tree_chunk`` and
            ``_beval_general_chunk`` at ``bcap = 1``, on one-row tables),
            DPSIZE over level pairs
  prune     in-chunk segment-min per set + max left bitmap among ties
  scatter   dense memo tables indexed by subset bitmap

An inner-join graph's MPDP:Tree and MPDP-general chunks run their
epilogue inside the kernel (``chunks._fused``) and fold on the device
(``chunks.DeviceFold``: one key buffer a level, committed by one
``ops.commit_keys`` launch; the counts come back with ``result``'s memo
read).  Any other evaluate chunk comes back to the host in one
device-to-host copy before the next launches, and folds into the level's
best arrays through the chunk layer's ``chunks.ChunkResults``, drained to
0 after every launch.  DPSIZE keeps its own read-back and scattered
merge.

A typed graph (a LEFT, FULL, SEMI or ANTI edge) carries its conflict
arrays, stacked ``(1, emax)`` as a one-query flight's, into the DPSUB,
tree and general chunk bodies, which cost both operand orientations of
each lane under the conflict mask (``chunks._typed_lane_cost``); an
inner-only graph passes none.  DPSIZE refuses typed graphs, as the
reference does.

``ExactEngine`` honours a cooperative ``deadline_s`` as the reference's
does (``chunks._LevelHooks``): ``faults.now`` is read once when a run
starts and once at the top of every level; past the deadline ``result``
stitches a best-effort plan from the committed memo levels
(``heuristics.idp.stitch_partial_memo``).

``optimize`` is the solo entry point (``lattice=True`` sends it to
``lattice.optimize_lattice``); ``optimize_many`` forwards to
``batch.optimize_many``.  Both run on ``cuda`` unless the caller passes
``device``.
"""
from __future__ import annotations

import time
from math import comb

import numpy as np
import torch

from . import bitset as bs
from . import blocks as bl
from . import chunks as _ch
from . import cost as cm
from . import dpccp as _dpccp
from . import telemetry as _telemetry
from . import unrank as ur
from ..kernels import ops
from ..kernels.ref import prune as _prune, take as _take
from .chunks import (INF, ChunkResults, DeviceFold, _I32, _LevelHooks, _cap,
                     _lane_cost, _merge_scattered, _pair_offsets,
                     _pair_window, _scatter_into)
from .config import (CHUNK, CYC_CAP_DEFAULT, UNSET, OptimizerConfig,
                     alias_kwarg, resolve_config)
from .joingraph import DeviceGraph, JoinGraph
from .plan import Counters, OptimizeResult, extract_plan, leaf_plan

SPAN = 1 << 24           # ranks per filter launch (S and conn: 128 MiB)


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller names another.
    Raises when CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


# ============================================================ chunk bodies ==
# Every tensor lives on the engine's device; ``t`` is the chunk's lane index.

def _lanes(chunk: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(chunk, dtype=_I32, device=like.device)


def _expand_chunk(sets_pad, n_valid: int, adj, *, nmax: int, cap: int):
    """Grow each live set by one neighbour: ``(cap, nmax)`` candidates, 0
    where there is none (the host dedups)."""
    S = sets_pad
    nbr = bs.neighbors(S, adj) & ~S
    shifts = torch.arange(nmax, dtype=_I32, device=S.device)
    has = ((nbr[:, None] >> shifts) & 1) == 1
    cand = torch.where(has, S[:, None] | (torch.ones_like(shifts) << shifts), 0)
    live = (torch.arange(cap, device=S.device) < n_valid)[:, None]
    return torch.where(live, cand, 0)


def _eval_dpsub_chunk(all_sets, level_off: int, base_set: int, base_sub: int,
                      i: int, lane_count: int, adj, memo_cost, memo_rows,
                      targs=(), *, nmax: int, chunk: int, nseg: int):
    """Solo DPSUB lanes through ``ccp_eval_dpsub``, costed by the chunk
    layer's ``_lane_cost`` at query 0."""
    t = _lanes(chunk, adj)
    seg = (base_sub + t) >> i                   # lane's set index - base_set
    live = t < lane_count
    lb, rb, ccp_i = ops.ccp_eval_dpsub(all_sets, level_off, base_set,
                                       base_sub, i, adj, nmax, chunk)
    ccp = live & (ccp_i != 0)
    cand, lbx = _lane_cost(lb | rb, lb, rb, ccp, 0, nmax, memo_cost,
                           memo_rows, targs)
    seg_cost, seg_left = _prune(seg, cand, lbx, nseg)
    return (seg_cost, seg_left, live.sum(dtype=_I32).reshape(1),
            ccp.sum(dtype=_I32).reshape(1))


def _tree_offsets(level_off: int, base_set: int, base_e: int,
                  lane_count: int) -> np.ndarray:
    """The one-row offset tables of a solo MPDP:Tree chunk, stacked as
    ``[eoff (2), loff (1), soff (1)]``: lane t is edge-space lane ``base_e
    + t`` of set ``level_off + base_set`` on, live below ``lane_count``;
    its segment is its set index minus ``base_set``.  Every entry stays
    inside int32 at nmax 30, where the level's lane index need not."""
    return np.array([-base_e, lane_count, level_off + base_set, 0], np.int32)


def _eval_dpsize_chunk(all_sets, off_a: int, off_b: int, count_b: int,
                       base_a: int, base_b: int, lane_count: int, dg,
                       memo_cost, memo_rows, *, nmax: int, chunk: int):
    """DPSIZE: cross product of the level-a and level-b set lists.  Returns
    per-lane (union set, candidate cost, left set); the host merges (DPSIZE
    unions are scattered, no contiguous segments)."""
    t = _lanes(chunk, dg.adj)
    g = base_b + t
    ia = base_a + torch.div(g, count_b, rounding_mode="floor")
    ib = torch.remainder(g, count_b)
    live = t < lane_count
    A = _take(all_sets, off_a + ia)
    B = _take(all_sets, off_b + ib)
    disjoint = (A & B) == 0
    cross = (bs.neighbors(A, dg.adj) & B) != 0
    ccp = live & disjoint & cross                  # A, B connected by construction
    S = A | B
    rows = bs.member_matrix(S, nmax).to(torch.float32) @ dg.card_l2
    inside = (((S[:, None] & dg.emask_u[None, :]) != 0)
              & ((S[:, None] & dg.emask_v[None, :]) != 0))
    rows = torch.clamp(rows + torch.where(inside, dg.esel_l2[None, :], 0.0)
                       .sum(dim=1), min=0.0)
    cand = torch.where(ccp, memo_cost[A] + memo_cost[B]
                       + cm.join_cost(memo_rows[A], memo_rows[B], rows),
                       float(INF))
    return S, cand, A, live.sum(dtype=_I32), ccp.sum(dtype=_I32)


# ============================================================== host driver ==

class ExactEngine(_LevelHooks):
    """Runs one exact algorithm (dpsub / mpdp / dpsize) over a JoinGraph on
    ``device`` (``cuda`` by default), within ``deadline_s`` if given."""

    def __init__(self, g: JoinGraph, chunk: int = CHUNK,
                 cyc_cap: int = CYC_CAP_DEFAULT, enum: str = "unrank",
                 deadline_s: float | None = None, device=None):
        if not g.is_connected():
            raise ValueError("query graph must be connected (no cross products)")
        self.g = g
        self.deadline_s = deadline_s
        self._deadline_at: float | None = None
        self.degraded: dict | None = None
        self.enum = enum              # "unrank" (paper Alg.5) | "expand"
        self.device = resolve_device(device)
        self.dg = DeviceGraph.from_graph(g, self.device)
        self.n = g.n
        self.nmax = self.dg.nmax
        self.emax = self.dg.emax
        self.chunk = chunk
        self.cyc_cap = cyc_cap
        self.size = 1 << self.nmax
        self.binom = self._dev(ur.binom_table(self.nmax))
        # edge vertex indices (for block finding)
        eu = np.full(self.emax, -1, np.int32)
        ev = np.full(self.emax, -1, np.int32)
        lv = np.zeros(self.emax, bool)
        for i, (u, v) in enumerate(g.edges):
            eu[i], ev[i], lv[i] = u, v, True
        self.eu_idx = self._dev(eu)
        self.ev_idx = self._dev(ev)
        self.edge_live = self._dev(lv)
        # the solo tree and general evaluates run the batched kernels on
        # one-row tables
        self.adj1 = self.dg.adj.reshape(1, -1).contiguous()
        self.emu1 = self.dg.emask_u.reshape(1, -1).contiguous()
        self.emv1 = self.dg.emask_v.reshape(1, -1).contiguous()
        self.m1 = self._dev(np.array([g.m], np.int32))
        # typed-edge conflict arrays, stacked (1, emax) as a one-query
        # flight's, passed to the chunk bodies as ``targs`` only for a
        # typed graph
        self.typed = g.typed
        self._tkw = {}
        if self.typed:
            dg = self.dg
            self._tkw = {"targs": tuple(a.reshape(1, -1) for a in (
                dg.ekind, dg.elm, dg.erm, dg.etes_l, dg.etes_r))}
        self.counters = Counters()
        self.timings: dict[str, float] = {}
        self.chunks_dispatched = 0        # filter spans + evaluate chunks
        self._fold = DeviceFold(1, self.device)
        self._init_memo()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- memo ----
    def _init_memo(self):
        kw = dict(device=self.device)
        self.memo_cost = torch.full((self.size,), float(INF), dtype=torch.float32, **kw)
        self.memo_rows = torch.zeros(self.size, dtype=torch.float32, **kw)
        self.memo_left = torch.zeros(self.size, dtype=_I32, **kw)
        self.all_sets = torch.zeros(self.size, dtype=_I32, **kw)
        leaves = np.array([1 << v for v in range(self.n)], np.int32)
        lrows = self.g.log2_card.astype(np.float32)
        self._scatter(leaves, cost=cm.np_scan_cost(lrows).astype(np.float32),
                      rows=lrows)
        _scatter_into(self.all_sets, np.arange(self.n), leaves)
        self.level_off = {1: 0}
        self.level_cnt = {1: self.n}
        self._next_off = self.n

    def _scatter(self, sets_np, cost=None, rows=None, left=None):
        for buf, val in ((self.memo_cost, cost), (self.memo_rows, rows),
                         (self.memo_left, left)):
            if val is not None:
                _scatter_into(buf, sets_np, val)

    # ------------------------------------------------------------ filter ---
    def _level_sets(self, i: int):
        """Connected sets of level i (unrank+filter, or frontier expansion),
        ascending."""
        with _telemetry.stage(self.timings, "filter"):
            if self.enum == "expand":
                sets_np = self._level_sets_expand(i)
            else:
                sets_np = self._level_sets_unrank(i)
            rows_np = cm.np_rows_for_sets(sets_np, self.g)
            self._prev_level = sets_np
            # scatter rows for this level; register in the packed level buffer
            if len(sets_np):
                self._scatter(sets_np, rows=rows_np)
                _scatter_into(self.all_sets,
                              self._next_off + np.arange(len(sets_np)),
                              sets_np)
            self.level_off[i] = self._next_off
            self.level_cnt[i] = len(sets_np)
            self._next_off += len(sets_np)
        return sets_np

    def _level_sets_unrank(self, i: int):
        """Paper Alg.5: unrank the full C(n, i) space, mask connectivity,
        one ``connectivity_span`` launch and one copy back per ``SPAN``
        ranks.  Colex rank order is ascending bitmap order, and the
        compaction keeps it."""
        total = comb(self.n, i)
        sets_l = []
        for rank0 in range(0, total, SPAN):
            S, conn = ops.connectivity_span(i, rank0, min(SPAN, total - rank0),
                                            self.binom, self.dg.adj, self.nmax)
            self._count_chunk()
            with _telemetry.span("engine.fetch"):
                sets_l.append(S[conn != 0].cpu().numpy())
        return np.concatenate(sets_l)

    def _level_sets_expand(self, i: int):
        """Beyond-paper: expand level i-1 connected sets by one neighbour and
        dedup — O(|L_{i-1}| * deg) instead of O(C(n, i))."""
        if i == 2:
            prev = np.array([1 << v for v in range(self.n)], np.int32)
        else:
            prev = self._prev_level
        if not len(prev):
            return np.zeros(0, np.int32)
        cand_l = []
        for s0 in range(0, len(prev), self.chunk):
            sl = prev[s0: s0 + self.chunk]
            cap = _cap(len(sl))
            pad = np.zeros(cap, np.int32)
            pad[: len(sl)] = sl
            cand = _expand_chunk(self._dev(pad), len(sl), self.dg.adj,
                                 nmax=self.nmax, cap=cap)
            self._count_chunk()
            with _telemetry.span("engine.fetch"):
                c = cand.cpu().numpy().ravel()
            cand_l.append(c[c != 0])
        return np.unique(np.concatenate(cand_l)) if cand_l else np.zeros(0, np.int32)

    # ----------------------------------------------------------- merging ---
    def _count(self, ev, cc) -> None:
        self.counters.evaluated += int(ev[0])
        self.counters.ccp += int(cc[0])

    def _level_acc(self, algorithm: str, idx: np.ndarray, slack: int,
                   sets_np, pk=None):
        """The level's accumulator: the device fold for fused chunks (keys
        at memo indices ``idx``), else ``ChunkResults`` over ``sets_np``."""
        if _ch._folds(algorithm, self._tkw.get("targs")):
            return self._fold.level(idx, slack)
        return ChunkResults(len(sets_np), 1, pk, idx=sets_np)

    def _finish_level(self, acc) -> None:
        got = acc.commit(self.memo_cost, self.memo_left)
        if got is not None:
            self._count(*got)

    # ----------------------------------------------------- DPSUB and tree --
    def _run_segments(self, algorithm: str, mult, launch) -> None:
        """The DPSUB and MPDP:Tree level loop: level i's ``sets x
        mult(i)`` lanes in chunks, ``launch(i, lane0, lane_count, into)``
        the chunk at lane ``lane0`` into the accumulator's targets, each
        read back before the next launch where it is read back at all."""
        self._arm_deadline()
        for i in range(2, self.n + 1):
            if self._expired(i, self.n):
                break
            sets_np = self._level_sets(i)
            if not len(sets_np):
                continue
            with _telemetry.stage(self.timings, "evaluate"):
                mul = mult(i)
                lanes = len(sets_np) * mul
                acc = self._level_acc(algorithm, sets_np, self.chunk + 1,
                                      sets_np)
                for lane0 in range(0, lanes, self.chunk):
                    with _telemetry.leaf("engine.chunk"):
                        self._count_chunk()
                        key = lane0 // mul
                        acc.add(key, launch(i, lane0,
                                            min(self.chunk, lanes - lane0),
                                            acc.into(key)))
                        acc.drain(0)
                self._finish_level(acc)

    def run_dpsub(self) -> None:
        def launch(i, lane0, cnt, into):
            return _eval_dpsub_chunk(
                self.all_sets, self.level_off[i], lane0 >> i,
                lane0 & ((1 << i) - 1), i, cnt, self.dg.adj, self.memo_cost,
                self.memo_rows, nmax=self.nmax, chunk=self.chunk,
                nseg=self.chunk + 1, **self._tkw)
        self._run_segments("dpsub", lambda i: 1 << i, launch)

    def run_mpdp_tree(self) -> None:
        m = self.g.m

        def launch(i, lane0, cnt, into):
            offs = self._dev(_tree_offsets(self.level_off[i], lane0 // m,
                                           lane0 % m, cnt))
            return _ch._beval_tree_chunk(
                self.all_sets, offs[0:2], offs[2:3], offs[3:4], 0, self.m1,
                self.adj1, self.emu1, self.emv1, self.memo_cost,
                self.memo_rows, nmax=self.nmax, chunk=self.chunk,
                nseg=self.chunk + 1, bcap=1, **self._tkw, **into)
        self._run_segments("mpdp_tree", lambda i: m, launch)

    # ------------------------------------------------------- MPDP general --
    def _find_blocks_host(self, sets_np):
        """Phase A: per-set blocks -> compacted (set, block) pair arrays
        (shared host driver in ``blocks.np_pairs_for_sets``)."""
        with _telemetry.stage(self.timings, "blocks"):
            ps, pb = bl.np_pairs_for_sets(
                sets_np, self.g, self.dg.adj, self.eu_idx, self.ev_idx,
                self.edge_live, nmax=self.nmax, emax=self.emax,
                cyc_cap=self.cyc_cap)
        return ps, pb

    def run_mpdp_general(self) -> None:
        self._arm_deadline()
        for i in range(2, self.n + 1):
            if self._expired(i, self.n):
                break
            sets_np = self._level_sets(i)
            if not len(sets_np):
                continue
            ps, pb = self._find_blocks_host(sets_np)
            if not len(ps):
                continue
            with _telemetry.stage(self.timings, "evaluate"):
                offs = _pair_offsets(pb)
                total = int(offs[-1])
                # sets_np is ascending (colex rank order == ascending
                # bitmap), so pair -> local set index is a vectorised
                # searchsorted; the device fold keys each pair by its set
                acc = self._level_acc(
                    "mpdp_general", ps, _cap(self.chunk, 256), sets_np,
                    np.searchsorted(sets_np, ps).astype(np.int64))
                for lane0 in range(0, total, self.chunk):
                    with _telemetry.leaf("engine.chunk"):
                        self._count_chunk()
                        lane1 = min(lane0 + self.chunk, total)
                        p0, npair, pairs = _pair_window(ps, pb, None, offs,
                                                        lane0, lane1)
                        acc.add((p0, npair), _ch._beval_general_chunk(
                            self._dev(pairs), npair, lane1 - lane0,
                            self.adj1, self.memo_cost, self.memo_rows,
                            nmax=self.nmax, chunk=self.chunk, bcap=1,
                            **self._tkw, **acc.into(p0)))
                        acc.drain(0)
                self._finish_level(acc)

    # ------------------------------------------------------------- DPSIZE --
    def run_dpsize(self) -> None:
        if self.typed:
            raise ValueError(
                "dpsize does not support non-inner join edges (use dpsub / "
                "mpdp / dpccp — the conflict-masked lane spaces)")
        self._arm_deadline()
        for i in range(2, self.n + 1):
            if self._expired(i, self.n):
                break
            self._level_sets(i)
            with _telemetry.stage(self.timings, "evaluate"):
                s_all, c_all, l_all = [], [], []
                for a in range(1, i):
                    b = i - a
                    ca, cb = self.level_cnt[a], self.level_cnt[b]
                    if ca == 0 or cb == 0:
                        continue
                    lanes = ca * cb
                    for lane0 in range(0, lanes, self.chunk):
                        with _telemetry.leaf("engine.chunk"):
                            self._count_chunk()
                            cnt = min(self.chunk, lanes - lane0)
                            S, cand, A, ev, cc = _eval_dpsize_chunk(
                                self.all_sets, self.level_off[a],
                                self.level_off[b], cb, lane0 // cb,
                                lane0 % cb, cnt, self.dg, self.memo_cost,
                                self.memo_rows, nmax=self.nmax,
                                chunk=self.chunk)
                            _telemetry.count("engine.eval_chunks")
                            with _telemetry.span("engine.fetch"):
                                got = torch.cat([S, cand.view(_I32), A,
                                                 ev.reshape(1),
                                                 cc.reshape(1)]).cpu().numpy()
                            c = self.chunk
                            cn = got[c: 2 * c].view(np.float32)
                            fin = np.isfinite(cn)
                            self._count(got[3 * c:], got[3 * c + 1:])
                            s_all.append(got[:c][fin])
                            c_all.append(cn[fin])
                            l_all.append(got[2 * c: 3 * c][fin])
                if s_all:
                    ss = np.concatenate(s_all).astype(np.int64)
                    scratch_c = np.full(1 << self.n, INF, np.float32)
                    scratch_l = np.zeros(1 << self.n, np.int32)
                    _merge_scattered(scratch_c, scratch_l, ss,
                                     np.concatenate(c_all),
                                     np.concatenate(l_all))
                    ks = np.flatnonzero(
                        np.isfinite(scratch_c)).astype(np.int32)
                    self._scatter(ks, cost=scratch_c[ks],
                                  left=scratch_l[ks])

    # ------------------------------------------------------------ finish ---
    def _plan_lefts(self, full: int) -> dict[int, int]:
        """``memo_left`` at the sets the best plan walks, fetched one plan
        depth per copy (at most n copies) instead of the whole table."""
        lefts: dict[int, int] = {}
        frontier = [full]
        while frontier:
            got = self.memo_left[self._dev(np.array(frontier, np.int64))]
            nxt = []
            for s, lb in zip(frontier, got.cpu().tolist()):
                lefts[s] = lb
                if lb == 0 or (lb & s) != lb:
                    continue                       # extract_plan raises here
                nxt += [x for x in (lb, s & ~lb) if x & (x - 1)]
            frontier = nxt
        return lefts

    def result(self, algorithm: str, t0: float) -> OptimizeResult:
        full = self.g.full_set
        got = torch.cat([self.memo_cost[full: full + 1].view(_I32),
                         *self._fold.pending()]).cpu().numpy()
        self._fold.settle(got[1:], [self.counters])
        cost = float(got[:1].view(np.float32)[0])
        if np.isfinite(cost):
            p = extract_plan(full, self._plan_lefts(full), self.g)
            return OptimizeResult(plan=p, cost=cost, counters=self.counters,
                                  algorithm=algorithm,
                                  wall_s=time.perf_counter() - t0,
                                  levels=self.n)
        if self.degraded is None:
            raise RuntimeError("no plan found — disconnected graph?")
        # deadline expired before the full set was memoized: stitch the
        # committed memo levels with a GOO completion (anytime contract)
        from ..heuristics.idp import stitch_partial_memo
        size = 1 << self.n
        p, c, dinfo = stitch_partial_memo(
            self.g, self.memo_cost[:size].cpu().numpy(),
            self.memo_left[:size].cpu().numpy())
        r = OptimizeResult(plan=p, cost=c, counters=self.counters,
                           algorithm=algorithm,
                           wall_s=time.perf_counter() - t0,
                           levels=self.degraded["levels_done"])
        r.info["degraded"] = {**self.degraded, **dinfo}
        return r


def optimize(g: JoinGraph, algorithm=UNSET, chunk=UNSET, cyc_cap=UNSET,
             enum=UNSET, lattice_devices=UNSET, lattice_mesh=UNSET, *,
             config: OptimizerConfig | None = None,
             device=None) -> OptimizeResult:
    """Exact join-order optimization of one query.

    Same signature and results as the reference ``optimize`` (cost, plan,
    ``Counters``, ``algorithm``), plus ``device``: where the DP runs,
    ``cuda`` by default (raises without a card; pass ``device="cpu"`` for
    the plain PyTorch versions).  ``algorithm`` in {auto, mpdp, mpdp_tree,
    mpdp_general, dpsub, dpsize, dpccp}; ``enum`` in {unrank (paper
    Alg.5), expand (frontier growth)}.  Typed graphs run under every
    algorithm but ``dpsize``, which raises ``ValueError`` as the
    reference's does.  ``config.deadline_s`` bounds the run
    cooperatively: past it the result is a stitched best-effort plan with
    ``info["degraded"]`` (``dpccp``, on the host, has no deadline).  With
    ``config.lattice=True`` the query's lane space is sharded over the
    config's ``devices``/``mesh`` (``core.lattice``), for the dpsub,
    mpdp_tree and mpdp_general lane spaces; ``lattice_devices=`` and
    ``lattice_mesh=`` are the deprecated spelling of ``devices``/``mesh``
    plus ``lattice=True``.
    """
    devices = mesh = lattice = UNSET
    if lattice_devices is not UNSET or lattice_mesh is not UNSET:
        devices = alias_kwarg(UNSET, lattice_devices,
                              "lattice_devices", "config.devices")
        mesh = alias_kwarg(UNSET, lattice_mesh, "lattice_mesh", "config.mesh")
        # the old kwargs passed None to mean "no lattice": preserve that
        if (devices is not UNSET and devices is not None) or \
                (mesh is not UNSET and mesh is not None):
            lattice = True
    cfg = resolve_config(config, algorithm=algorithm, chunk=chunk,
                         cyc_cap=cyc_cap, enum=enum, devices=devices,
                         mesh=mesh, lattice=lattice)
    if cfg.lattice:
        from . import lattice as _lattice
        return _lattice.optimize_lattice(g, config=cfg.replace(lattice=False),
                                         device=device)
    dev = resolve_device(device)
    algorithm = cfg.algorithm
    if algorithm == "dpccp":
        return _dpccp.solve(g)
    if g.n == 1:
        p = leaf_plan(0, g)
        return OptimizeResult(plan=p, cost=p.cost, counters=Counters(),
                              algorithm=algorithm, levels=1)
    t0 = time.perf_counter()
    algo = algorithm
    if algorithm in ("auto", "mpdp"):
        algo = "mpdp_tree" if g.is_tree() else "mpdp_general"
    runs = {"mpdp_tree": "run_mpdp_tree", "mpdp_general": "run_mpdp_general",
            "dpsub": "run_dpsub", "dpsize": "run_dpsize"}
    if algo not in runs:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    eng = ExactEngine(g, chunk=cfg.chunk, cyc_cap=cfg.cyc_cap, enum=cfg.enum,
                      deadline_s=cfg.deadline_s, device=dev)
    getattr(eng, runs[algo])()
    res = eng.result(algo, t0)
    res.timings = dict(eng.timings)
    return res


def optimize_many(graphs, algorithm=UNSET, chunk=UNSET, cache=UNSET,
                  max_flight=UNSET, devices=UNSET, mesh=UNSET,
                  pipeline=UNSET, max_batch=UNSET, policy=UNSET, *,
                  config: OptimizerConfig | None = None, device=None):
    """Batched multi-query optimization — see ``batch.optimize_many``."""
    from . import batch as _batch
    max_flight = alias_kwarg(max_flight, max_batch, "max_batch", "max_flight")
    cfg = resolve_config(config, algorithm=algorithm, chunk=chunk,
                         cache=cache, max_flight=max_flight, devices=devices,
                         mesh=mesh, pipeline=pipeline, policy=policy)
    return _batch.optimize_many(graphs, config=cfg, device=device)
