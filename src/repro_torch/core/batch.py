"""Batched multi-query MPDP: B queries through one level-synchronous DP.

The port of ``repro.core.batch``.  ``BatchEngine`` stacks B queries into
one (NMAX, CHUNK) bucket and folds the batch into the *lane* dimension of
the unrank -> filter -> evaluate -> prune -> scatter pipeline:

  * ``adj`` becomes ``(bcap, NMAX)`` and the dense memo tables one flat
    ``(bcap << NMAX)`` buffer per table (query q owns
    ``[q << NMAX, (q+1) << NMAX)``), all on the engine's torch device;
  * each DP level concatenates every query's lane space; a lane decodes its
    query id with a searchsorted over per-query lane offsets;
  * pruning is one segment-min per (query, set) segment.

Lane spaces: DPSUB (``sets x 2^i``), MPDP:Tree (``sets x m``) and
MPDP-general (block prefix-sum over phase-A (set, block) pairs); all three
enumerate the same CCP candidates.  The per-lane bit-twiddling goes
through ``kernels.ops`` — the CUDA kernels on the card, their plain
PyTorch versions for CPU tensors; the filter's unrank
(``bconnectivity_span``, one launch per level) runs inside its kernel,
and the evaluate chunks run the chunk layer's bodies
(``chunks._beval_dpsub_chunk``, ``_beval_tree_chunk``,
``_beval_general_chunk``: the lane decodes, and for an inner-join
flight's MPDP:Tree and MPDP-general chunks the cost, prune and counts
too, in the kernels).  Those fused chunks fold on the device
(``chunks.DeviceFold``: one key buffer a level, one ``ops.commit_keys``
launch to commit it, the counts fetched with the memo in ``collect``);
typed and DPSUB chunks are read back and folded by
``chunks.ChunkResults``.  The memo tensors are updated in place.

The level loop (``_LevelLoop``) is the reference's: the synchronous driver,
or with ``pipeline=True`` the pipelined one, which dispatches level i's
evaluate and, while it runs, fetches and compacts level i+1's filter,
costs its memo rows and (MPDP-general) runs its phase A.  On the card the
level i+1 work runs on a second CUDA stream (``_Streams``), so its host
syncs wait for its own kernels only and not for level i's evaluate on the
caller's stream; on the CPU the same schedule runs in program order.
Chunk grids, kernels and merge order are those of the synchronous driver,
so results are bit-identical.

Both drivers honour a cooperative ``deadline_s``: the clock
(``faults.now``) is read once when ``run_levels`` starts and once at the
top of every level; past the deadline the remaining levels are abandoned
and ``collect`` stitches a best-effort plan for each unfinished query from
the committed memo levels (``heuristics.idp.stitch_partial_memo``), with
``info["degraded"]`` saying why.  Each device dispatch (a filter span or
an evaluate chunk) passes the ``"chunk"`` fault site.

Typed queries (a LEFT, FULL, SEMI or ANTI edge) fly apart from inner ones
(``bucket_pending`` keys on ``typed``); a typed flight carries the stacked
``(bcap, emax)`` conflict arrays, and its chunk bodies cost both operand
orientations of each lane under the conflict mask
(``chunks._typed_lane_cost``).  Inner-only flights carry none and run
exactly as before.

``mode="drop"`` scatters drop their padding explicitly
(``chunks._scatter_into``).

``optimize_many`` is the public entry point.  It consults an optional
``plancache.PlanCache`` first, batches queries with ``nmax_bucket(n) <=
16`` and sends the rest (larger queries, ``dpsize``, ``dpccp``,
``mpdp_tree`` forced on a cyclic graph) to the solo ``engine.optimize``,
as the reference does, under one stream-wide deadline and an optional
learned ``policy.PolicyTable``.  With ``devices=`` or ``mesh=`` each
flight is dealt over the shards of a ``shard.DeviceMesh``
(``shard.ShardedBatchEngine``), and the queries too big for a batched
flight run on the intra-query lattice (``lattice.LatticeShardedEngine``)
instead of the solo engine.  The stream-admission steps
(``probe_stream``, ``dedup_pending``, ``bucket_pending``,
``lattice_pending``, ``resolve_deferred``) are shared with
``core.service``.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from math import comb

import numpy as np
import torch

from . import bitset as bs
from . import blocks as bl
from . import chunks as _ch
from . import cost as cm
from . import engine as _eng
from . import faults
from . import telemetry as _telemetry
from . import unrank as ur
from ..kernels import ops
from .chunks import (_CLIP, _I32, INF, ChunkResults, DeviceFold, _LevelHooks,
                     _cap, _offset_rows, _pair_offsets, _pair_window,
                     _scatter_into)
from .config import (CHUNK, CYC_CAP_DEFAULT, UNSET, OptimizerConfig,
                     alias_kwarg, resolve_config)
from .engine import SPAN, resolve_device
from .joingraph import JoinGraph, typed_edge_arrays
from .plancache import canonical_signature
from .plan import Counters, OptimizeResult, extract_plan, leaf_plan

NMAX_BATCH = 16          # memo is (bcap << NMAX): larger queries go solo
PEND_WINDOW = 8          # un-fetched chunk results kept in flight per level


def _bcap(b: int) -> int:
    return _cap(b, 4)


# ============================================================== host driver ==

class _Streams:
    """The pipelined level loop's CUDA streams, a pair for each card the
    engine's shards live on: ``main``, the caller's current stream there,
    runs the evaluate chunks and the commits; ``side`` runs the next
    level's filter, its compaction, its memo-row and ``all_sets``
    registration and its phase A.  On the CPU there is no stream:
    ``side_work()`` enters nothing and the joins do nothing.

    Every tensor that the side-stream work allocates (the filter spans'
    ``(S, conn, qid)``, the uploads of ``_dev`` and ``_scatter_into``,
    phase A's inputs and scratch) is allocated while ``side`` is current,
    so the caching allocator orders its reuse on ``side``, the stream that
    reads it; nothing allocated there is read on ``main``, which gets the
    level's sets as numpy arrays.  The tensors ``main`` allocated and
    ``side`` reads (the memo, ``all_sets``, the adjacency and edge tables)
    live as long as the engine, and ``main`` joins ``side`` before
    ``run_levels`` returns or raises, so no side-stream write is pending
    when the engine's tensors go back to the allocator."""

    def __init__(self, devices):
        self.pairs = []
        for dev in dict.fromkeys(devices):           # distinct, in order
            if dev.type == "cuda":
                main = torch.cuda.current_stream(dev)
                side = torch.cuda.Stream(dev)
                side.wait_stream(main)               # the memo's initial writes
                self.pairs.append((main, side))

    def side_work(self):
        stack = contextlib.ExitStack()
        for _, side in self.pairs:
            stack.enter_context(torch.cuda.stream(side))
        return stack

    def join(self) -> None:
        """Order everything queued on each ``main`` from here after the
        side work queued so far."""
        for main, side in self.pairs:
            main.wait_stream(side)


class _LevelLoop(_LevelHooks):
    """The level-loop drivers of the batched engine: the synchronous loop
    and the reference's pipelined rotation (ref ``batch.py:343-401``),
    over the engine's per-level hooks (``_filter_dispatch`` /
    ``_filter_collect``, ``_register_level``, ``_pairs_level``,
    ``_eval[_general]_dispatch`` / ``_eval_finalize``).

    Both drivers honour the engine's ``deadline_s`` (``_LevelHooks``):
    ``faults.now`` is read once when ``run_levels`` starts and once at the
    top of every level, as in the reference, so a fake clock expires both
    packages at the same level."""

    @staticmethod
    def _use_pipeline() -> bool:
        """``REPRO_PIPELINE=1`` makes the engines run pipelined when the
        caller passes ``pipeline=None`` (the reference's switch, by the
        same name): level i's evaluate runs on the device while the host
        compacts, rows-costs and block-decomposes level i+1.  Results are
        bit-identical to the synchronous default."""
        return os.environ.get("REPRO_PIPELINE", "0") == "1"

    def run_levels(self) -> None:
        """Run the level-synchronous DP; the memo stays on the device
        (``collect`` fetches it).  The pipelined driver gives bit-identical
        memo contents: same chunk grids, same kernels, same merge order."""
        t0 = time.perf_counter()
        max_n = max(g.n for g in self.graphs)
        general = self.algorithm == "mpdp_general"
        self._arm_deadline()
        if self.pipeline:
            self._run_levels_pipelined(max_n, general)
        else:
            for i in range(2, max_n + 1):
                if self._expired(i, max_n):
                    break
                sets = self._filter_collect(self._filter_dispatch(i))
                self._register_level(i, sets)
                if general:
                    ctx = self._eval_general_dispatch(
                        i, sets, self._pairs_level(sets))
                else:
                    ctx = self._eval_dispatch(i, sets)
                self._eval_finalize(i, sets, ctx)
        self._wall += time.perf_counter() - t0

    def _run_levels_pipelined(self, max_n: int, general: bool) -> None:
        """Pipelined level loop.  Per level i:

          1. dispatch level i+1's (memo-independent) filter first (side);
          2. dispatch level i's evaluate chunks, the bulk of the device
             work (main);
          3. while they run, fetch and compact the filter, cost the new
             sets' rows, register them and run phase A (side): the host
             syncs here wait for side-stream kernels only;
          4. only then drain level i's chunks, merge and commit (main), and
             order main's next work after the side work (``join``).

        Level i+1's registration writes ``memo_rows`` at level-(i+1) sets
        and ``all_sets`` past level i's slots while level i's evaluate
        reads them.  A live lane of level i reads ``memo_rows`` and
        ``memo_cost`` only at sets of levels <= i and ``all_sets`` only at
        level i's offsets (``_level_off``), so the two never touch the same
        entry.  A dead lane (past the chunk's last live lane) may read a
        slot being written; its ccp flag is masked by the live test in the
        kernel, so its cost is ``INF`` and it cannot win or tie a finite
        segment minimum, and no ``INF`` segment is committed.

        A level that raises (an injected ``chunk`` fault, a failed launch)
        leaves the loop without its ``join``; the ``finally`` joins, so
        main's later work, and a later engine that gets this engine's
        memory back from the allocator, is ordered after every pending
        side-stream write.  A deadline breaks at the top of a level, after
        the join.
        """
        st = _Streams(self._devices())
        try:
            with st.side_work():
                sets = self._filter_collect(self._filter_dispatch(2))
                self._register_level(2, sets)
                pairs = self._pairs_level(sets) if general else None
            st.join()
            for i in range(2, max_n + 1):
                if self._expired(i, max_n):
                    break
                fpend = None
                if i < max_n:
                    with st.side_work():
                        fpend = self._filter_dispatch(i + 1)
                if general:
                    ctx = self._eval_general_dispatch(i, sets, pairs)
                else:
                    ctx = self._eval_dispatch(i, sets)
                nxt = nxt_pairs = None
                if fpend is not None:
                    with st.side_work():
                        nxt = self._filter_collect(fpend)
                        self._register_level(i + 1, nxt)
                        if general:
                            nxt_pairs = self._pairs_level(nxt)
                self._eval_finalize(i, sets, ctx)
                st.join()               # level i+1's evaluate reads its rows
                sets, pairs = nxt, nxt_pairs
        finally:
            st.join()

    @property
    def stats(self) -> dict:
        """Kernel launches made since this engine was built, per kernel
        (``{"launches": {...}, "pipeline": bool}``)."""
        return {"launches": {k: ops.LAUNCHES[k] - self._launch0[k]
                             for k in ops.LAUNCHES},
                "pipeline": self.pipeline}

    def _devices(self) -> list[torch.device]:
        """The devices the engine's tensors live on."""
        return [self.device]

    def run(self) -> list[OptimizeResult]:
        self.run_levels()
        return self.collect()


class BatchEngine(_LevelLoop):
    """Level-synchronous DP over a batch of queries in one device pipeline.

    ``algorithm`` selects the evaluate lane space: ``dpsub``, ``mpdp_tree``
    (every query acyclic) or ``mpdp_general``; all three give the same
    costs and plans, only the evaluated-lane counts differ.  ``device`` is
    where the memo and every lane tensor live (``cuda`` by default).  A
    flight with a typed query carries the stacked conflict arrays
    (``typed``); an inner-only one carries none.

    ``pipeline`` (default: the ``REPRO_PIPELINE`` environment flag) runs
    the pipelined level loop, on a second CUDA stream on the card.
    ``pend_window`` is the number of un-fetched filter spans and evaluate
    chunks a level keeps in flight (default ``PEND_WINDOW``); results are
    bit-identical for any ``pend_window >= 0``.  ``deadline_s`` is the
    cooperative deadline (``None``: no checks).  ``layout`` fixes the
    ``(nmax, bcap, emax)`` of the stacked tables instead of deriving them
    from ``graphs``: the shards of a ``shard.ShardedBatchEngine`` share
    one layout.
    """

    def __init__(self, graphs: list[JoinGraph], chunk: int = CHUNK,
                 algorithm: str = "dpsub", cyc_cap: int = CYC_CAP_DEFAULT,
                 pipeline: bool | None = None,
                 pend_window: int | None = None,
                 deadline_s: float | None = None, device=None,
                 layout: tuple[int, int, int] | None = None):
        if not graphs:
            raise ValueError("empty batch")
        if algorithm not in ("dpsub", "mpdp_tree", "mpdp_general"):
            raise ValueError(f"unknown batched lane space {algorithm!r}")
        for g in graphs:
            if g.n < 2:
                raise ValueError("BatchEngine needs n >= 2 (leaf queries are "
                                 "handled by optimize_many)")
            if not g.is_connected():
                raise ValueError("query graph must be connected (no cross products)")
            if algorithm == "mpdp_tree" and not g.is_tree():
                raise ValueError("mpdp_tree lane space needs acyclic queries")
        self.device = resolve_device(device)
        self.graphs = graphs
        self.algorithm = algorithm
        self.cyc_cap = cyc_cap
        self.pipeline = (self._use_pipeline() if pipeline is None
                         else bool(pipeline))
        self.pend_window = (PEND_WINDOW if pend_window is None
                            else int(pend_window))
        self.deadline_s = deadline_s
        self._deadline_at: float | None = None
        self.degraded: dict | None = None
        self.chunks_dispatched = 0        # filter spans + evaluate chunks
        self._wall = 0.0
        self.B = len(graphs)
        if layout is None:
            max_m = max(g.m for g in graphs)
            layout = (max(bs.nmax_bucket(g.n) for g in graphs), _bcap(self.B),
                      max(8, int(np.ceil(max(max_m, 1) / 8.0)) * 8))
        self.nmax, self.bcap, self.emax = layout
        if self.nmax > NMAX_BATCH:
            raise ValueError(f"batched path supports nmax <= {NMAX_BATCH}")
        self.chunk = chunk
        self.size = 1 << self.nmax
        self.flat = self.bcap << self.nmax
        self.binom = self._dev(ur.binom_table(self.nmax))
        adj = np.zeros((self.bcap, self.nmax), np.int32)
        for q, g in enumerate(graphs):
            for (u, v) in g.edges:
                adj[q, u] |= 1 << v
                adj[q, v] |= 1 << u
        self.adj_b = self._dev(adj)
        # per-query edge arrays: endpoint bitmaps (tree lane decode) and
        # endpoint indices (general phase A), stacked on a shared EMAX bucket
        emu = np.zeros((self.bcap, self.emax), np.int32)
        emv = np.zeros((self.bcap, self.emax), np.int32)
        eui = np.full((self.bcap, self.emax), -1, np.int32)
        evi = np.full((self.bcap, self.emax), -1, np.int32)
        eliv = np.zeros((self.bcap, self.emax), bool)
        for q, g in enumerate(graphs):
            for i, (u, v) in enumerate(g.edges):
                emu[q, i] = 1 << u
                emv[q, i] = 1 << v
                eui[q, i], evi[q, i], eliv[q, i] = u, v, True
        self.emu_b = self._dev(emu)
        self.emv_b = self._dev(emv)
        self.eu_idx_b = self._dev(eui)
        self.ev_idx_b = self._dev(evi)
        self.edge_live_b = self._dev(eliv)
        # typed-edge conflict arrays, stacked (bcap, emax): kind, operand
        # masks, TES bitmaps, passed to the chunk bodies as ``targs``; an
        # inner-only flight passes none
        self.typed = any(g.typed for g in graphs)
        self._tkw = {}
        if self.typed:
            tarr = np.zeros((5, self.bcap, self.emax), np.int32)
            for q, g in enumerate(graphs):
                tarr[:, q] = typed_edge_arrays(g, self.emax)
            self._tkw = {"targs": tuple(self._dev(a) for a in tarr)}
        self.m_b = self._dev(np.array(
            [g.m for g in graphs] + [0] * (self.bcap - self.B), np.int32))
        self.counters = [Counters() for _ in graphs]
        self.timings: dict[str, float] = {}
        self._launch0 = dict(ops.LAUNCHES)
        self._fold = DeviceFold(self.bcap, self.device)
        self._fold_here = _ch._folds(algorithm, self._tkw.get("targs"))
        self._init_memo()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- memo ----
    def _init_memo(self):
        kw = dict(device=self.device)
        self.memo_cost = torch.full((self.flat,), float(INF), dtype=torch.float32, **kw)
        self.memo_rows = torch.zeros(self.flat, dtype=torch.float32, **kw)
        self.memo_left = torch.zeros(self.flat, dtype=_I32, **kw)
        self.all_sets = torch.zeros(self.flat, dtype=_I32, **kw)
        self._next_off = [g.n for g in self.graphs]
        self._level_off = [{1: 0} for _ in self.graphs]
        idx_l, cost_l, rows_l, pos_l, set_l = [], [], [], [], []
        for q, g in enumerate(self.graphs):
            leaves = np.array([1 << v for v in range(g.n)], np.int32)
            lrows = g.log2_card.astype(np.float32)
            base = q << self.nmax
            idx_l.append(base + leaves.astype(np.int64))
            cost_l.append(cm.np_scan_cost(lrows).astype(np.float32))
            rows_l.append(lrows)
            pos_l.append(base + np.arange(g.n, dtype=np.int64))
            set_l.append(leaves)
        self._scatter(np.concatenate(idx_l), cost=np.concatenate(cost_l),
                      rows=np.concatenate(rows_l))
        self._set_all_sets(np.concatenate(pos_l), np.concatenate(set_l))

    def _scatter(self, idx_np, cost=None, rows=None, left=None):
        """Memo writes at flat indices; indices past the memo are dropped
        (the reference's ``mode="drop"``)."""
        for buf, val in ((self.memo_cost, cost), (self.memo_rows, rows),
                         (self.memo_left, left)):
            if val is not None:
                _scatter_into(buf, idx_np, val)

    def _set_all_sets(self, pos_np, sets_np):
        _scatter_into(self.all_sets, pos_np, sets_np)

    # ------------------------------------------------------------ filter ---
    def _filter_dispatch(self, i: int) -> dict:
        """Dispatch level i's unrank+filter: one ``bconnectivity_span``
        launch per ``SPAN`` ranks of the flight's level (one launch at nmax
        <= 16, bcap <= 32: at most 32 x C(16, 8) ranks), draining all but
        ``pend_window`` of them as newer ones run.  The final fetch is
        ``_filter_collect``'s, so the pipelined driver can run it under the
        previous level's evaluate.  Each launch passes the ``"chunk"``
        fault site."""
        with _telemetry.stage(self.timings, "filter"):
            ctx = self._filter_begin(i)
            for lane0 in range(0, ctx["total"], SPAN):
                self._filter_step(ctx, i, lane0)
                faults.fire("chunk")
                self._count_chunk()
                self._filter_drain(ctx, self.pend_window)
        return ctx

    def _filter_begin(self, i: int) -> dict:
        """Level i's filter context: the flight's rank prefix and total."""
        totals = np.array([comb(g.n, i) if g.n >= i else 0
                           for g in self.graphs], np.int64)
        foff = np.zeros(self.B + 1, np.int64)
        np.cumsum(totals, out=foff[1:])
        return {"pend": deque(), "per_q": [[] for _ in range(self.B)],
                "foff": foff, "total": int(foff[-1])}

    def _filter_step(self, ctx: dict, i: int, lane0: int) -> None:
        """Launch the filter span at rank ``lane0`` of the level."""
        foff, total = ctx["foff"], ctx["total"]
        fl = np.clip(foff - lane0, -_CLIP, _CLIP)
        fpad = np.full(self.bcap + 1, fl[self.B], np.int32)
        fpad[: self.B + 1] = fl
        ctx["pend"].append(ops.bconnectivity_span(
            i, self._dev(fpad), min(SPAN, total - lane0), self.binom,
            self.adj_b, self.nmax))

    def _filter_drain(self, ctx: dict, limit: int) -> None:
        """Compact pending filter spans on the device and fetch them, down
        to ``limit``; lane order is rank order within each query."""
        pend, per_q = ctx["pend"], ctx["per_q"]
        while len(pend) > limit:
            S, conn, qid = pend.popleft()
            keep = conn != 0
            with _telemetry.span("engine.fetch"):
                got = torch.stack([S[keep], qid[keep]]).cpu().numpy()
            Sc, qc = got[0], got[1]
            for q in np.unique(qc):
                per_q[q].append(Sc[qc == q])

    def _filter_collect(self, ctx: dict) -> list[np.ndarray]:
        """Drain the remaining filter chunks into per-query set lists."""
        with _telemetry.stage(self.timings, "filter"):
            self._filter_drain(ctx, 0)
            sets_by_q = [np.concatenate(l) if l else np.zeros(0, np.int32)
                         for l in ctx["per_q"]]
        return sets_by_q

    def _register_level(self, i: int, sets_by_q: list[np.ndarray]) -> None:
        """Host rows (canonical helper) + all_sets/memo_rows registration."""
        with _telemetry.stage(self.timings, "filter"):
            idx_l, rows_l, pos_l, set_l = [], [], [], []
            for q, sets_q in enumerate(sets_by_q):
                self._level_off[q][i] = self._next_off[q]
                if not len(sets_q):
                    continue
                base = q << self.nmax
                idx_l.append(base + sets_q.astype(np.int64))
                rows_l.append(cm.np_rows_for_sets(sets_q, self.graphs[q]))
                pos_l.append(base + self._next_off[q]
                             + np.arange(len(sets_q), dtype=np.int64))
                set_l.append(sets_q)
                self._next_off[q] += len(sets_q)
            if idx_l:
                self._scatter(np.concatenate(idx_l),
                              rows=np.concatenate(rows_l))
                self._set_all_sets(np.concatenate(pos_l),
                                   np.concatenate(set_l))

    # ---------------------------------------------------------- evaluate ---
    def _memo_index(self, sets_by_q: list[np.ndarray]) -> np.ndarray:
        """The flat memo index ``(q << nmax) | S`` of each of the level's
        sets, in the level's set order (query by query)."""
        return np.concatenate([(q << self.nmax) + s.astype(np.int64)
                               for q, s in enumerate(sets_by_q)])

    def _level_acc(self, sets_by_q, slack: int, pairs=None):
        """The level's accumulator: the device fold (``DeviceFold``, its
        keys one a set, or with ``pairs`` one a (set, block) pair) for
        fused chunks, else ``ChunkResults``."""
        if not self._fold_here:
            return ChunkResults(sum(len(s) for s in sets_by_q), self.B,
                                None if pairs is None else pairs[3],
                                idx=self._memo_index(sets_by_q))
        if pairs is None:
            return self._fold.level(self._memo_index(sets_by_q), slack)
        ps, _, pq, _ = pairs
        return self._fold.level((pq.astype(np.int64) << self.nmax) | ps,
                                slack)

    def _eval_dispatch(self, i: int, sets_by_q: list[np.ndarray]):
        """Segmented lane spaces (DPSUB ``sets x 2^i``, tree ``sets x m``):
        lanes of query q are contiguous, ``ns_q * mult_q`` long."""
        t0 = time.perf_counter_ns()
        ctx = self._eval_begin(i, sets_by_q)
        if ctx is None:
            return None
        with _telemetry.stage(self.timings, "evaluate", t0):
            for j in range(len(ctx["lane0s"])):
                with _telemetry.leaf("engine.chunk"):
                    self._eval_step(ctx, i, j)
                    faults.fire("chunk")
                    self._count_chunk()
                    ctx["acc"].drain(self.pend_window)
        return ctx

    def _eval_begin(self, i: int, sets_by_q: list[np.ndarray]):
        """Level i's evaluate context (offset tables on the device, the
        chunk grid, the accumulator), or None when the level has no lane."""
        ns = np.array([len(s) for s in sets_by_q], np.int64)
        if self.algorithm == "mpdp_tree":
            mult = np.array([g.m for g in self.graphs], np.int64)
        else:
            mult = np.full(self.B, np.int64(1) << i, np.int64)
        eoff = np.zeros(self.B + 1, np.int64)
        np.cumsum(ns * mult, out=eoff[1:])
        total = int(eoff[-1])
        if total == 0:
            return None
        soff = np.zeros(self.B + 1, np.int64)
        np.cumsum(ns, out=soff[1:])
        loff = np.zeros(self.bcap, np.int64)
        for q in range(self.B):
            loff[q] = (q << self.nmax) + self._level_off[q][i]
        loff_d = self._dev(loff.astype(np.int32))
        spad = np.full(self.bcap, soff[self.B], np.int64)
        spad[: self.B] = soff[: self.B]
        soff_d = self._dev(spad.astype(np.int32))
        lane0s = np.arange(0, total, self.chunk, dtype=np.int64)
        return {"acc": self._level_acc(sets_by_q, self.chunk + 2),
                "eoff": eoff, "soff": soff, "mult": mult, "lane0s": lane0s,
                "eoff_d": self._dev(_offset_rows(eoff, lane0s, self.bcap)),
                "loff_d": loff_d, "soff_d": soff_d}

    def _eval_step(self, ctx: dict, i: int, j: int) -> None:
        """Launch the level's evaluate chunk j."""
        eoff, soff, mult = ctx["eoff"], ctx["soff"], ctx["mult"]
        lane0 = int(ctx["lane0s"][j])
        p0 = int(np.searchsorted(eoff, lane0, side="right")) - 1
        p0 = min(max(p0, 0), self.B - 1)
        seg0 = int(soff[p0] + (lane0 - eoff[p0]) // mult[p0])
        statics = dict(nmax=self.nmax, chunk=self.chunk, nseg=self.chunk + 2,
                       bcap=self.bcap)
        if self.algorithm == "mpdp_tree":
            out = _ch._beval_tree_chunk(
                self.all_sets, ctx["eoff_d"][j], ctx["loff_d"],
                ctx["soff_d"], seg0, self.m_b, self.adj_b, self.emu_b,
                self.emv_b, self.memo_cost, self.memo_rows, **self._tkw,
                **statics, **ctx["acc"].into(seg0))
        else:
            out = _ch._beval_dpsub_chunk(
                self.all_sets, ctx["eoff_d"][j], ctx["loff_d"],
                ctx["soff_d"], seg0, i, self.adj_b, self.memo_cost,
                self.memo_rows, **self._tkw, **statics)
        ctx["acc"].add(seg0, out)

    def _eval_finalize(self, i: int, sets_by_q: list[np.ndarray], ctx) -> None:
        """Commit the level's best (cost, left) per set to the memo (either
        lane space): on the device, or after draining the remaining chunk
        results, whose counts then go to ``counters``."""
        if ctx is None:
            return
        with _telemetry.stage(self.timings, "evaluate"):
            got = ctx["acc"].commit(self.memo_cost, self.memo_left)
            if got is not None:
                ev, ccp = got
                for q in range(self.B):
                    self.counters[q].evaluated += int(ev[q])
                    self.counters[q].ccp += int(ccp[q])

    # ------------------------------------------------- MPDP-general phase --
    def _pairs_level(self, sets_by_q: list[np.ndarray]):
        """Phase A per query, fused into global (set, block, qid, segment)
        pair arrays."""
        with _telemetry.stage(self.timings, "blocks"):
            soff = 0
            ps_l, pb_l, pq_l, pk_l = [], [], [], []
            for q, sets_q in enumerate(sets_by_q):
                if not len(sets_q):
                    continue
                ps_q, pb_q = bl.np_pairs_for_sets(
                    sets_q, self.graphs[q], self.adj_b[q], self.eu_idx_b[q],
                    self.ev_idx_b[q], self.edge_live_b[q],
                    nmax=self.nmax, emax=self.emax, cyc_cap=self.cyc_cap)
                ps_l.append(ps_q)
                pb_l.append(pb_q)
                pq_l.append(np.full(len(ps_q), q, np.int32))
                # sets_q is ascending (colex rank order == ascending bitmap)
                pk_l.append(soff
                            + np.searchsorted(sets_q, ps_q).astype(np.int64))
                soff += len(sets_q)
        if not ps_l:
            z = np.zeros(0, np.int32)
            return z, z, z, np.zeros(0, np.int64)
        return (np.concatenate(ps_l), np.concatenate(pb_l),
                np.concatenate(pq_l), np.concatenate(pk_l))

    def _eval_general_dispatch(self, i: int, sets_by_q: list[np.ndarray], pairs):
        """Dispatch the level's block prefix-sum chunks over the fused pair
        arrays from ``_pairs_level``."""
        t0 = time.perf_counter_ns()
        ctx = self._eval_general_begin(sets_by_q, pairs)
        if ctx is None:
            return None
        with _telemetry.stage(self.timings, "evaluate", t0):
            for lane0 in range(0, ctx["total"], self.chunk):
                with _telemetry.leaf("engine.chunk"):
                    self._eval_general_step(ctx, lane0)
                    faults.fire("chunk")
                    self._count_chunk()
                    ctx["acc"].drain(self.pend_window)
        return ctx

    def _eval_general_begin(self, sets_by_q: list[np.ndarray], pairs):
        """The level's block prefix-sum context, or None without pairs."""
        ps, pb, pq, pk = pairs
        if not len(ps):
            return None
        offs = _pair_offsets(pb)
        return {"acc": self._level_acc(sets_by_q, _cap(self.chunk, 256),
                                       pairs),
                "pairs": pairs, "offs": offs, "total": int(offs[-1])}

    def _eval_general_step(self, ctx: dict, lane0: int) -> None:
        """Launch the level's MPDP-general chunk at lane ``lane0``."""
        ps, pb, pq, _ = ctx["pairs"]
        lane1 = min(lane0 + self.chunk, ctx["total"])
        p0, npair, pairs = _pair_window(ps, pb, pq, ctx["offs"], lane0, lane1)
        ctx["acc"].add((p0, npair), _ch._beval_general_chunk(
            self._dev(pairs), npair, lane1 - lane0, self.adj_b,
            self.memo_cost, self.memo_rows, nmax=self.nmax,
            chunk=self.chunk, bcap=self.bcap, **self._tkw,
            **ctx["acc"].into(p0)))

    # ------------------------------------------------------------ driver ---
    def _fetch_memo(self):
        """The memo's cost and left tables on the host, in one copy with
        the device fold's counts, which settle into ``counters``."""
        got = torch.cat([self.memo_cost.view(_I32), self.memo_left,
                         *self._fold.pending()]).cpu().numpy()
        self._fold.settle(got[2 * self.flat:], self.counters)
        return got[: self.flat].view(np.float32), got[self.flat: 2 * self.flat]

    def collect(self) -> list[OptimizeResult]:
        """Fetch the memo and extract one ``OptimizeResult`` per query (the
        streaming service defers this to after the next flight's
        ``run_levels``).  After a deadline, a query whose full set was not
        reached gets the stitched plan of its committed memo levels: the
        entries of later levels hold ``INF`` costs (their rows may be
        registered), which the stitch skips."""
        t0 = time.perf_counter()
        cost_all, left_all = self._fetch_memo()
        wall = self._wall + time.perf_counter() - t0
        out = []
        for q, g in enumerate(self.graphs):
            region = slice(q << self.nmax, (q + 1) << self.nmax)
            out.append(_memo_result(
                g, cost_all[region], left_all[region], self.counters[q],
                f"batch_{self.algorithm}", wall / self.B, self.degraded,
                self.timings, f"batch query {q}"))
        return out


def _memo_result(g, cost_q, left_q, counters, algorithm: str, wall_s: float,
                 degraded, timings, what: str) -> OptimizeResult:
    """One query's result from its fetched memo region (``cost_q``,
    ``left_q``, indexed by subset bitmap): the extracted plan when the full
    set is memoized, else after a deadline the stitched plan of the
    committed levels (later levels hold ``INF`` costs, which the stitch
    skips)."""
    cost = float(cost_q[g.full_set])
    if np.isfinite(cost):
        r = OptimizeResult(plan=extract_plan(g.full_set, left_q, g),
                           cost=cost, counters=counters, algorithm=algorithm,
                           wall_s=wall_s, levels=g.n)
    elif degraded is not None:
        from ..heuristics.idp import stitch_partial_memo
        p, c, dinfo = stitch_partial_memo(g, cost_q, left_q)
        r = OptimizeResult(plan=p, cost=c, counters=counters,
                           algorithm=algorithm, wall_s=wall_s,
                           levels=degraded["levels_done"])
        r.info["degraded"] = {**degraded, **dinfo}
    else:
        raise RuntimeError(f"no plan found for {what}")
    r.timings = dict(timings)
    return r


# ============================================================ public entry ==

def _lane_space(g: JoinGraph, algorithm: str) -> str | None:
    """Batched lane space for one query under the requested algorithm, or
    ``None`` when the reference sends the query to solo ``optimize``."""
    if algorithm in ("auto", "mpdp"):
        return "mpdp_tree" if g.is_tree() else "mpdp_general"
    if algorithm == "dpsub":
        return "dpsub"
    if algorithm == "mpdp_general":
        return "mpdp_general"
    if algorithm == "mpdp_tree":
        return "mpdp_tree" if g.is_tree() else None
    return None


# Stream-admission steps, shared verbatim by ``optimize_many`` and the
# streaming service (``core.service``): the service's bit-identity with
# ``optimize_many`` rests on both using exactly these.

def probe_stream(graphs, results, cache, algorithm: str) -> list[int]:
    """Upfront cache probe and single-relation short-circuit: fills hits
    and leaf plans into ``results`` (in place), returns the stream indices
    that still need an engine."""
    pending: list[int] = []
    for qi, g in enumerate(graphs):
        if results[qi] is not None:
            continue
        if cache is not None:
            hit = cache.get(g)
            if hit is not None:
                results[qi] = hit
                continue
        if g.n == 1:
            p = leaf_plan(0, g)
            results[qi] = OptimizeResult(plan=p, cost=p.cost,
                                         counters=Counters(),
                                         algorithm=algorithm, levels=1)
            continue
        pending.append(qi)
    return pending


def dedup_pending(graphs, pending: list[int], cache):
    """Intra-stream dedup (caching only): canonically-equal queries compute
    once; duplicates are deferred and resolve as cache hits after their
    representative lands.  Returns ``(kept, deferred, dup_rep)``."""
    if cache is None:
        return pending, [], {}
    rep_of: dict = {}
    kept: list[int] = []
    deferred: list[int] = []
    dup_rep: dict[int, int] = {}          # duplicate index -> representative
    for qi in pending:
        key, _ = canonical_signature(graphs[qi])
        if key in rep_of:
            deferred.append(qi)
            dup_rep[qi] = rep_of[key]
        else:
            rep_of[key] = qi
            kept.append(qi)
    return kept, deferred, dup_rep


def bucket_pending(graphs, pending: list[int], algorithm: str):
    """Admission grouping: (NMAX bucket, lane space, typed) -> stream
    indices.  Queries no batched space serves (forced ``mpdp_tree`` on a
    cyclic graph, ``nmax_bucket(n) > NMAX_BATCH``, a solo-only algorithm)
    come back in the solo list."""
    buckets: dict[tuple[int, str, bool], list[int]] = {}
    solo: list[int] = []
    for qi in pending:
        b = bs.nmax_bucket(graphs[qi].n)
        space = _lane_space(graphs[qi], algorithm)
        if space is not None and b <= NMAX_BATCH:
            buckets.setdefault((b, space, graphs[qi].typed), []).append(qi)
        else:
            solo.append(qi)
    return buckets, solo


def lattice_pending(graphs, solo: list[int], algorithm: str):
    """Split the solo list into lattice flights and true solos (mesh runs
    only): a query with a batched lane space, too big for the stacked
    batch memo (``nmax_bucket(n) > NMAX_BATCH``) and within the lattice
    cap runs on ``lattice.LatticeShardedEngine``.  Returns ``(lattice,
    rest)``, ``lattice`` a list of ``(stream index, lane space)``."""
    from .lattice import NMAX_LATTICE
    lattice: list[tuple[int, str]] = []
    rest: list[int] = []
    for qi in solo:
        g = graphs[qi]
        space = _lane_space(g, algorithm)
        if (space is not None and g.n >= 2
                and bs.nmax_bucket(g.n) > NMAX_BATCH and g.n <= NMAX_LATTICE):
            lattice.append((qi, space))
        else:
            rest.append(qi)
    return lattice, rest


def stream_mesh(cfg: OptimizerConfig, device: torch.device):
    """The ``shard.DeviceMesh`` of ``cfg.mesh`` or ``cfg.devices`` (on
    ``device``'s type), or None when the config names neither."""
    if cfg.mesh is None and cfg.devices is None:
        return None
    from .shard import batch_mesh
    return batch_mesh(cfg.mesh if cfg.mesh is not None else cfg.devices,
                      backend=device.type)


def resolve_deferred(graphs, results, cache, deferred, dup_rep) -> None:
    """Resolve deduped duplicates as cache hits (re-inserting the
    representative when a small LRU evicted it mid-stream)."""
    for qi in deferred:
        hit = cache.get(graphs[qi])
        if hit is None:
            rep = dup_rep[qi]
            cache.put(graphs[rep], results[rep])
            hit = cache.get(graphs[qi])
        results[qi] = hit


def policy_dispatch(policy, nmax: int, space: str, chunk: int):
    """A flight's (lane space, chunk, engine kwargs) under a learned
    ``policy.PolicyTable`` (or the static ones without it); shared by
    ``optimize_many`` and the streaming service."""
    run_space, run_chunk, kw = space, chunk, {}
    if policy is not None:
        dec = policy.choose(nmax, space, default_chunk=chunk,
                            default_pend=PEND_WINDOW)
        if dec.space is not None:
            run_space = dec.space
        if dec.chunk is not None:
            run_chunk = dec.chunk
        if dec.pend_window is not None:
            kw["pend_window"] = dec.pend_window
    return run_space, run_chunk, kw


def optimize_many(graphs: list[JoinGraph], algorithm=UNSET, chunk=UNSET,
                  cache=UNSET, max_flight=UNSET, devices=UNSET, mesh=UNSET,
                  pipeline=UNSET, max_batch=UNSET, policy=UNSET, *,
                  config: OptimizerConfig | None = None,
                  device=None) -> list[OptimizeResult]:
    """Optimize a stream of queries, batching compatible ones per device pass.

    Same signature and results as the reference ``optimize_many`` (cost,
    plan, ``Counters``, ``algorithm``), plus ``device``: where the DP runs,
    ``cuda`` by default (raises without a card; pass ``device="cpu"`` for
    the plain PyTorch versions).  ``algorithm`` in {auto, mpdp, dpsub,
    mpdp_tree, mpdp_general, dpsize, dpccp}; ``auto``/``mpdp`` run acyclic
    buckets in the MPDP:Tree lane space and the rest in MPDP-general.
    Queries no batched lane space serves run solo (``engine.optimize``).

    * ``cache``: an optional ``plancache.PlanCache`` consulted first;
      canonically-equal queries of the stream compute once, and computed
      plans are inserted back.
    * ``pipeline``: run the batched engines pipelined (level i+1's host
      work under level i's evaluate, on a second CUDA stream on the card;
      bit-identical results).  ``None`` defers to ``REPRO_PIPELINE``.
    * ``policy``: an optional ``policy.PolicyTable``.  Under
      ``auto``/``mpdp`` it may swap a bucket's lane space for a
      learned-faster one and shrink the chunk and the drain window; every
      flight's telemetry is fed back.  Costs and plans are the same
      either way.
    * ``config.deadline_s``: one deadline for the whole stream; each
      engine and solo run gets the time still left, and a query whose
      levels it cuts comes back degraded (``info["degraded"]``), never
      cached.
    * ``devices``/``mesh``: shard each bucket's batch dimension over a
      ``shard.DeviceMesh`` (``shard.ShardedBatchEngine``): ``devices=N``
      takes the first N devices of ``device``'s type (raising, never
      truncating, when fewer exist; on the CPU, logical devices from
      ``hostdev.ensure_host_devices``), ``mesh=`` supplies one.  Flights
      hold up to ``max_flight`` queries a shard.  Results equal the
      single-device run's; a flight whose sharded run raises is run
      again on the single-device ``BatchEngine`` and its results carry
      ``info["redispatched"]``.  With a mesh, queries past the batched
      memo (``nmax_bucket(n) > 16``, ``n <= lattice.NMAX_LATTICE``) run
      on ``lattice.LatticeShardedEngine`` instead of the solo engine.

    Results come back in input order.
    """
    max_flight = alias_kwarg(max_flight, max_batch, "max_batch", "max_flight")
    cfg = resolve_config(config, algorithm=algorithm, chunk=chunk,
                         cache=cache, max_flight=max_flight, devices=devices,
                         mesh=mesh, pipeline=pipeline, policy=policy)
    algorithm, chunk, cache = cfg.algorithm, cfg.chunk, cfg.cache
    # learned policies only steer the auto dispatcher: an explicit lane
    # space is a user decision the policy must not override
    adaptive = cfg.policy if algorithm in ("auto", "mpdp") else None
    dev = resolve_device(device)
    shard_mesh = stream_mesh(cfg, dev)
    results: list[OptimizeResult | None] = [None] * len(graphs)
    pending = probe_stream(graphs, results, cache, algorithm)
    pending, deferred, dup_rep = dedup_pending(graphs, pending, cache)
    buckets, solo = bucket_pending(graphs, pending, algorithm)
    lattice: list[tuple[int, str]] = []
    if shard_mesh is not None:
        lattice, solo = lattice_pending(graphs, solo, algorithm)

    # one absolute deadline for the whole stream: each engine gets the time
    # still remaining, so sequential buckets share the budget
    deadline_at = (None if cfg.deadline_s is None
                   else faults.now() + cfg.deadline_s)

    def _left() -> float | None:
        if deadline_at is None:
            return None
        return max(deadline_at - faults.now(), 1e-9)

    # per-shard flights stay capped at max_flight
    step = cfg.max_flight * (1 if shard_mesh is None else shard_mesh.size)
    for (b, space, _typed), idxs in sorted(buckets.items()):
        for s0 in range(0, len(idxs), step):
            group = idxs[s0: s0 + step]
            members = [graphs[qi] for qi in group]
            run_space, run_chunk, run_kw = policy_dispatch(adaptive, b, space,
                                                           chunk)
            t_fl = time.perf_counter()
            redispatched = False
            if shard_mesh is None:
                eng = BatchEngine(members, chunk=run_chunk,
                                  algorithm=run_space, pipeline=cfg.pipeline,
                                  deadline_s=_left(), device=dev, **run_kw)
                rs = eng.run()
            else:
                from .shard import ShardedBatchEngine
                eng = ShardedBatchEngine(
                    members, shard_mesh, chunk=run_chunk, algorithm=run_space,
                    pipeline=cfg.pipeline, deadline_s=_left(), **run_kw)
                try:
                    rs = eng.run()
                except Exception:
                    # a failure on the mesh: run the flight again on the
                    # single-device engine (same members and space, same
                    # results) and mark its results
                    eng = BatchEngine(members, chunk=run_chunk,
                                      algorithm=run_space,
                                      pipeline=cfg.pipeline,
                                      deadline_s=_left(), device=dev,
                                      **run_kw)
                    rs = eng.run()
                    redispatched = True
            if adaptive is not None:
                adaptive.observe(b, space, run_space, _telemetry.capture(
                    eng, rs, nmax=b, queries=len(group),
                    wall_s=time.perf_counter() - t_fl))
            for qi, r in zip(group, rs):
                if redispatched:
                    r.info["redispatched"] = True
                results[qi] = r
                # degraded plans are best-effort, never cached: a later
                # undegraded run must not hit a deadline-truncated plan
                if cache is not None and "degraded" not in r.info:
                    cache.put(graphs[qi], r)
    for qi, space in lattice:
        from . import lattice as _lattice
        r = _lattice.LatticeShardedEngine(
            graphs[qi], shard_mesh, chunk=chunk, algorithm=space,
            pipeline=cfg.pipeline, deadline_s=_left()).run()[0]
        results[qi] = r
        if cache is not None and "degraded" not in r.info:
            cache.put(graphs[qi], r)
    for qi in solo:
        if cfg.deadline_s is None:
            r = _eng.optimize(graphs[qi], algorithm, chunk=chunk, device=dev)
        else:
            r = _eng.optimize(graphs[qi], config=OptimizerConfig(
                algorithm=algorithm, chunk=chunk, cyc_cap=cfg.cyc_cap,
                enum=cfg.enum, deadline_s=_left()), device=dev)
        results[qi] = r
        if cache is not None and "degraded" not in r.info:
            cache.put(graphs[qi], r)
    resolve_deferred(graphs, results, cache, deferred, dup_rep)
    return results
