"""Intra-query lattice sharding: one query's lane space over the mesh.

The port of ``repro.core.lattice``.  ``core.shard`` deals whole queries
over the shards, so a query's exact DP stays capped by one shard's memo
(``NMAX_BATCH``).  This module shards the other axis: the subset lattice
of a **single** query is partitioned over the shards of a
``shard.DeviceMesh``:

  * every DP level's lanes (DPSUB ``sets x 2^i`` subsets, MPDP:Tree
    ``sets x m`` (set, edge) lanes, the MPDP-general block prefix-sum of
    (set, block, rank) lanes, and the filter's colex ranks) are split into
    contiguous balanced ranges by ``distributed.sharding.partition_lanes``;
    shard ``d`` evaluates only its range, through the unchanged chunk
    bodies of ``core.chunks`` at ``bcap = 1``, and folds its results in
    its own ``chunks.ChunkResults``;
  * the memo is **replicated**: every shard holds the full ``1 << nmax``
    cost, rows, left and ``all_sets`` tables on its device;
  * shards exchange data **only at level commit**: one
    ``distributed.collectives.min_left_commit`` call per committed level
    combines the shards' partial minima with the (min cost, max left)
    semiring of the host merges and scatters the result into every
    replica.  ``engine.collectives`` counts the calls: ``n - 1`` per query.

The offset trick that lets the batched kernels run unchanged: shard ``d``'s
chunk at base ``c`` passes ``eoff = [-(start_d + c), end_d - start_d -
c]`` (clipped), so the kernel's lane decode ``local = t - eoff[0]`` is the
*global* lane id and ``t < eoff[1]`` masks everything past the shard's
range.  The filter's ``bconnectivity_span`` takes the same offsets, one
launch per shard and level span of ``SPAN`` ranks (``C(20, 10)`` ranks fit
one span), and its survivors, concatenated in shard order, are the global
colex order; a shard whose range is empty (at level n, all but one)
launches nothing.  The MPDP-general phase A runs once per level on the
host, and each shard's chunk gets its own window of the level's pairs: a
pair whose lanes straddle a range boundary appears in both windows with
its rank offset kept.

Results equal the single-device engines': the partition is an exact
disjoint cover and every reduction is the associative (f32 min, max left)
semiring, so where a candidate is evaluated cannot change the result, and
the evaluated and CCP counters sum to the single-device figures.

The engine runs one query, so it takes finer NMAX buckets than
``bitset.nmax_bucket``: ``lattice_bucket`` adds 18 and 20, so an ``n =
17`` query holds a ``2 ** 18``-entry memo on each shard instead of the solo
engine's ``2 ** 24`` (``NMAX_LATTICE``).
"""
from __future__ import annotations

import time
from collections import deque
from math import comb

import numpy as np
import torch

from . import blocks as bl
from . import chunks as _ch
from . import cost as cm
from . import faults
from . import telemetry as _telemetry
from . import unrank as ur
from ..distributed import collectives as coll
from ..distributed.sharding import partition_lanes
from ..kernels import ops
from .batch import PEND_WINDOW, _lane_space, _LevelLoop, _memo_result
from .chunks import (INF, ChunkResults, _cap, _offset_rows, _pair_offsets,
                     _pair_window, _scatter_into)
from .config import CHUNK, CYC_CAP_DEFAULT, UNSET, OptimizerConfig, resolve_config
from .engine import SPAN, resolve_device
from .joingraph import JoinGraph, typed_edge_arrays
from .plan import Counters, OptimizeResult, leaf_plan
from .shard import batch_mesh

# Finer buckets than ``bitset.nmax_bucket`` above 16: the replicated
# ``1 << nmax`` memo dominates, so bucket 18 and 20 instead of jumping to 24.
LATTICE_BUCKETS = (8, 16, 18, 20)
NMAX_LATTICE = LATTICE_BUCKETS[-1]


def lattice_bucket(n: int) -> int:
    """NMAX bucket for the lattice-sharded path (<= ``NMAX_LATTICE``)."""
    for b in LATTICE_BUCKETS:
        if n <= b:
            return b
    raise ValueError(
        f"n={n} beyond the lattice-sharded cap {NMAX_LATTICE} "
        f"(heuristics handle larger queries; see docs/heuristics.md)")


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


class LatticeShardedEngine(_LevelLoop):
    """Level-synchronous exact DP for ONE query, its lanes sharded over the
    shards of ``mesh`` (a ``shard.DeviceMesh``, or what ``batch_mesh``
    takes).  The level-loop
    hooks are those of the batched engines, so the synchronous and
    pipelined drivers and the deadline are shared; a 1-shard mesh is the
    degenerate case.  Every list attribute (``memo_cost``, ``adj_b``, ...)
    holds one tensor per shard, on the shard's device."""

    def __init__(self, g: JoinGraph, mesh=None, chunk: int = CHUNK,
                 algorithm: str = "mpdp_general",
                 cyc_cap: int = CYC_CAP_DEFAULT,
                 pipeline: bool | None = None,
                 deadline_s: float | None = None):
        if algorithm not in ("dpsub", "mpdp_tree", "mpdp_general"):
            raise ValueError(f"unknown lattice lane space {algorithm!r}")
        if g.n < 2:
            raise ValueError("LatticeShardedEngine needs n >= 2 (leaf "
                             "queries are handled by optimize_many)")
        if not g.is_connected():
            raise ValueError("query graph must be connected (no cross products)")
        if algorithm == "mpdp_tree" and not g.is_tree():
            raise ValueError("mpdp_tree lane space needs acyclic queries")
        self.g = g
        self.graphs = [g]                  # _LevelLoop drives max(g.n)
        self.mesh = batch_mesh(mesh)
        self.D = self.mesh.size
        self.devs = list(self.mesh.devices)
        self.algorithm = algorithm
        self.cyc_cap = cyc_cap
        self.chunk = chunk
        self.pipeline = (self._use_pipeline() if pipeline is None
                         else bool(pipeline))
        self.nmax = lattice_bucket(g.n)
        self.flat = 1 << self.nmax         # bcap = 1: one query per replica
        self.deadline_s = deadline_s
        self._deadline_at: float | None = None
        self.degraded: dict | None = None
        self.collectives = 0               # min_left_commit calls
        self.chunks_dispatched = 0         # steps over all shards
        self._wall = 0.0
        self.counters = [Counters()]
        self.timings: dict[str, float] = {}
        self._launch0 = dict(ops.LAUNCHES)
        nmax = self.nmax
        adj = np.zeros((1, nmax), np.int32)
        for (u, v) in g.edges:
            adj[0, u] |= 1 << v
            adj[0, v] |= 1 << u
        self.emax = max(8, int(np.ceil(max(g.m, 1) / 8.0)) * 8)
        self.binom = self._rep(ur.binom_table(nmax))
        self.adj_b = self._rep(adj)
        # typed-join conflict arrays, replicated (1, emax) rows
        self.typed = g.typed
        if self.typed:
            tarr = np.asarray(typed_edge_arrays(g, self.emax),
                              np.int32)[:, None, :]
            self._tkw = [{"targs": tuple(_put(a, d) for a in tarr)}
                         for d in self.devs]
        else:
            self._tkw = [{} for _ in self.devs]
        if algorithm == "mpdp_tree":
            emu = np.zeros((1, self.emax), np.int32)
            emv = np.zeros((1, self.emax), np.int32)
            for ei, (u, v) in enumerate(g.edges):
                emu[0, ei] = 1 << u
                emv[0, ei] = 1 << v
            self.emu_b = self._rep(emu)
            self.emv_b = self._rep(emv)
            self.m_b = self._rep(np.array([g.m], np.int32))
        if algorithm == "mpdp_general":
            # phase A runs once per level on the host, over the first
            # shard's tables, and feeds every shard's pair windows
            eui = np.full(self.emax, -1, np.int32)
            evi = np.full(self.emax, -1, np.int32)
            eliv = np.zeros(self.emax, bool)
            for ei, (u, v) in enumerate(g.edges):
                eui[ei], evi[ei], eliv[ei] = u, v, True
            self._phase_a_row = tuple(_put(a, self.devs[0])
                                      for a in (adj[0], eui, evi, eliv))
        self._init_memo()

    # ----------------------------------------------------------- plumbing --
    def _rep(self, a: np.ndarray) -> list[torch.Tensor]:
        """One copy of a host array on each shard's device."""
        return [_put(a, d) for d in self.devs]

    def _devices(self) -> list[torch.device]:
        return self.devs

    # --------------------------------------------------------------- memo --
    def _init_memo(self):
        g = self.g
        self.memo_cost = [torch.full((self.flat,), float(INF),
                                     dtype=torch.float32, device=d)
                          for d in self.devs]
        self.memo_rows = [torch.zeros(self.flat, dtype=torch.float32, device=d)
                          for d in self.devs]
        self.memo_left = [torch.zeros(self.flat, dtype=torch.int32, device=d)
                          for d in self.devs]
        self.all_sets = [torch.zeros(self.flat, dtype=torch.int32, device=d)
                         for d in self.devs]
        self._next_off = g.n
        self._level_off = {1: 0}
        leaves = np.array([1 << v for v in range(g.n)], np.int32)
        lrows = g.log2_card.astype(np.float32)
        self._scatter(leaves, cost=cm.np_scan_cost(lrows).astype(np.float32),
                      rows=lrows)
        self._set_all_sets(np.arange(g.n, dtype=np.int64), leaves)

    def _scatter(self, idx_np, cost=None, rows=None):
        """Replicated memo writes: the same (index, value) rows on every
        shard, so the replicas stay equal."""
        for d in range(self.D):
            for buf, val in ((self.memo_cost[d], cost),
                             (self.memo_rows[d], rows)):
                if val is not None:
                    _scatter_into(buf, idx_np, val)

    def _set_all_sets(self, pos_np, sets_np):
        for buf in self.all_sets:
            _scatter_into(buf, pos_np, sets_np)

    def _commit_level(self, sets_np, best_cost, best_left) -> None:
        """THE collective: one ``min_left_commit`` for the level over the
        shards' partial best arrays (pad slots (INF, 0) and the pad index
        ``flat``), each uploaded to its shard's device."""
        ns = len(sets_np)
        cap = _cap(ns)
        idx = np.full(cap, self.flat, np.int64)
        idx[:ns] = sets_np
        costs, lefts = [], []
        for d, dev in enumerate(self.devs):
            c = np.full(cap, INF, np.float32)
            c[:ns] = best_cost[d]
            lf = np.zeros(cap, np.int32)
            lf[:ns] = best_left[d]
            costs.append(_put(c, dev))
            lefts.append(_put(lf, dev))
        coll.min_left_commit(self.memo_cost, self.memo_left,
                             _put(idx, self.devs[0]), costs, lefts,
                             flat=self.flat)
        self.collectives += 1

    # ------------------------------------------------------------- filter --
    def _filter_dispatch(self, i: int) -> dict:
        """Partition level i's ``C(n, i)`` colex ranks over the shards and
        launch ``bconnectivity_span`` per shard and span: shard d's window
        starts at global rank ``roff[d]``, so ``foff = [-(roff[d] + c),
        roff[d+1] - roff[d] - c]`` makes the kernel unrank global ranks and
        mask past the window's end."""
        with _telemetry.stage(self.timings, "filter"):
            roff = partition_lanes(comb(self.g.n, i), self.D)
            sizes = np.diff(roff)
            c0s = np.arange(0, int(sizes.max()), SPAN, dtype=np.int64)
            ctx = {"pend": [deque() for _ in self.devs],
                   "per_dev": [[] for _ in self.devs]}
            foff = [_put(_offset_rows(np.array([0, roff[d + 1]]),
                                      roff[d] + c0s, 1), dev)
                    if sizes[d] else None
                    for d, dev in enumerate(self.devs)]
            for j, c0 in enumerate(c0s.tolist()):
                for d in range(self.D):
                    if c0 < sizes[d]:
                        ctx["pend"][d].append(ops.bconnectivity_span(
                            i, foff[d][j], min(SPAN, int(sizes[d]) - c0),
                            self.binom[d], self.adj_b[d], self.nmax))
                faults.fire("chunk")
                self._count_chunk()
                self._filter_drain(ctx, PEND_WINDOW)
        return ctx

    def _filter_drain(self, ctx: dict, limit: int) -> None:
        for pend, per in zip(ctx["pend"], ctx["per_dev"]):
            while len(pend) > limit:
                S, conn, _ = pend.popleft()
                with _telemetry.span("engine.fetch"):
                    per.append(S[conn != 0].cpu().numpy())

    def _filter_collect(self, ctx: dict) -> np.ndarray:
        """Drain and concatenate the survivors in shard order: the shards'
        rank windows are contiguous and ascending, so this is the global
        colex order the single-device filter produces."""
        with _telemetry.stage(self.timings, "filter"):
            self._filter_drain(ctx, 0)
            parts = [a for per in ctx["per_dev"] for a in per]
            sets = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        return sets

    def _register_level(self, i: int, sets_np: np.ndarray) -> None:
        with _telemetry.stage(self.timings, "filter"):
            self._level_off[i] = self._next_off
            if len(sets_np):
                self._scatter(sets_np,
                              rows=cm.np_rows_for_sets(sets_np, self.g))
                self._set_all_sets(
                    self._next_off + np.arange(len(sets_np), dtype=np.int64),
                    sets_np)
                self._next_off += len(sets_np)

    # ----------------------------------------------------------- evaluate --
    def _eval_dispatch(self, i: int, sets_np: np.ndarray):
        """Segmented lane spaces (DPSUB ``sets x 2^i``, tree ``sets x m``):
        the level's lanes partitioned over the shards, each shard's chunks
        through the batched chunk bodies with global-offset windows, into
        one ``ChunkResults`` a shard."""
        ns = len(sets_np)
        if ns == 0:
            return None
        with _telemetry.stage(self.timings, "evaluate"):
            mult = self.g.m if self.algorithm == "mpdp_tree" else (1 << i)
            lane_off = partition_lanes(ns * mult, self.D)
            sizes = np.diff(lane_off)
            c0s = np.arange(0, int(sizes.max()), self.chunk, dtype=np.int64)
            statics = dict(nmax=self.nmax, chunk=self.chunk,
                           nseg=self.chunk + 2, bcap=1)
            lvl = np.array([self._level_off[i]], np.int32)
            accs = [ChunkResults(ns, 1) for _ in self.devs]
            tabs = []
            for d, dev in enumerate(self.devs):
                if not sizes[d]:
                    tabs.append(None)
                    continue
                tabs.append((_put(_offset_rows(np.array([0, lane_off[d + 1]]),
                                               lane_off[d] + c0s, 1), dev),
                             _put(lvl, dev),
                             _put(np.zeros(1, np.int32), dev)))
            for j, c0 in enumerate(c0s.tolist()):
                with _telemetry.leaf("engine.chunk"):
                    for d in range(self.D):
                        if c0 >= sizes[d]:
                            continue
                        eoff_d, loff_d, soff_d = tabs[d]
                        # the global set index
                        seg0 = int((lane_off[d] + c0) // mult)
                        if self.algorithm == "mpdp_tree":
                            out = _ch._beval_tree_chunk(
                                self.all_sets[d], eoff_d[j], loff_d, soff_d,
                                seg0, self.m_b[d], self.adj_b[d],
                                self.emu_b[d], self.emv_b[d],
                                self.memo_cost[d], self.memo_rows[d],
                                **self._tkw[d], **statics)
                        else:
                            out = _ch._beval_dpsub_chunk(
                                self.all_sets[d], eoff_d[j], loff_d, soff_d,
                                seg0, i, self.adj_b[d], self.memo_cost[d],
                                self.memo_rows[d], **self._tkw[d], **statics)
                        accs[d].add(seg0, out)
                    faults.fire("chunk")
                    self._count_chunk()
                    for acc in accs:
                        acc.drain(PEND_WINDOW)
        return accs

    def _eval_finalize(self, i: int, sets_np: np.ndarray, accs) -> None:
        """Drain every shard's chunk results (either lane space) and commit
        the level through the collective."""
        if accs is None:
            return
        with _telemetry.stage(self.timings, "evaluate"):
            cost, left, ev, ccp = zip(*(acc.finish() for acc in accs))
            self.counters[0].evaluated += int(sum(e[0] for e in ev))
            self.counters[0].ccp += int(sum(c[0] for c in ccp))
            self._commit_level(sets_np, cost, left)

    # ------------------------------------------------- MPDP-general phase --
    def _pairs_level(self, sets_np: np.ndarray):
        """Phase A once on the host over the whole level (the shards differ
        only in their lane ranges)."""
        if not len(sets_np):
            z = np.zeros(0, np.int32)
            return z, z, np.zeros(0, np.int64)
        with _telemetry.stage(self.timings, "blocks"):
            ps, pb = bl.np_pairs_for_sets(sets_np, self.g, *self._phase_a_row,
                                          nmax=self.nmax, emax=self.emax,
                                          cyc_cap=self.cyc_cap)
            pk = np.searchsorted(sets_np, ps).astype(np.int64)
        return ps, pb, pk

    def _eval_general_dispatch(self, i: int, sets_np: np.ndarray, pairs):
        """Partition the block prefix-sum lane space over the shards; each
        shard's chunk gets its own window of the level's pairs."""
        ps, pb, pk = pairs
        if not len(ps):
            return None
        with _telemetry.stage(self.timings, "evaluate"):
            offs = _pair_offsets(pb)
            lane_off = partition_lanes(int(offs[-1]), self.D)
            accs = [ChunkResults(len(sets_np), 1, pk) for _ in self.devs]
            for c0 in range(0, int(np.diff(lane_off).max()), self.chunk):
                with _telemetry.leaf("engine.chunk"):
                    for d, dev in enumerate(self.devs):
                        base = int(lane_off[d]) + c0
                        lane1 = min(base + self.chunk, int(lane_off[d + 1]))
                        if lane1 <= base:
                            continue
                        p0, npair, table = _pair_window(ps, pb, None, offs,
                                                        base, lane1)
                        accs[d].add((p0, npair), _ch._beval_general_chunk(
                            _put(table, dev), npair, lane1 - base,
                            self.adj_b[d], self.memo_cost[d],
                            self.memo_rows[d],
                            nmax=self.nmax, chunk=self.chunk, bcap=1,
                            **self._tkw[d]))
                    faults.fire("chunk")
                    self._count_chunk()
                    for acc in accs:
                        acc.drain(PEND_WINDOW)
        return accs

    # ------------------------------------------------------------- driver --
    # (run / run_levels / the pipelined rotation come from _LevelLoop)
    def collect(self) -> list[OptimizeResult]:
        """Fetch replica 0 (the replicas are equal after every commit) and
        extract the plan; after a deadline, stitch the committed levels."""
        t0 = time.perf_counter()
        cost0 = self.memo_cost[0].cpu().numpy()
        left0 = self.memo_left[0].cpu().numpy()
        wall = self._wall + time.perf_counter() - t0
        return [_memo_result(self.g, cost0, left0, self.counters[0],
                             f"lattice_{self.algorithm}", wall, self.degraded,
                             self.timings, "lattice-sharded query")]

    def memo_replicas(self) -> tuple[np.ndarray, np.ndarray]:
        """The stacked ``(D, flat)`` cost and left memo of the replicas."""
        return (np.stack([c.cpu().numpy() for c in self.memo_cost]),
                np.stack([lf.cpu().numpy() for lf in self.memo_left]))


# ============================================================ public entry ==

def optimize_lattice(g: JoinGraph, algorithm=UNSET, chunk=UNSET,
                     cyc_cap=UNSET, devices=UNSET, mesh=UNSET,
                     pipeline=UNSET, *, config: OptimizerConfig | None = None,
                     device=None) -> OptimizeResult:
    """Exact optimization of one query with its lane space sharded over a
    mesh (``engine.optimize(config.lattice=True)`` lands here).

    ``algorithm`` resolves through ``batch._lane_space`` (``auto``/``mpdp``
    -> tree lanes on acyclic queries, general otherwise); spaces with no
    lattice form (``dpsize``, ``dpccp``, forced ``mpdp_tree`` on a cyclic
    query) raise.  ``devices``/``mesh`` as in ``optimize_many``, on
    ``device``'s type (``cuda`` unless the caller names another).
    """
    cfg = resolve_config(config, algorithm=algorithm, chunk=chunk,
                         cyc_cap=cyc_cap, devices=devices, mesh=mesh,
                         pipeline=pipeline)
    if g.n == 1:
        p = leaf_plan(0, g)
        return OptimizeResult(plan=p, cost=p.cost, counters=Counters(),
                              algorithm=cfg.algorithm, levels=1)
    space = _lane_space(g, cfg.algorithm)
    if space is None:
        raise ValueError(
            f"algorithm {cfg.algorithm!r} has no lattice-sharded lane space "
            "for this query (lattice supports dpsub / mpdp_tree / "
            "mpdp_general)")
    mesh = cfg.mesh if cfg.mesh is not None else batch_mesh(
        cfg.devices, backend=resolve_device(device).type)
    eng = LatticeShardedEngine(g, mesh, chunk=cfg.chunk, algorithm=space,
                               cyc_cap=cfg.cyc_cap, pipeline=cfg.pipeline,
                               deadline_s=cfg.deadline_s)
    return eng.run()[0]
