"""Batch sharding: one flight's queries dealt over a 1-D mesh of devices.

The port of ``repro.core.shard``.  ``BatchEngine`` folds B queries into
the *lane* dimension of one device pipeline; ``ShardedBatchEngine`` deals
them over the shards of a ``DeviceMesh`` as well, each shard one
``batch.BatchEngine`` over its queries on its device:

  * the B queries of a (NMAX, topology) bucket are padded up to a shard
    multiple with *inert* 2-relation queries and dealt round-robin, so
    every shard holds exactly ``ceil(B / D)`` queries and all shards share
    one ``(nmax, bcap, emax)`` layout.  The contract, precisely:

      - **deal**: bucket entry ``j`` lands on shard ``j % D``, local slot
        ``j // D``, so result collection is ``results[j] = shard[j %
        D][j // D]``;
      - **padding**: the ``(-B) % D`` pad slots are appended *after* the
        real queries, so they occupy the highest (shard, slot) pairs; a
        pad query is a fixed 2-relation join (``_pad_graph``) whose lanes
        run as any other's but whose memo region no real query reads and
        whose result is dropped at collection;
      - **inertness**: pads are tiny (NMAX bucket unchanged, two levels),
        so a padded batch returns the results of the unpadded one;
  * each shard's memo, ``all_sets``, adjacency and edge tables and typed
    conflict arrays live on its device, and each shard runs the unchanged
    chunk bodies of ``core.chunks`` and ``ops.bconnectivity_span`` on them;
  * host compaction, phase A and the per-level fold of the chunk results
    (each shard's ``chunks.DeviceFold``, or ``chunks.ChunkResults`` for
    typed and DPSUB flights) stay per shard; shards never exchange data.

One step over all shards (a filter span, an evaluate chunk) counts as one
dispatch, as one ``shard_map`` call does in the reference: it passes the
``"chunk"`` fault site once and counts once in ``chunks_dispatched``.  A
shard whose lanes end before the others' makes no launch in the later
steps.  Costs, plans and ``Counters`` equal those of one ``BatchEngine``
over the same queries at any shard count: each shard enumerates exactly
the candidates a standalone engine over its queries would, and the
per-set reductions do not depend on which shard a query sits on.

The reference builds its mesh of emulated host devices in one process;
the port's ``DeviceMesh`` is a tuple of torch devices driven by one
process, and may name one device several times: each entry is then a
*logical shard* (``[cpu] * 4`` in the tests, ``[cuda:0] * 4`` on one
card), whose work runs after the other shards' on that device.
``take_devices(backend="cpu")`` hands out ``hostdev.host_device_count()``
logical CPU devices.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import bitset as bs
from . import faults
from . import telemetry as _telemetry
from ..hostdev import host_device_count
from ..kernels import ops
from .batch import (NMAX_BATCH, SPAN, BatchEngine, _bcap, _LevelLoop,
                    _memo_result)
from .config import CHUNK, CYC_CAP_DEFAULT
from .engine import resolve_device
from .joingraph import JoinGraph
from .plan import OptimizeResult

BATCH_AXIS = "batch"


# ============================================================ mesh helpers ==

@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh over the ``batch`` axis: one torch device per shard (a
    device named several times gives several logical shards on it)."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (BATCH_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def take_devices(n: int | None = None, *, backend: str | None = None) -> list:
    """The first ``n`` devices of ``backend`` (``cuda`` by default), or all
    of them when ``n`` is None: the cards ``torch.cuda.device_count()``
    counts, or on ``cpu`` the logical devices of
    ``hostdev.ensure_host_devices``.  Never truncates: asking for more
    devices than exist raises with the actual count."""
    backend = backend or "cuda"
    if backend == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", k) for k in range(count)]
    elif backend == "cpu":
        devs = [torch.device("cpu")] * host_device_count()
    else:
        raise ValueError(f"unknown device backend {backend!r}")
    if n is None:
        return devs
    if n < 1:
        raise ValueError(f"need at least 1 device, requested {n}")
    if n > len(devs):
        raise ValueError(
            f"requested {n} devices but only {len(devs)} {backend} device(s) "
            f"exist; on the CPU, ask for more logical devices with "
            f"repro_torch.hostdev.ensure_host_devices({n})")
    return devs[:n]


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        resolve_device(dev)                    # raises without a card
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def batch_mesh(devices=None, *, backend: str | None = None) -> DeviceMesh:
    """1-D mesh over the ``batch`` axis.

    ``devices`` may be a ``DeviceMesh`` (returned as is), an int (the
    first N devices of ``backend`` via ``take_devices``), an explicit
    device list (which may name a device several times), or None (all
    devices of ``backend``)."""
    if isinstance(devices, DeviceMesh):
        return devices
    if devices is None or isinstance(devices, int):
        devs = take_devices(devices, backend=backend)
    else:
        devs = [_device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(tuple(devs))


def mesh_size(mesh: DeviceMesh) -> int:
    return mesh.size


def _pad_graph() -> JoinGraph:
    """Inert batch-padding query: a 2-relation join whose lanes run but
    whose result is dropped.  A tree, so it is valid in every lane space
    and never widens the bucket's NMAX or EMAX."""
    return JoinGraph.make(2, [(0, 1)], [2.0, 2.0], [0.5])


# ============================================================== host driver ==

class ShardedBatchEngine(_LevelLoop):
    """Level-synchronous DP over a batch of queries, dealt over the shards
    of ``mesh`` (a ``DeviceMesh``, or what ``batch_mesh`` takes).  Same
    lane spaces, kernels and host merges as ``BatchEngine``; the module
    docstring has the layout.  ``shards[d]`` is shard d's
    ``BatchEngine``."""

    def __init__(self, graphs: list[JoinGraph], mesh=None, chunk: int = CHUNK,
                 algorithm: str = "dpsub", cyc_cap: int = CYC_CAP_DEFAULT,
                 pipeline: bool | None = None,
                 pend_window: int | None = None,
                 deadline_s: float | None = None):
        if not graphs:
            raise ValueError("empty batch")
        if algorithm not in ("dpsub", "mpdp_tree", "mpdp_general"):
            raise ValueError(f"unknown batched lane space {algorithm!r}")
        for g in graphs:
            if g.n < 2:
                raise ValueError("ShardedBatchEngine needs n >= 2 (leaf "
                                 "queries are handled by optimize_many)")
            if not g.is_connected():
                raise ValueError("query graph must be connected (no cross products)")
            if algorithm == "mpdp_tree" and not g.is_tree():
                raise ValueError("mpdp_tree lane space needs acyclic queries")
        self.mesh = batch_mesh(mesh)
        self.D = self.mesh.size
        self.graphs = list(graphs)
        self.algorithm = algorithm
        self.chunk = chunk
        self.pipeline = (self._use_pipeline() if pipeline is None
                         else bool(pipeline))
        self.pend_window = pend_window
        self.deadline_s = deadline_s
        self._deadline_at: float | None = None
        self.degraded: dict | None = None
        self.chunks_dispatched = 0        # steps over all shards
        self._wall = 0.0
        self.timings: dict[str, float] = {}
        self._launch0 = dict(ops.LAUNCHES)
        self.B = len(graphs)
        npad = (-self.B) % self.D
        padded = self.graphs + [_pad_graph() for _ in range(npad)]
        # round-robin deal: stream entry j -> (shard j % D, slot j // D)
        self.Bs = len(padded) // self.D
        self.shard_graphs = [[padded[s * self.D + d] for s in range(self.Bs)]
                             for d in range(self.D)]
        self.nmax = max(bs.nmax_bucket(g.n) for g in self.graphs)
        if self.nmax > NMAX_BATCH:
            raise ValueError(f"batched path supports nmax <= {NMAX_BATCH}")
        self.bcap = _bcap(self.Bs)
        max_m = max(g.m for g in padded)
        self.emax = max(8, int(np.ceil(max_m / 8.0)) * 8)
        layout = (self.nmax, self.bcap, self.emax)
        self.shards = [BatchEngine(sg, chunk=chunk, algorithm=algorithm,
                                   cyc_cap=cyc_cap, pipeline=False,
                                   pend_window=pend_window, device=dev,
                                   layout=layout)
                       for sg, dev in zip(self.shard_graphs, self.mesh.devices)]
        self.pend_window = self.shards[0].pend_window
        for sh in self.shards:
            sh.timings = self.timings         # one stage clock for the flight
        # the real queries' counters, in stream order (pads' are never read)
        self.counters = [self.shards[q % self.D].counters[q // self.D]
                         for q in range(self.B)]

    def _devices(self) -> list[torch.device]:
        return list(self.mesh.devices)

    # ------------------------------------------------------------ filter ---
    def _filter_dispatch(self, i: int) -> list:
        """Level i's filter spans, one step per ``SPAN`` ranks of the
        longest shard; a shard launches while it has ranks left."""
        with _telemetry.stage(self.timings, "filter"):
            ctxs = [sh._filter_begin(i) for sh in self.shards]
            for lane0 in range(0, max(c["total"] for c in ctxs), SPAN):
                for sh, c in zip(self.shards, ctxs):
                    if lane0 < c["total"]:
                        sh._filter_step(c, i, lane0)
                faults.fire("chunk")
                self._count_chunk()
                for sh, c in zip(self.shards, ctxs):
                    sh._filter_drain(c, self.pend_window)
        return ctxs

    def _filter_collect(self, ctxs: list) -> list[list[np.ndarray]]:
        return [sh._filter_collect(c) for sh, c in zip(self.shards, ctxs)]

    def _register_level(self, i: int, sets) -> None:
        for sh, sets_d in zip(self.shards, sets):
            sh._register_level(i, sets_d)

    # ---------------------------------------------------------- evaluate ---
    def _eval_dispatch(self, i: int, sets):
        """Segmented lane spaces: each shard's chunk grid is the one its
        ``BatchEngine`` would use; step j launches chunk j of every shard
        that has one."""
        t0 = time.perf_counter_ns()
        ctxs = [sh._eval_begin(i, sets_d)
                for sh, sets_d in zip(self.shards, sets)]
        live = [(sh, c) for sh, c in zip(self.shards, ctxs) if c is not None]
        if not live:
            return None
        with _telemetry.stage(self.timings, "evaluate", t0):
            for j in range(max(len(c["lane0s"]) for _, c in live)):
                with _telemetry.leaf("engine.chunk"):
                    for sh, c in live:
                        if j < len(c["lane0s"]):
                            sh._eval_step(c, i, j)
                    faults.fire("chunk")
                    self._count_chunk()
                    for _, c in live:
                        c["acc"].drain(self.pend_window)
        return ctxs

    def _eval_finalize(self, i: int, sets, ctxs) -> None:
        """Each shard's ``BatchEngine._eval_finalize`` (either lane
        space)."""
        if ctxs is None:
            return
        for sh, sets_d, c in zip(self.shards, sets, ctxs):
            sh._eval_finalize(i, sets_d, c)

    # ------------------------------------------------- MPDP-general phase --
    def _pairs_level(self, sets):
        return [sh._pairs_level(sets_d) for sh, sets_d in zip(self.shards, sets)]

    def _eval_general_dispatch(self, i: int, sets, pairs):
        """The block prefix-sum chunks of every shard's pair arrays, one
        step per chunk of the longest shard."""
        t0 = time.perf_counter_ns()
        ctxs = [sh._eval_general_begin(sets_d, p)
                for sh, sets_d, p in zip(self.shards, sets, pairs)]
        live = [(sh, c) for sh, c in zip(self.shards, ctxs) if c is not None]
        if not live:
            return None
        with _telemetry.stage(self.timings, "evaluate", t0):
            for lane0 in range(0, max(c["total"] for _, c in live),
                               self.chunk):
                with _telemetry.leaf("engine.chunk"):
                    for sh, c in live:
                        if lane0 < c["total"]:
                            sh._eval_general_step(c, lane0)
                    faults.fire("chunk")
                    self._count_chunk()
                    for _, c in live:
                        c["acc"].drain(self.pend_window)
        return ctxs

    # ------------------------------------------------------------ driver ---
    # (run / run_levels / the pipelined rotation come from _LevelLoop)
    def collect(self) -> list[OptimizeResult]:
        """Fetch every shard's memo and extract the real queries' results
        in stream order (pads are dropped)."""
        t0 = time.perf_counter()
        memo = [sh._fetch_memo() for sh in self.shards]
        wall = self._wall + time.perf_counter() - t0
        out = []
        for qi, g in enumerate(self.graphs):
            cost_all, left_all = memo[qi % self.D]
            s = qi // self.D
            region = slice(s << self.nmax, (s + 1) << self.nmax)
            out.append(_memo_result(
                g, cost_all[region], left_all[region], self.counters[qi],
                f"batch_{self.algorithm}", wall / self.B, self.degraded,
                self.timings, f"batch query {qi}"))
        return out
