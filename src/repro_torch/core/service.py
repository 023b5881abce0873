"""Streaming query service: admission control and pipelined flights.

The port of ``repro.core.service``.  ``optimize_many`` batches a closed
list of queries; a service sees an open stream and decides, per query,
which device pass it rides:

  * **admission control** — queries are grouped into *flights* by
    ``(NMAX bucket, lane space, typed)`` (``batch.bucket_pending``), split
    at ``max_flight`` queries;
  * **flight pipelining** — flight i's host-only finalize (memo fetch,
    plan extraction, cache insertion, latency bookkeeping) is deferred
    until after flight i+1's ``run_levels``; inside each flight the engine
    runs its own level pipeline when ``pipeline`` is on (level k+1's host
    work under level k's evaluate, on a second CUDA stream on the card);
  * **plan cache** — probed before admission (hits spawn no engine), with
    intra-stream dedup of canonically-equal queries, exactly as
    ``optimize_many``; computed plans are inserted at flight finalize.

Every flight moves through four states: *admitted* (``admit`` grouped
it), *dispatched* (``_spawn`` built its ``BatchEngine`` and ran
``run_levels``), *finalized* (``_finalize`` ran ``collect`` after the next
flight's dispatch) and *reported* (appended to ``StreamReport.flights``
with ``wall_s``, dispatch to finalize done, and ``finalize_s``).  In the
port, ``run_levels`` drains and commits its last level before it returns,
so little device work trails a flight; ``finalize_s`` measures what the
deferred ``collect`` costs.

Solo queries (no batched lane space, or ``nmax_bucket(n) > 16``) run per
query through ``engine.optimize`` after all flights land; deferred
duplicates resolve last (``resolve_deferred``).  Results are
bit-identical to the port's ``optimize_many`` over the same stream: the
probe, dedup, bucket and resolve steps are the same functions, and each
flight runs the same engine on the same sub-batch.

``config.deadline_s`` arms one deadline for the whole stream: each flight
and solo run gets the time still left (``_left``), a result whose levels
it cuts comes back degraded (``info["degraded"]``) and is never cached.
A ``policy.PolicyTable`` (under ``auto``/``mpdp``) chooses each flight's
lane space, chunk and drain window in ``_spawn`` and learns from its
telemetry in ``_finalize``; costs and plans do not move.  With
``devices=`` or ``mesh=`` each flight holds up to ``max_flight`` queries a
shard and runs on ``shard.ShardedBatchEngine`` (a flight whose sharded run
raises runs again on ``BatchEngine``, its results marked
``info["redispatched"]``), and the queries too big for a batched flight
become single-query lattice flights (``lattice.LatticeShardedEngine``,
``FlightReport.lattice``) instead of solo runs.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import engine as _eng
from . import faults
from . import telemetry as _telemetry
from .batch import (BatchEngine, bucket_pending, dedup_pending,
                    lattice_pending, policy_dispatch, probe_stream,
                    resolve_deferred, stream_mesh)
from .config import UNSET, OptimizerConfig, resolve_config
from .engine import resolve_device
from .joingraph import JoinGraph
from .plan import OptimizeResult


@dataclasses.dataclass
class FlightReport:
    """One admitted flight: its admission key, members and measured times."""
    nmax: int
    space: str
    queries: list[int]             # stream indices, admission order
    lattice: bool = False          # a single-query lattice flight
    wall_s: float = 0.0            # run_levels dispatch -> finalize done
    finalize_s: float = 0.0        # host-only finalize share
    # execution profile captured at finalize (telemetry.FlightTelemetry);
    # ``space`` above is the admission space, ``telemetry.space`` the lane
    # space executed (they differ only under a learned policy)
    telemetry: object | None = None

    @property
    def key(self) -> tuple[int, str]:
        return (self.nmax, self.space)


@dataclasses.dataclass
class StreamReport:
    """Whole-stream accounting returned next to the results."""
    flights: list[FlightReport] = dataclasses.field(default_factory=list)
    latency_s: list[float] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    cache_hits: int = 0
    solo: int = 0                  # queries that ran per query
    lattice: int = 0               # lattice flights

    def latency_percentiles(self, ps=(50, 95, 99)) -> dict[int, float]:
        if not self.latency_s:
            return {p: 0.0 for p in ps}
        xs = np.asarray(self.latency_s, np.float64)
        return {p: float(np.percentile(xs, p)) for p in ps}

    def telemetry_summary(self) -> dict:
        """Stream-wide roll-up of the per-flight telemetry records."""
        return _telemetry.aggregate(fl.telemetry for fl in self.flights)


class StreamOptimizer:
    """Admission-controlled, flight-pipelined optimizer for query streams.

    Parameters mirror ``optimize_many``, plus ``device`` (``cuda`` unless
    the caller names another; raises without a card); ``max_flight`` is
    the flight size cap a shard (multiplied by the mesh size when
    sharding).  All knobs can be passed as one
    ``config=OptimizerConfig(...)`` instead of the legacy kwargs (never
    both); the resolved config is kept on ``self.config``.
    """

    def __init__(self, algorithm=UNSET, chunk=UNSET, cache=UNSET,
                 devices=UNSET, mesh=UNSET, pipeline=UNSET, max_flight=UNSET,
                 policy=UNSET, *, config: OptimizerConfig | None = None,
                 device=None):
        cfg = resolve_config(config, algorithm=algorithm, chunk=chunk,
                             cache=cache, devices=devices, mesh=mesh,
                             pipeline=pipeline, max_flight=max_flight,
                             policy=policy)
        self.config = cfg
        self.algorithm = cfg.algorithm
        self.chunk = cfg.chunk
        self.cache = cfg.cache
        self.pipeline = cfg.pipeline
        self.max_flight = cfg.max_flight
        # learned policies steer only the auto dispatcher (an explicit lane
        # space is a user decision); flights record telemetry either way
        self.policy = (cfg.policy
                       if cfg.algorithm in ("auto", "mpdp") else None)
        self.device = resolve_device(device)
        self.mesh = stream_mesh(cfg, self.device)
        # armed per stream: one expiry shared by every flight and solo run
        self._deadline_at: float | None = None

    def _left(self) -> float | None:
        """Remaining stream budget (None when no deadline is armed)."""
        if self._deadline_at is None:
            return None
        return max(self._deadline_at - faults.now(), 1e-9)

    # -------------------------------------------------------- admission ----
    def admit(self, graphs: list[JoinGraph], idxs: list[int]
              ) -> tuple[list[FlightReport], list[int]]:
        """Group ``idxs`` into (NMAX bucket, lane space) flights (the shared
        ``batch.bucket_pending`` grouping, split at the flight cap);
        ungroupable queries come back as the solo list.  With a mesh, the
        queries too big for a batched flight become single-query lattice
        flights instead (``batch.lattice_pending``)."""
        buckets, solo = bucket_pending(graphs, idxs, self.algorithm)
        step = self.max_flight
        latt: list[tuple[int, str]] = []
        if self.mesh is not None:
            step *= self.mesh.size
            latt, solo = lattice_pending(graphs, solo, self.algorithm)
        flights = [FlightReport(b, space, idxs_b[s0: s0 + step])
                   for (b, space, _typed), idxs_b in sorted(buckets.items())
                   for s0 in range(0, len(idxs_b), step)]
        if latt:
            from .lattice import lattice_bucket
            flights += [FlightReport(lattice_bucket(graphs[qi].n), space,
                                     [qi], lattice=True)
                        for qi, space in latt]
        return flights, solo

    def _spawn(self, graphs: list[JoinGraph], fl: FlightReport):
        """Build the flight's engine and run its level loop, within the
        stream's remaining budget.  With a policy table a batched flight
        runs under its learned lane-space / chunk / drain-window decision
        (``fl.space`` stays the admission space).  A sharded flight that
        raises runs again on ``BatchEngine`` and is marked
        ``redispatched``."""
        with _telemetry.span("service.flight"):
            members = [graphs[qi] for qi in fl.queries]
            if fl.lattice:
                from . import lattice as _lattice
                eng = _lattice.LatticeShardedEngine(
                    members[0], self.mesh, chunk=self.chunk,
                    algorithm=fl.space, pipeline=self.pipeline,
                    deadline_s=self._left())
                eng.run_levels()
                return eng
            space, chunk, kw = policy_dispatch(self.policy, fl.nmax, fl.space,
                                               self.chunk)
            if self.mesh is not None:
                from .shard import ShardedBatchEngine
                eng = ShardedBatchEngine(members, self.mesh, chunk=chunk,
                                         algorithm=space,
                                         pipeline=self.pipeline,
                                         deadline_s=self._left(), **kw)
                try:
                    eng.run_levels()
                    return eng
                except Exception:
                    # a failure on the mesh: run the flight again on the
                    # single-device engine (same members and space, same
                    # results) and mark it at finalize
                    pass
            eng = BatchEngine(members, chunk=chunk, algorithm=space,
                              pipeline=self.pipeline, deadline_s=self._left(),
                              device=self.device, **kw)
            eng.run_levels()
            eng.redispatched = self.mesh is not None
            return eng

    def _finalize(self, graphs, fl: FlightReport, eng, t_flight, t_stream,
                  results, report) -> None:
        """Host-only flight finalize: fetch, extract, cache insert, then
        the flight's telemetry and its members' latencies."""
        with _telemetry.span("service.finalize"):
            t0 = time.perf_counter()
            collected = eng.collect()
            for qi, r in zip(fl.queries, collected):
                if getattr(eng, "redispatched", False):
                    r.info["redispatched"] = True
                results[qi] = r
                # degraded (deadline-stitched) plans are best-effort, never
                # cached, so a later unhurried run recomputes the exact plan
                if self.cache is not None and "degraded" not in r.info:
                    self.cache.put(graphs[qi], r)
            done = time.perf_counter()
            fl.finalize_s = done - t0
            fl.wall_s = done - t_flight
            fl.telemetry = _telemetry.capture(
                eng, collected, nmax=fl.nmax, queries=len(fl.queries),
                lattice=fl.lattice, wall_s=fl.wall_s,
                finalize_s=fl.finalize_s)
            if self.policy is not None and not fl.lattice:
                self.policy.observe(fl.nmax, fl.space, eng.algorithm,
                                    fl.telemetry)
            for qi in fl.queries:
                report.latency_s[qi] = done - t_stream
            if fl.lattice:
                report.lattice += 1
            report.flights.append(fl)

    # ------------------------------------------------------------ stream ---
    def optimize_stream(self, graphs: list[JoinGraph]
                        ) -> tuple[list[OptimizeResult], StreamReport]:
        """Optimize the stream; returns results in stream order plus the
        flight and latency report.  Results are bit-identical to
        ``optimize_many`` over the same list."""
        with _telemetry.span("service.stream"):
            t_stream = time.perf_counter()
            self._deadline_at = (None if self.config.deadline_s is None
                                 else faults.now() + self.config.deadline_s)
            report = StreamReport(latency_s=[0.0] * len(graphs))
            results: list[OptimizeResult | None] = [None] * len(graphs)
            pending = probe_stream(graphs, results, self.cache,
                                   self.algorithm)
            for qi, r in enumerate(results):
                if r is not None:
                    report.latency_s[qi] = time.perf_counter() - t_stream
                    if r.algorithm.startswith("cache["):
                        report.cache_hits += 1
            pending, deferred, dup_rep = dedup_pending(graphs, pending,
                                                       self.cache)
            flights, solo = self.admit(graphs, pending)
            report.solo = len(solo)

            # double-buffered flight loop: flight i is finalized after flight
            # i+1's levels have run
            prev = None                        # (flight, engine, t_flight)
            for fl in flights:
                t_flight = time.perf_counter()
                eng = self._spawn(graphs, fl)
                if prev is not None:
                    self._finalize(graphs, *prev, t_stream, results, report)
                prev = (fl, eng, t_flight)
            if prev is not None:
                self._finalize(graphs, *prev, t_stream, results, report)

            for qi in solo:
                with _telemetry.span("service.solo"):
                    if self.config.deadline_s is None:
                        r = _eng.optimize(graphs[qi], self.algorithm,
                                          chunk=self.chunk,
                                          device=self.device)
                    else:
                        r = _eng.optimize(graphs[qi], config=OptimizerConfig(
                            algorithm=self.algorithm, chunk=self.chunk,
                            deadline_s=self._left()), device=self.device)
                results[qi] = r
                report.latency_s[qi] = time.perf_counter() - t_stream
                if self.cache is not None and "degraded" not in r.info:
                    self.cache.put(graphs[qi], r)
            resolve_deferred(graphs, results, self.cache, deferred, dup_rep)
            for qi in deferred:
                report.latency_s[qi] = time.perf_counter() - t_stream
                report.cache_hits += 1
            report.wall_s = time.perf_counter() - t_stream
            return results, report


def optimize_stream(graphs: list[JoinGraph], algorithm=UNSET, chunk=UNSET,
                    cache=UNSET, devices=UNSET, mesh=UNSET, pipeline=UNSET,
                    max_flight=UNSET, policy=UNSET, *,
                    config: OptimizerConfig | None = None, device=None
                    ) -> tuple[list[OptimizeResult], StreamReport]:
    """One-shot convenience wrapper around ``StreamOptimizer``."""
    cfg = resolve_config(config, algorithm=algorithm, chunk=chunk,
                         cache=cache, devices=devices, mesh=mesh,
                         pipeline=pipeline, max_flight=max_flight,
                         policy=policy)
    return StreamOptimizer(config=cfg, device=device).optimize_stream(graphs)
