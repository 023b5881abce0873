"""Per-flight execution telemetry.

The port's own copy of ``repro.core.telemetry``: every batched flight
(``BatchEngine``, whether spawned by ``optimize_many`` or the streaming
service) can be summarized as one :class:`FlightTelemetry` record: how
many lanes the device evaluated, how full the dispatched chunks were, how
long the flight took and what total plan cost it produced.  The record is
pure host bookkeeping assembled *after* the flight from counters the
engine already keeps (plus ``chunks_dispatched``, incremented once per
dispatched filter span and evaluate chunk), so capturing it cannot perturb
costs, plans or lane counters; ``core.service`` attaches one to every
``FlightReport``.

The port builds its CUDA library once per process (``kernels.build``) and
never traces, so ``retraces`` records 0.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FlightTelemetry:
    """One flight's execution profile.  All fields are plain host scalars."""
    nmax: int                 # bucket the flight was admitted under
    space: str                # lane space actually executed
    queries: int              # real (non-padding) queries in the flight
    lattice: bool = False     # intra-query lattice-sharded flight
    evaluated_lanes: int = 0  # lanes surviving the CCP filter (device work)
    ccp_lanes: int = 0        # raw candidate lanes before filtering
    chunk: int = 0            # chunk size the flight ran with
    chunks: int = 0           # chunk dispatches across all levels/stages
    retraces: int = 0         # always 0 in the port (nothing is traced)
    result_cost: float = 0.0  # sum of final plan costs (f32 exact-min costs)
    wall_s: float = 0.0       # run_levels wall (service: stamped in _finalize)
    finalize_s: float = 0.0   # host collect/cache wall (service only)

    @property
    def occupancy(self) -> float:
        """Fraction of dispatched lane slots that held real work."""
        denom = self.chunks * self.chunk
        return self.evaluated_lanes / denom if denom else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["occupancy"] = self.occupancy
        return d


def capture(eng, results, *, nmax: int, queries: int, lattice: bool = False,
            wall_s: float = 0.0, finalize_s: float = 0.0) -> FlightTelemetry:
    """Build a :class:`FlightTelemetry` from a finished engine.

    ``eng`` is any engine exposing ``algorithm``, ``chunk``, ``counters``
    (list of per-graph ``Counters``), ``chunks_dispatched`` and ``stats``;
    ``results`` the collected ``OptimizeResult`` list (only ``.cost`` is
    read).  Missing attributes record as zeros, so stand-in engines still
    produce a well-formed record.
    """
    counters = getattr(eng, "counters", None) or ()
    evaluated = sum(int(c.evaluated) for c in counters)
    ccp = sum(int(c.ccp) for c in counters)
    stats = getattr(eng, "stats", None) or {}
    return FlightTelemetry(
        nmax=int(nmax),
        space=str(getattr(eng, "algorithm", "?")),
        queries=int(queries),
        lattice=bool(lattice),
        evaluated_lanes=evaluated,
        ccp_lanes=ccp,
        chunk=int(getattr(eng, "chunk", 0) or 0),
        chunks=int(getattr(eng, "chunks_dispatched", 0)),
        retraces=int(stats.get("retraces", 0)),
        result_cost=float(sum(float(r.cost) for r in results)),
        wall_s=float(wall_s),
        finalize_s=float(finalize_s),
    )


def aggregate(records) -> dict:
    """Fold an iterable of flight telemetry records into one summary dict.

    ``None`` entries are skipped so callers can pass
    ``[fl.telemetry for fl in report.flights]`` without filtering.
    """
    recs = [r for r in records if r is not None]
    out = {
        "flights": len(recs),
        "queries": sum(r.queries for r in recs),
        "evaluated_lanes": sum(r.evaluated_lanes for r in recs),
        "ccp_lanes": sum(r.ccp_lanes for r in recs),
        "chunks": sum(r.chunks for r in recs),
        "retraces": sum(r.retraces for r in recs),
        "result_cost": float(sum(r.result_cost for r in recs)),
        "wall_s": float(sum(r.wall_s for r in recs)),
    }
    slots = sum(r.chunks * r.chunk for r in recs)
    out["occupancy"] = (out["evaluated_lanes"] / slots) if slots else 0.0
    return out
