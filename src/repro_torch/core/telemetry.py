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

**Spans.**  The module also holds the program's span recorder, off by
default: ``enable()`` / ``disable()`` switch it, and while it is off a span
costs one test of a module global and records nothing.  A span is
``(name, t0, t1, id, parent, request, thread)``: start and end on
``time.perf_counter_ns`` (the clock of ``time.perf_counter``), its own id,
the id of the innermost span open on its thread when it opened (``None``
for a root), a request id that every span of one request shares, and the
thread.  A root span opens a new request id, unless its thread runs under
``request(rid)``: the daemon stamps a request's id at admission and its
worker thread runs the request under it.  Spans are kept in memory, in one
buffer of ``CAPACITY`` spans (a full buffer drops its oldest span and
counts it in ``dropped()``); ``spans()`` returns a copy, ``clear()``
empties it.  ``stage(timings, key)`` is the engines' stage clock: it adds
the stage's seconds to an ``OptimizeResult.timings`` dict, always, and
records the stage's span (``STAGES``) from the same two clock reads.

The names are fixed; the benchmark's per-layer readers and ``PERF.md``
read them:

  ``daemon.queue``       admission to the worker's pickup (``record``)
  ``daemon.decode`` / ``daemon.run`` / ``daemon.encode``   the worker's job
  ``service.stream`` / ``service.flight`` / ``service.finalize`` /
  ``service.solo``       ``core.service.StreamOptimizer``
  ``engine.filter`` / ``engine.evaluate`` / ``engine.phase_a``   the level
                         loops' stages (``stage``)
  ``engine.fetch``       a blocking device-to-host read in a level loop
  ``engine.chunk``       one evaluate chunk of a level loop: its launch and
                         the drain after it (the fetches it waits for), a
                         ``leaf``, so those fetches keep ``engine.evaluate``
                         as their parent
  ``blocks.dense``       phase A's dense path (``blocks.np_pairs_for_sets``
                         past ``cyc_cap``), its fetches nested inside
  ``uniondp.solve`` / ``uniondp.partition`` / ``uniondp.subsolve`` /
  ``uniondp.merge`` / ``uniondp.reopt``   ``heuristics.uniondp.solve``

**Counters.**  ``count(name, k)`` adds ``k`` to the counter ``name`` of the
request its thread runs (the innermost open span's, else the one set by
``request(rid)``, else 0), while the recorder is on; ``counts()`` returns
``{(name, request): total}`` and ``clear()`` resets them.  The names:

  ``engine.chunks``       a level loop's filter spans and evaluate chunks,
                          as its engine's ``chunks_dispatched`` counts them
  ``blocks.dense_sets``   sets through phase A's dense path
  ``blocks.oracle_sets``  of those, sets with a cut vertex, decomposed one
                          at a time by the host oracle ``np_find_blocks``
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time


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


# ------------------------------------------------------------------ spans --

CAPACITY = 1 << 20        # spans kept; a full buffer drops its oldest
STAGES = {"filter": "engine.filter", "evaluate": "engine.evaluate",
          "blocks": "engine.phase_a"}

Span = collections.namedtuple("Span", "name t0 t1 id parent request thread")

_ON = False
_buf: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_counts: collections.Counter = collections.Counter()   # (name, request)
_lock = threading.Lock()
_ids = itertools.count(1)             # span and request ids
_local = threading.local()            # .stack: open spans; .request
_NULL = contextlib.nullcontext()


def enable() -> None:
    """Start recording spans; what the buffer holds is kept."""
    global _ON
    _ON = True


def disable() -> None:
    """Stop recording spans; what was recorded stays until ``clear()``."""
    global _ON
    _ON = False


def spans() -> list[Span]:
    """A copy of the recorded spans, in the order they closed."""
    with _lock:
        return [Span(*s) for s in _buf]


def dropped() -> int:
    """Spans dropped from a full buffer since the last ``clear()``."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _buf.clear()
        _counts.clear()
        _dropped = 0


def counts() -> dict:
    """A copy of the counters: ``{(name, request): total}``."""
    with _lock:
        return dict(_counts)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name`` of this thread's request (nothing
    while the recorder is off)."""
    if not _ON:
        return
    st = _stack()
    rid = st[-1].request if st else getattr(_local, "request", 0)
    with _lock:
        _counts[(name, rid)] += k


def new_request() -> int:
    """A fresh request id (0 while the recorder is off)."""
    return next(_ids) if _ON else 0


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _append(rec: tuple) -> None:
    global _dropped
    with _lock:
        if len(_buf) == _buf.maxlen:
            _dropped += 1
        _buf.append(rec)


def _open(sp) -> None:
    """Give ``sp`` its id, parent and request, and push it."""
    st = _stack()
    if st:
        sp.parent, sp.request = st[-1].id, st[-1].request
    else:
        sp.parent = None
        sp.request = getattr(_local, "request", 0) or next(_ids)
    sp.id = next(_ids)
    st.append(sp)


class _Span:
    """One open span; with ``timings`` also a stage of the level loop."""

    __slots__ = ("name", "timings", "key", "on", "t0", "id", "parent",
                 "request")

    def __init__(self, name: str, timings: dict | None = None,
                 key: str | None = None, t0: int | None = None):
        self.name, self.timings, self.key, self.t0 = name, timings, key, t0

    def __enter__(self):
        self.on = _ON
        if self.on:
            _open(self)
        if self.t0 is None:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.timings is not None:
            self.timings[self.key] = (self.timings.get(self.key, 0.0)
                                      + (t1 - self.t0) * 1e-9)
        if self.on:
            _stack().pop()
            _append((self.name, self.t0, t1, self.id, self.parent,
                     self.request, threading.get_ident()))
        return False


def span(name: str):
    """``with span(name):`` records the block as a span (nothing while the
    recorder is off)."""
    return _Span(name) if _ON else _NULL


class _Leaf:
    """One open span that is no parent (``leaf``)."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        record(self.name, self.t0, time.perf_counter_ns())
        return False


def leaf(name: str):
    """``with leaf(name):`` records the block as a span that is no parent:
    the spans opened inside it keep the enclosing span as theirs, as if it
    were not there (nothing while the recorder is off)."""
    return _Leaf(name) if _ON else _NULL


def stage(timings: dict, key: str, t0: int | None = None) -> _Span:
    """``with stage(eng.timings, "filter"):`` adds the block's seconds to
    ``timings[key]`` and records it as the span ``STAGES[key]``.  ``t0``, a
    ``perf_counter_ns`` read taken before the block, starts the stage there
    instead: a dispatch reads it before it learns whether its level has any
    lane, and skips the stage when it has none."""
    return _Span(STAGES[key], timings, key, t0)


def record(name: str, t0: int, t1: int, request: int = 0) -> None:
    """Record a span timed elsewhere (``perf_counter_ns`` reads), under
    ``request`` when given; its parent is the innermost span open on this
    thread."""
    if not _ON:
        return
    st = _stack()
    parent = st[-1].id if st else None
    if not request:
        request = (st[-1].request if st
                   else getattr(_local, "request", 0) or next(_ids))
    _append((name, t0, t1, next(_ids), parent, request,
             threading.get_ident()))


@contextlib.contextmanager
def _as_request(rid: int):
    prev = getattr(_local, "request", 0)
    _local.request = rid
    try:
        yield
    finally:
        _local.request = prev


def request(rid: int):
    """``with request(rid):`` makes the root spans this thread opens join
    request ``rid`` (one that crosses threads)."""
    return _as_request(rid) if _ON and rid else _NULL
