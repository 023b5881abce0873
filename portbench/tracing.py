"""Spans, and captured kernel launches, recorded from the benchmark's own
files around calls into the program's layers.

Only a ``--trace 1`` run installs anything: each span is a wrapper set on
a module or class attribute of the program (``"pkg.module:attr"`` or
``"pkg.module:Class.method"``), recording ``(name, start, end, thread,
extra)`` with ``time.perf_counter``; ``extra`` is what the span's
``summarize`` function makes of the call's return value.  A launch capture
wraps one of the port's kernel wrappers in ``repro_torch.kernels.ops`` and,
while ``capturing`` is set, keeps a copy of the launch's arguments and
outputs for the work arithmetic of ``yardstick/work.py``.  ``restore``
puts every attribute back.
"""
from __future__ import annotations

import functools
import importlib
import threading
import time

import torch

# spans that name what the host was doing during the device's idle gaps
# (with the spans the cell's metrics declare, such as phase A's)
GAP_SPANS = {
    "client.wait": "repro_torch.daemon.client:DaemonClient._call",
    "daemon.job": "repro_torch.daemon.server:OptimizerDaemon._run_job",
    "service.stream": "repro_torch.core.service:StreamOptimizer.optimize_stream",
    "flight.levels": "repro_torch.core.batch:BatchEngine.run_levels",
    "flight.collect": "repro_torch.core.batch:BatchEngine.collect",
    "solo.optimize": "repro_torch.core.engine:optimize",
    "batch.optimize_many": "repro_torch.core.batch:optimize_many",
    "heuristics.solve": "repro_torch.heuristics.uniondp:solve",
    "host.rows": "repro_torch.core.cost:np_rows_for_sets",
}


def _resolve(target: str):
    """``"pkg.mod:A.b"`` -> (owner object, attribute name)."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def _copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class Recorder:
    """Spans and launch captures of one traced run."""

    def __init__(self):
        self.spans: list[tuple] = []          # (name, t0, t1, tid, extra)
        self.launches: list[tuple] = []       # (name, args, outputs)
        self.capturing = False
        self._lock = threading.Lock()
        self._saved: list[tuple] = []
        self._local = threading.local()

    # --------------------------------------------------------------- spans --
    def span(self, name: str, target: str, summarize=None) -> None:
        """Record a span around every call of ``target``.  A span does not
        nest in one of the same name on its thread (the outer one counts),
        so a recursive entry point is timed once."""
        owner, attr = _resolve(target)
        real = getattr(owner, attr)
        rec = self

        @functools.wraps(real)
        def wrapper(*a, **kw):
            active = rec._local.__dict__.setdefault("active", set())
            if name in active:
                return real(*a, **kw)
            active.add(name)
            t0 = time.perf_counter()
            try:
                out = real(*a, **kw)
            finally:
                t1 = time.perf_counter()
                active.discard(name)
            extra = summarize(out) if summarize is not None else None
            with rec._lock:
                rec.spans.append((name, t0, t1, threading.get_ident(), extra))
            return out

        self._saved.append((owner, attr, real))
        setattr(owner, attr, wrapper)

    def spans_named(self, name: str) -> list[tuple]:
        with self._lock:
            return [s for s in self.spans if s[0] == name]

    # ------------------------------------------------------------ launches --
    def capture(self, kernel: str, arg_names) -> None:
        """Keep copies of each launch of ``ops.<kernel>`` while
        ``capturing`` is set."""
        owner, attr = _resolve(f"repro_torch.kernels.ops:{kernel}")
        real = getattr(owner, attr)
        rec = self

        @functools.wraps(real)
        def wrapper(*a, **kw):
            out = real(*a, **kw)
            if rec.capturing:
                args = dict(zip(arg_names, a))
                args.update(kw)
                outs = out if isinstance(out, tuple) else (out,)
                item = (kernel, {k: _copy(v) for k, v in args.items()},
                        tuple(_copy(o) for o in outs))
                with rec._lock:
                    rec.launches.append(item)
            return out

        self._saved.append((owner, attr, real))
        setattr(owner, attr, wrapper)

    def restore(self) -> None:
        for owner, attr, real in reversed(self._saved):
            setattr(owner, attr, real)
        self._saved.clear()


def clip(t0: float, t1: float, w0: float, w1: float) -> float:
    """Length of [t0, t1] inside the window [w0, w1]."""
    return max(0.0, min(t1, w1) - max(t0, w0))

