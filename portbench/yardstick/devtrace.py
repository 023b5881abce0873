"""A profiled sub-window of device activity, and what it says.

``DeviceTrace`` runs ``torch.profiler`` with CUDA activity only (a
window's 10^5 device events are read from the raw Kineto events: building
the profiler's event tree over them takes minutes).  From the events it
gives the busy seconds (the union of every kernel, copy and set on the
device), the device time by name, the idle gaps between busy stretches,
and each lane-building kernel's launches and seconds.

Kineto stamps device events on the Unix clock in nanoseconds; the host
spans are on ``time.perf_counter``.  The pair of clocks read when the
window opens maps one onto the other, and ``aligned`` says whether the
mapped events fell inside the window.
"""
from __future__ import annotations

import re
import time

from .work import KERNELS


def kernel_of(name: str):
    """The port's kernel wrapper whose CUDA kernel a trace name is, or None."""
    for k, (sym, _) in KERNELS.items():
        if re.search(rf"(^|[^A-Za-z0-9_]){re.escape(sym)}(?![A-Za-z0-9_])",
                     name):
            return k
    return None


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.events: list[tuple] = []      # (name, start s, end s) on perf
        self.w0 = self.w1 = 0.0
        self.aligned = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._unix_minus_perf = time.time_ns() - time.perf_counter_ns()
        self.w0 = time.perf_counter()

    def stop(self) -> None:
        self.w1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        cuda = DeviceType.CUDA
        off = self._unix_minus_perf
        self.events = [(e.name(), (e.start_ns() - off) / 1e9,
                        (e.end_ns() - off) / 1e9)
                       for e in self.prof.profiler.kineto_results.events()
                       if e.device_type() == cuda]
        self.prof = None
        inside = sum(1 for _, a, _ in self.events
                     if self.w0 - 0.05 <= a <= self.w1 + 0.05)
        self.aligned = bool(self.events) and inside >= 0.9 * len(self.events)

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def kernel_events(self) -> int:
        """Device events that are kernels (not copies or sets)."""
        return sum(1 for name, _, _ in self.events
                   if not name.startswith(("Memcpy", "Memset")))

    def busy_intervals(self) -> list[tuple]:
        """Merged busy stretches of the device, in event time."""
        out = []
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def by_name(self) -> dict:
        """name -> (events, device seconds)."""
        out: dict = {}
        for name, a, b in self.events:
            n, s = out.get(name, (0, 0.0))
            out[name] = (n + 1, s + (b - a))
        return out

    def kernels(self) -> dict:
        """lane-building kernel wrapper -> (launches, device seconds)."""
        out: dict = {}
        for name, (n, s) in self.by_name().items():
            k = kernel_of(name)
            if k is not None:
                c, t = out.get(k, (0, 0.0))
                out[k] = (c + n, t + s)
        return out

    def gaps(self) -> list[tuple]:
        """(start, end) of each idle stretch inside the window, on the
        host clock (meaningful only when ``aligned``)."""
        out, cur = [], self.w0
        for a, b in self.busy_intervals():
            if a > cur:
                out.append((cur, min(a, self.w1)))
            cur = max(cur, b)
        if cur < self.w1:
            out.append((cur, self.w1))
        return [(a, b) for a, b in out if b > a]
