"""Drivers: how a mix's requests reach the system under test.

A driver module ``drivers/<name>.py`` holds a ``Driver(ctx)`` with
``setup()`` (start the system and warm it up), ``start(t_end)``,
``join(timeout)``, ``counters()`` and ``close()``.  ``ClosedLoop`` is the
shared client loop: each client thread sends a request, waits for its
answer, and sends the next, until the window closes.
"""
from __future__ import annotations

import threading
import time

from ..stream import Request, request_queries


class ClosedLoop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.requests: list[Request] = []
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self.t_end = 0.0           # no request is sent at or after it

    def answer(self, c: int, graphs):
        """(costs, plans as nested lists, the server's seconds or None)."""
        raise NotImplementedError

    def _client(self, c: int) -> None:
        ctx = self.ctx
        j = 0
        while time.perf_counter() < self.t_end:
            wires = request_queries(ctx.gen, ctx.mix, ctx.seed, c, j)
            graphs = [self.from_wire(w) for w in wires]
            t_send = time.perf_counter()
            if t_send >= self.t_end:
                break
            req = Request(client=c, j=j, wires=wires, t_send=t_send)
            try:
                req.costs, req.plans, req.server_s = self.answer(c, graphs)
            except Exception as e:                # counted as unanswered
                req.error = f"{type(e).__name__}: {e}"
            req.t_done = time.perf_counter()
            with self._lock:
                self.requests.append(req)
            j += 1

    def start(self, t_end: float) -> None:
        """Start the clients; they send until ``t_end``, which may be moved
        while they run."""
        self.t_end = t_end
        self._threads = [threading.Thread(target=self._client, args=(c,),
                                          name=f"client{c}", daemon=True)
                         for c in range(self.ctx.mix["clients"])]
        for t in self._threads:
            t.start()

    def join(self, timeout: float) -> bool:
        """Wait for each client's last request; False if one is still out."""
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return not any(t.is_alive() for t in self._threads)

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        pass
