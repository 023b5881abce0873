"""Closed-loop tenants through the port's optimizer daemon.

Set-up starts one ``repro_torch.daemon.OptimizerDaemon`` in this process on
a Unix socket under ``$TMPDIR`` (or, where that path is too long for a
socket, a short one in the working directory), on the run's device, and
connects one ``DaemonClient`` a tenant.  Each request carries the mix's
queries, as the client's graphs, under the configuration's
``OptimizerConfig``; it is timed from the client's send to its decoded
reply, whose plans the client rebuilt from the wire.
"""
from __future__ import annotations

import os
import tempfile

from ..stream import plan_shape, warmup_queries
from . import ClosedLoop


def _socket_path() -> str:
    path = os.path.join(tempfile.gettempdir(), f"portbench-{os.getpid()}.sock")
    if len(path.encode()) > 100:                 # AF_UNIX holds 108 bytes
        path = f".portbench-{os.getpid()}.sock"
    return path


class Driver(ClosedLoop):
    def setup(self) -> None:
        from repro_torch.core.config import OptimizerConfig
        from repro_torch.core.joingraph import graph_from_wire
        from repro_torch.daemon import DaemonClient, OptimizerDaemon
        ctx = self.ctx
        self.from_wire = graph_from_wire
        self.config = OptimizerConfig(**ctx.config["optimizer"])
        self.path = _socket_path()
        self.daemon = OptimizerDaemon(socket_path=self.path,
                                      device=ctx.device)
        self.daemon.start()
        self.clients = [DaemonClient(socket_path=self.path,
                                     tenant=f"tenant{c}")
                        for c in range(ctx.mix["clients"])]
        for w in warmup_queries(ctx.gen, ctx.mix, ctx.seed):
            self.clients[0].optimize([graph_from_wire(w)], self.config)
        self._hits0 = self.daemon.cache.stats.hits

    def answer(self, c: int, graphs):
        client = self.clients[c]
        res = client.optimize(graphs, self.config)
        return ([float(r.cost) for r in res], [plan_shape(r.plan) for r in res],
                float(client.last_meta["wall_s"]))

    def counters(self) -> dict:
        return {"plan_cache_hits": self.daemon.cache.stats.hits - self._hits0}

    def close(self) -> None:
        for c in self.clients:
            c.close()
        self.daemon.drain(timeout=60.0)
