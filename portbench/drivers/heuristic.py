"""Closed-loop clients calling the port's large-query heuristic in this
process: ``repro_torch.heuristics.<name>.solve`` with the configuration's
settings on the run's device, one query a call (the entry the port's
query-service example uses for queries past the exact limit).  A call is
timed from its start to its return."""
from __future__ import annotations

import importlib

from ..stream import plan_shape, warmup_queries
from . import ClosedLoop


class Driver(ClosedLoop):
    def setup(self) -> None:
        from repro_torch.core.joingraph import graph_from_wire
        from repro_torch.kernels import build
        ctx = self.ctx
        settings = dict(ctx.config["heuristic"])
        self._mod = importlib.import_module(
            f"repro_torch.heuristics.{settings.pop('name')}")
        self._settings = settings
        self.from_wire = graph_from_wire
        if ctx.device.type == "cuda":
            build.library()
        for w in warmup_queries(ctx.gen, ctx.mix, ctx.seed):
            self._solve(graph_from_wire(w))

    def _solve(self, g):
        return self._mod.solve(g, device=self.ctx.device, **self._settings)

    def answer(self, c: int, graphs):
        res = [self._solve(g) for g in graphs]
        return ([float(r.cost) for r in res], [plan_shape(r.plan) for r in res],
                None)
