"""Synthetic clique queries (MPDP paper, SIGMOD 2022, §7.1).

A frozen copy of ``clique`` in the port's ``workloads/generators.py``:
every pair of relations is joined, the same ``random.Random`` draws in the
same order (the cardinalities, then one selectivity an edge), emitted as
the wire dict of ``wire.make_wire``.  The draws move only the statistics:
the connected sets, blocks and lane spaces of a clique of ``n`` relations
are the same for every seed.
"""
from __future__ import annotations

import random

from .wire import make_wire


def query(n: int, seed: int) -> dict:
    """Clique join graph: cardinalities U(1e2, 1e6), per-edge selectivity
    10^U(-4, -1)."""
    r = random.Random(seed)
    cards = [r.uniform(1e2, 1e6) for _ in range(n)]
    edges, sels = [], []
    for i in range(n):
        for j in range(i + 1, n):
            edges.append((i, j))
            sels.append(10.0 ** r.uniform(-4.0, -1.0))
    return make_wire(n, edges, cards, sels)
