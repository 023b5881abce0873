"""Synthetic snowflake queries (MPDP paper, SIGMOD 2022, §7.1).

A frozen copy of ``snowflake`` in the port's ``workloads/generators.py``:
one fact relation, dimension chains up to ``depth`` deep with ``branch``
children each, the same ``random.Random`` draws in the same order, emitted
as the wire dict of ``wire.make_wire``.  The queries are acyclic.
"""
from __future__ import annotations

import random

from .wire import make_wire


def query(n: int, seed: int, branch: int = 3, depth: int = 4) -> dict:
    """Fact at the center; dimension chains up to ``depth`` deep."""
    r = random.Random(seed)
    cards = [r.uniform(5e6, 5e7)]
    edges, sels = [], []
    levels = {0: 0}
    frontier = [0]
    while len(cards) < n:
        nxt = []
        for p in frontier:
            for _ in range(branch):
                if len(cards) >= n:
                    break
                if levels[p] >= depth:
                    continue
                i = len(cards)
                c = r.uniform(1e2, 1e6) * (0.3 ** levels[p])
                c = max(c, 10.0)
                cards.append(c)
                edges.append((p, i))
                sels.append(min(1.0, r.uniform(0.5, 2.0) / c))
                levels[i] = levels[p] + 1
                nxt.append(i)
        if not nxt:  # everything at max depth: restart frontier at leaves
            levels = {k: 0 for k in levels}
            nxt = list(levels.keys())
        frontier = nxt
    return make_wire(n, edges, cards, sels)
