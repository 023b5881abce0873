"""The wire form of a generated query, built without the program.

A query leaves the generators as the dict the optimizer daemon's protocol
carries (``n``, ``edges``, ``cards_l2``, ``sels_l2``, ``names``): edges
normalised to ``u < v``, a repeated relation pair kept once with its most
selective predicate, and the statistics rounded to float32 log2 in the same
order of operations as the port's ``JoinGraph.make``.  That one dict goes to
the program and to the reference alike.
"""
from __future__ import annotations

import numpy as np


def make_wire(n: int, edges, cards, sels, names=()) -> dict:
    """Linear-space statistics -> the wire dict of an inner-join query."""
    cards_l2 = np.log2(np.maximum(np.asarray(cards, np.float64),
                                  1.0)).astype(np.float32)
    out_edges, out_sels, seen = [], [], {}
    for (u, v), s in zip(edges, sels):
        if u == v:
            raise ValueError("self-join edge")
        sl2 = np.float32(np.log2(np.clip(np.float64(s), 1e-30, 1.0)))
        e = (min(u, v), max(u, v))
        if e in seen:
            j = seen[e]
            out_sels[j] = min(out_sels[j], sl2)
            continue
        seen[e] = len(out_edges)
        out_edges.append(e)
        out_sels.append(sl2)
    sels_l2 = np.minimum(np.asarray(out_sels, np.float32), np.float32(0.0))
    names = tuple(names) or tuple(f"R{i}" for i in range(n))
    return {"n": int(n),
            "edges": [[int(u), int(v)] for (u, v) in out_edges],
            "cards_l2": [float(np.float32(max(c, np.float32(0.0))))
                         for c in cards_l2],
            "sels_l2": [float(s) for s in sels_l2],
            "names": list(names)}


def is_connected(wire: dict) -> bool:
    n = wire["n"]
    adj = [0] * n
    for u, v in wire["edges"]:
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    seen, frontier = 1, 1
    while frontier:
        nxt = 0
        for v in range(n):
            if (frontier >> v) & 1:
                nxt |= adj[v]
        frontier = nxt & ~seen
        seen |= nxt
    return seen == (1 << n) - 1
