"""Greedy operator ordering (GOO): repeatedly join the two connected
sub-plans whose join has the fewest rows.  The control of the heuristic
cells runs it in bfloat16 in the program's place."""
from __future__ import annotations

import numpy as np

from .costmodel import Precision


def solve(wire: dict, prec: Precision):
    """(cost, plan) of GOO's plan, costed in ``prec``."""
    n = wire["n"]
    cards = np.asarray(wire["cards_l2"], prec.dtype)
    sels = np.asarray(wire["sels_l2"], prec.dtype)
    zero = prec.c(0.0)
    units = {v: (1 << v, prec.scan_cost(np.maximum(cards[v], zero)), cards[v],
                 1 << v) for v in range(n)}   # id -> (plan, cost, raw, set)
    between: dict[tuple, object] = {}           # (a, b) a < b -> summed sel
    for (u, v), s in zip(wire["edges"], sels):
        key = (min(u, v), max(u, v))
        between[key] = prec.r(between[key] + s) if key in between else s
    while len(units) > 1:
        best = None
        for (a, b), s in between.items():
            raw = prec.r(prec.r(units[a][2] + units[b][2]) + s)
            if best is None or raw < best[0]:
                best = (raw, a, b)
        raw, a, b = best
        (pa, ca, ra, sa), (pb, cb, rb, sb) = units.pop(a), units.pop(b)
        jc = prec.join_cost(np.maximum(ra, zero), np.maximum(rb, zero),
                            np.maximum(raw, zero))
        new = min(a, b)
        units[new] = ([pa, pb], prec.r(prec.r(ca + cb) + jc), raw, sa | sb)
        merged: dict[tuple, object] = {}
        for (x, y), s in between.items():
            x2 = new if x in (a, b) else x
            y2 = new if y in (a, b) else y
            if x2 == y2:
                continue
            key = (min(x2, y2), max(x2, y2))
            merged[key] = prec.r(merged[key] + s) if key in merged else s
        between = merged
    (plan, cost, _, _), = units.values()
    return float(cost), plan
