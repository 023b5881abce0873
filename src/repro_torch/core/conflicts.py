"""Conflict rules for non-inner join edges.

Copied from ``repro.core.conflicts``: what ``JoinGraph`` construction needs
(kind codes, ``normalize_kind``, the TES derivation ``analyze`` and the
effective-selectivity folding), the host plan-side checks that
``plan.validate_plan``/``plan.join_plans`` call, and the lane mask
``lane_valid_kinds`` the engines' typed chunk bodies apply on the device.
Every non-inner edge must be a bridge; a (left, right) operand pair
crossing a non-inner edge is valid iff ``TES_l ⊆ left`` and ``TES_r ⊆
right`` (either orientation for FULL).
"""
from __future__ import annotations

import numpy as np
import torch

# per-edge join-kind codes
KIND_INNER = 0
KIND_LEFT = 1
KIND_FULL = 2
KIND_SEMI = 3
KIND_ANTI = 4
KIND_NAMES = ("inner", "left", "full", "semi", "anti")
KIND_CODES = {name: code for code, name in enumerate(KIND_NAMES)}

# log2 of the assumed surviving fraction of an anti join's preserved side
ANTI_KEEP_L2 = -1.0


def normalize_kind(k) -> int:
    """Accept a kind name or code; return the code."""
    if isinstance(k, str):
        try:
            return KIND_CODES[k]
        except KeyError:
            raise ValueError(f"unknown join kind {k!r} "
                             f"(expected one of {KIND_NAMES})") from None
    k = int(k)
    if not 0 <= k < len(KIND_NAMES):
        raise ValueError(f"unknown join kind code {k}")
    return k


def _reach_excl(start: int, adj: list, u: int, v: int) -> int:
    """Vertices reachable from ``start`` without traversing edge (u, v)."""
    seen = 1 << start
    frontier = [start]
    while frontier:
        x = frontier.pop()
        nb = adj[x]
        if x == u:
            nb &= ~(1 << v)
        elif x == v:
            nb &= ~(1 << u)
        new = nb & ~seen
        while new:
            b = new & -new
            new ^= b
            seen |= b
            frontier.append(b.bit_length() - 1)
    return seen


def _set_rows_l2(s: int, cards_l2, edges, sels) -> float:
    """Host rows formula (f64): Σ member cards + Σ inside sels, clamped."""
    out = 0.0
    for v in range(len(cards_l2)):
        if (s >> v) & 1:
            out += float(cards_l2[v])
    for i, (u, v) in enumerate(edges):
        if ((s >> u) & 1) and ((s >> v) & 1):
            out += float(sels[i])
    return max(out, 0.0)


def analyze(n: int, edges, kinds, ldirs, cards_l2, sels_raw):
    """Validate a typed graph and derive ``(tes_l, tes_r, eff_sels)``.

    Raises ``ValueError`` when a non-inner edge is not a bridge or when the
    TES constraints deadlock (no valid join tree exists)."""
    m = len(edges)
    adj = [0] * n
    for (u, v) in edges:
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    tes_l = [0] * m
    tes_r = [0] * m
    for i, (u, v) in enumerate(edges):
        k = kinds[i]
        if k == KIND_INNER:
            continue
        l, r = (v, u) if ldirs[i] else (u, v)
        reach_r = _reach_excl(r, adj, u, v)
        if (reach_r >> l) & 1:
            raise ValueError(
                f"non-inner edge ({u}, {v}) [{KIND_NAMES[k]}] is not a "
                "bridge: its endpoints stay connected without it, so the "
                "conservative TES rules cannot order it")
        tes_r[i] = reach_r
        tes_l[i] = _reach_excl(l, adj, u, v) if k == KIND_FULL else (1 << l)
    _check_feasible(edges, kinds, tes_l, tes_r)
    eff = effective_sels(edges, kinds, tes_l, tes_r, cards_l2, sels_raw)
    return tuple(tes_l), tuple(tes_r), eff


def _check_feasible(edges, kinds, tes_l, tes_r) -> None:
    """Greedy assembly simulation (Kahn): a cycle in the fire-before
    relation means no valid join tree exists."""
    pend = [i for i in range(len(edges)) if kinds[i] != KIND_INNER]
    ebit = {i: (1 << edges[i][0]) | (1 << edges[i][1]) for i in pend}
    done: set[int] = set()
    while len(done) < len(pend):
        fired = False
        for i in pend:
            if i in done:
                continue
            need = tes_r[i] | (tes_l[i] if kinds[i] == KIND_FULL else 0)
            if all(j in done or (ebit[j] & ~need) or j == i for j in pend):
                done.add(i)
                fired = True
        if not fired:
            stuck = [edges[i] for i in pend if i not in done]
            raise ValueError(
                f"infeasible non-inner join configuration: edges {stuck} "
                "each require another to fire first (TES deadlock)")


def effective_sels(edges, kinds, tes_l, tes_r, cards_l2, sels_raw) -> np.ndarray:
    """Fold the per-kind output-cardinality rules into the stored f32
    selectivities, inner-bridge-first (deterministic for a given graph)."""
    eff = [float(s) for s in sels_raw]
    order = sorted((i for i in range(len(edges)) if kinds[i] != KIND_INNER),
                   key=lambda i: (bin(tes_l[i] | tes_r[i]).count("1"), i))
    for i in order:
        k = kinds[i]
        r_b = _set_rows_l2(tes_r[i], cards_l2, edges, eff)
        if k == KIND_LEFT:
            eff[i] = max(eff[i], -r_b)
        elif k == KIND_SEMI:
            eff[i] = min(eff[i], -r_b)
        elif k == KIND_ANTI:
            eff[i] = -r_b + ANTI_KEEP_L2
        elif k == KIND_FULL:
            r_a = _set_rows_l2(tes_l[i], cards_l2, edges, eff)
            eff[i] = max(eff[i], -r_b, -r_a)
    return np.minimum(np.asarray(eff, np.float32), np.float32(0.0))


def ordered_valid(lb: int, rb: int, g) -> bool:
    """Is joining ``lb`` (left operand) with ``rb`` (right) admissible under
    ``g``'s conflict rules?  Inner-only graphs are always valid."""
    if not g.typed:
        return True
    for i, (u, v) in enumerate(g.edges):
        k = g.kinds[i]
        if k == KIND_INNER:
            continue
        ub, vb = 1 << u, 1 << v
        cross = (bool(lb & ub) and bool(rb & vb)) or \
                (bool(rb & ub) and bool(lb & vb))
        if not cross:
            continue
        tl, tr = g.tes_l[i], g.tes_r[i]
        if (tl & ~lb) == 0 and (tr & ~rb) == 0:
            continue
        if k == KIND_FULL and (tl & ~rb) == 0 and (tr & ~lb) == 0:
            continue
        return False
    return True


def crossing_kind(lb: int, rb: int, g) -> int:
    """Join-kind code of the operator joining ``lb`` and ``rb``."""
    if not g.typed:
        return KIND_INNER
    k = KIND_INNER
    for i, (u, v) in enumerate(g.edges):
        ub, vb = 1 << u, 1 << v
        if (bool(lb & ub) and bool(rb & vb)) or \
                (bool(rb & ub) and bool(lb & vb)):
            k = max(k, g.kinds[i])
    return k


# ------------------------------------------------------------ device (torch) --

def lane_valid_kinds(lb, rb, ekind, elm, erm, etes_l, etes_r):
    """Conflict mask of a chunk of candidate (left, right) lanes.

    ``lb``/``rb`` are int32[chunk] bitmaps; the edge arrays are int32
    ``(emax,)`` (solo engine: one query) or ``(chunk, emax)`` (batched:
    gathered per lane by its query).  Returns ``(valid_A, valid_B,
    lane_kind)``: admissibility of the (lb, rb) and (rb, lb) orientations
    and the kind code of the crossing non-inner edge (0 if none).  Padding
    edges have ``elm = erm = 0`` and never cross."""
    def e2(a):
        return a if a.dim() == 2 else a[None, :]
    ek, lm, rm = e2(ekind), e2(elm), e2(erm)
    tl, tr = e2(etes_l), e2(etes_r)
    L = lb[:, None]
    R = rb[:, None]
    cross = (((lm & L) != 0) & ((rm & R) != 0)) | \
            (((lm & R) != 0) & ((rm & L) != 0))
    lane_kind = torch.where(cross, ek, 0).amax(dim=1)
    sub_a = ((tl & ~L) == 0) & ((tr & ~R) == 0)
    sub_b = ((tl & ~R) == 0) & ((tr & ~L) == 0)
    is_full = ek == KIND_FULL
    ok_a = (~cross) | (ek == KIND_INNER) | sub_a | (is_full & sub_b)
    ok_b = (~cross) | (ek == KIND_INNER) | sub_b | (is_full & sub_a)
    return ok_a.all(dim=1), ok_b.all(dim=1), lane_kind
