"""PostgreSQL-flavoured cost model (paper §7.1), torch and numpy twins.

Same constants and formulas as ``repro.core.cost``:

    scan(R)          = C_SEQ * rows(R)
    hash(l, r)       = C_HASH_BUILD*inner + C_HASH_PROBE*outer + C_TUP*out
    merge(l, r)      = C_SORT*(l*log2 l + r*log2 r) + C_MERGE*(l+r) + C_TUP*out
    nestloop(l, r)   = C_NL * l * r + C_TUP*out          (computed in log2 space)

Cardinalities are log2 (f32); costs are linear f32 with rows clamped at
2**LOG2_CAP.  The torch ``join_cost`` costs the DP lanes on the engine's
device; ``exp2`` and operation fusion differ between XLA, numpy, torch on
the CPU and CUDA, so lane costs agree with the reference to a relative
1e-5, not bit for bit.  Memo rows and leaf costs are host numpy, copied
from the reference, and are bit-identical.
"""
from __future__ import annotations

import numpy as np
import torch

# cost-model constants (dimensionless "PostgreSQL cost units")
C_SEQ = 0.35
C_HASH_BUILD = 1.8
C_HASH_PROBE = 0.55
C_MERGE = 0.4
C_SORT = 0.25
C_NL = 0.02
C_TUP = 0.05
LOG2_CAP = 100.0  # rows clamp: 2^100 ~ 1.27e30 -> costs stay < ~1e33 << f32 max


# ------------------------------------------------------------------- torch --

def rows_from_log2(rl2: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.clamp(rl2, max=LOG2_CAP))


def scan_cost(rl2: torch.Tensor) -> torch.Tensor:
    return C_SEQ * rows_from_log2(rl2)


def join_cost(rl2_l: torch.Tensor, rl2_r: torch.Tensor,
              rl2_out: torch.Tensor) -> torch.Tensor:
    """Cheapest physical operator for joining (l, r) -> out.  All log2 rows."""
    rl = rows_from_log2(rl2_l)
    rr = rows_from_log2(rl2_r)
    ro = rows_from_log2(rl2_out)
    inner = torch.minimum(rl, rr)
    outer = torch.maximum(rl, rr)
    hj = C_HASH_BUILD * inner + C_HASH_PROBE * outer + C_TUP * ro
    lg_l = torch.clamp(rl2_l, min=1.0)
    lg_r = torch.clamp(rl2_r, min=1.0)
    mj = C_SORT * (rl * lg_l + rr * lg_r) + C_MERGE * (rl + rr) + C_TUP * ro
    nl = C_NL * torch.exp2(torch.clamp(rl2_l + rl2_r, max=LOG2_CAP)) + C_TUP * ro
    return torch.minimum(hj, torch.minimum(mj, nl))


def join_cost_kind(rl2_l: torch.Tensor, rl2_r: torch.Tensor,
                   rl2_out: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """Kind-aware ``join_cost`` (``rl2_l`` = the LEFT operand, preserved or
    probe side): inner/left/full keep the three-operator minimum, semi/anti
    (kind >= 3) are pinned to the hash plan that builds on the filtering
    right side and probes the preserved left.  ``kind`` is a per-lane
    ``conflicts.KIND_*`` code."""
    base = join_cost(rl2_l, rl2_r, rl2_out)
    rl = rows_from_log2(rl2_l)
    rr = rows_from_log2(rl2_r)
    ro = rows_from_log2(rl2_out)
    hj = C_HASH_BUILD * rr + C_HASH_PROBE * rl + C_TUP * ro
    return torch.where(kind >= 3, hj, base)


# ------------------------------------------------------------------- numpy --

def np_rows_from_log2(rl2):
    return np.exp2(np.minimum(np.float32(rl2), np.float32(LOG2_CAP)), dtype=np.float32)


def np_scan_cost(rl2):
    return np.float32(C_SEQ) * np_rows_from_log2(rl2)


def np_join_cost(rl2_l, rl2_r, rl2_out):
    rl = np_rows_from_log2(rl2_l)
    rr = np_rows_from_log2(rl2_r)
    ro = np_rows_from_log2(rl2_out)
    inner = np.minimum(rl, rr)
    outer = np.maximum(rl, rr)
    hj = np.float32(C_HASH_BUILD) * inner + np.float32(C_HASH_PROBE) * outer + np.float32(C_TUP) * ro
    lg_l = np.maximum(np.float32(rl2_l), np.float32(1.0))
    lg_r = np.maximum(np.float32(rl2_r), np.float32(1.0))
    mj = (np.float32(C_SORT) * (rl * lg_l + rr * lg_r)
          + np.float32(C_MERGE) * (rl + rr) + np.float32(C_TUP) * ro)
    nl = (np.float32(C_NL) * np.exp2(np.minimum(np.float32(rl2_l) + np.float32(rl2_r),
                                                np.float32(LOG2_CAP)), dtype=np.float32)
          + np.float32(C_TUP) * ro)
    return np.minimum(hj, np.minimum(mj, nl))


def np_join_cost_kind(rl2_l, rl2_r, rl2_out, kind):
    """Kind-aware ``np_join_cost`` (``rl2_l`` = left operand): semi/anti
    (kind >= 3) are pinned to the hash plan building on the right side."""
    base = np_join_cost(rl2_l, rl2_r, rl2_out)
    rl = np_rows_from_log2(rl2_l)
    rr = np_rows_from_log2(rl2_r)
    ro = np_rows_from_log2(rl2_out)
    hj = (np.float32(C_HASH_BUILD) * rr + np.float32(C_HASH_PROBE) * rl
          + np.float32(C_TUP) * ro)
    return np.where(np.asarray(kind) >= 3, hj, base)


# ----------------------------------------------- partition-boundary helper --

def np_boundary_cost(rl2_a, rl2_b, sel_l2) -> np.float32:
    """Cost of the *boundary join* between two partitions (UnionDP's merge
    score): ``rl2_a``/``rl2_b`` are their aggregated log2 rows, ``sel_l2``
    the summed log2 selectivity of every edge crossing the boundary; the
    join yields ``max(rl2_a + rl2_b + sel_l2, 0)`` log2 rows and costs the
    cheapest physical operator's price.  Cast to f32 in the reference's
    order, so the score is bit-identical to it."""
    ra = np.float32(rl2_a)
    rb = np.float32(rl2_b)
    out = np.maximum(ra + rb + np.float32(sel_l2), np.float32(0.0))
    return np_join_cost(ra, rb, out)


# --------------------------------------------------- set-cardinality helper --

def np_rows_for_sets(sets_np: np.ndarray, g) -> np.ndarray:
    """log2 rows for a batch of relation sets of ``g`` — f32[len(sets_np)].

    The canonical host rows computation: it depends only on the query's
    true ``n``/``m`` (never on NMAX/EMAX padding), so a query gets the same
    memo rows alone or in any batch bucket.
    """
    sets_np = np.asarray(sets_np, np.int32)   # NMAX_HARD = 30: bitmaps fit
    if not len(sets_np):
        return np.zeros(0, np.float32)
    eu = np.array([1 << u for (u, v) in g.edges], np.int32)
    ev = np.array([1 << v for (u, v) in g.edges], np.int32)
    shifts = np.arange(g.n, dtype=np.int32)
    out = np.empty(len(sets_np), np.float32)
    # slice the level: per-set values are independent, so slicing never
    # changes a result bit
    step = 1 << 15
    for s0 in range(0, len(sets_np), step):
        sl = sets_np[s0: s0 + step]
        mem = (sl[:, None] >> shifts) & 1
        rows = mem.astype(np.float32) @ g.log2_card
        if g.m:
            inside = ((sl[:, None] & eu) != 0) & ((sl[:, None] & ev) != 0)
            rows = rows + np.where(inside, g.log2_sel, np.float32(0.0)).sum(
                axis=1, dtype=np.float32)
        out[s0: s0 + step] = np.maximum(rows, np.float32(0.0))
    return out


def np_corrected_graph(g, rows_l2: dict):
    """``g`` with per-relation log2 cardinalities replaced by learned values.

    ``rows_l2`` maps relation name -> corrected log2 rows (typically
    ``policy.PolicyTable.drift_rows()``).  Relations not named keep their
    stats; with no matching name ``g`` itself is returned (the same
    object, so callers can test identity).  Edge selectivities are left
    alone.  A typed graph is rebuilt from its raw stats, so its effective
    selectivities fold the new cards exactly as the reference's do.
    """
    import dataclasses
    new = np.array(g.log2_card, np.float32, copy=True)
    changed = False
    for v, name in enumerate(g.names):
        if name in rows_l2:
            val = np.float32(max(float(rows_l2[name]), 0.0))
            if val != new[v]:
                new[v] = val
                changed = True
    if not changed:
        return g
    if g.typed:
        fans = None
        if g.fan_l2 is not None and len(g.fan_l2):
            fans = [float(f) if np.isfinite(f) else None for f in g.fan_l2]
        raw = g.log2_sel_raw if g.log2_sel_raw is not None else g.log2_sel
        return type(g).from_log2(
            n=g.n, edges=list(g.edges), cards_l2=new,
            sels_l2=[float(np.float32(raw[i])) for i in range(g.m)],
            kinds=g.kinds, ldirs=g.ldirs, fans_l2=fans, names=g.names)
    return dataclasses.replace(g, log2_card=new)


def np_rows_log2(s: int, g) -> np.float32:
    """log2 rows of the join over relation set ``s`` (host; JoinGraph g)."""
    out = np.float32(0.0)
    for v in range(g.n):
        if (s >> v) & 1:
            out += np.float32(g.log2_card[v])
    for i, (u, v) in enumerate(g.edges):
        if ((s >> u) & 1) and ((s >> v) & 1):
            out += np.float32(g.log2_sel[i])
    return np.float32(max(out, 0.0))
