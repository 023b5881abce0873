"""Shared DP-engine helpers: the in-chunk prune and the host-side merges.

The port's copy of the helpers that ``repro.core.batch`` imports from
``repro.core.engine`` (``INF``, ``_cap``, ``_merge_best``,
``_merge_scattered``, ``_prune``).  The single-query ``ExactEngine`` comes
with the solo slice of the port.

``_prune`` is JAX's ``segment_min``/``segment_max`` pair written as
``scatter_reduce`` into buffers that start at the identities JAX gives an
empty segment (``+inf`` for cost, int32 min for the left bitmap).  Min and
max do not depend on the order of the reduction, so the result is the
same on the CPU and on the card, run after run.
"""
from __future__ import annotations

import numpy as np
import torch

INF = np.float32(np.inf)
_I32_MIN = int(np.iinfo(np.int32).min)


def _cap(n: int, lo: int = 1024) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


def _merge_best(best_cost, best_left, base, seg_cost, seg_left):
    """Fold a chunk's per-segment minima into the level's host-side best
    arrays (min cost, ties broken by max left bitmap)."""
    nseg = len(seg_cost)
    idx = base + np.arange(nseg)
    ok = (idx >= 0) & (idx < len(best_cost))
    idx = idx[ok]
    sc = seg_cost[ok]
    sl = seg_left[ok]
    better = (sc < best_cost[idx]) | ((sc == best_cost[idx]) & (sl > best_left[idx]))
    upd = idx[better]
    best_cost[upd] = sc[better]
    best_left[upd] = sl[better]


def _merge_scattered(best_cost, best_left, ks, cs, ls):
    """Fold scattered per-key candidate (cost, left) pairs into host-side
    best arrays: min cost per key, ties broken by max left bitmap."""
    np.minimum.at(best_cost, ks, cs)
    tie = cs == best_cost[ks]
    np.maximum.at(best_left, ks[tie], ls[tie])


def _prune(seg: torch.Tensor, cand_cost: torch.Tensor, cand_left: torch.Tensor,
           nseg: int):
    """Two-pass in-chunk prune: segment-min cost then max-left among ties."""
    seg = seg.long()
    seg_cost = torch.full((nseg,), float("inf"), dtype=torch.float32,
                          device=cand_cost.device)
    seg_cost.scatter_reduce_(0, seg, cand_cost, "amin")
    is_best = cand_cost == seg_cost[seg]
    left_cand = torch.where(is_best & torch.isfinite(cand_cost), cand_left, 0)
    seg_left = torch.full((nseg,), _I32_MIN, dtype=torch.int32,
                          device=cand_left.device)
    seg_left.scatter_reduce_(0, seg, left_cand, "amax")
    return seg_cost, seg_left
