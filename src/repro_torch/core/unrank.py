"""Combinatorial-number-system unranking of k-subsets (paper §2.2.1 / Alg. 5).

rank r in [0, C(n, k)) -> bitmap of the r-th k-subset of {0..n-1} in
colexicographic order.  The binomial table is a small int32 tensor, so one
code path covers every level of every query in an NMAX bucket.
"""
from __future__ import annotations

from functools import lru_cache
from math import comb

import numpy as np
import torch


@lru_cache(maxsize=None)
def binom_table(nmax: int) -> np.ndarray:
    """int32[(nmax+1), (nmax+1)] Pascal table, clamped to int32 max."""
    t = np.zeros((nmax + 1, nmax + 1), dtype=np.int64)
    for i in range(nmax + 1):
        for j in range(nmax + 1):
            t[i, j] = min(comb(i, j), np.iinfo(np.int32).max)
    return t.astype(np.int32)


def unrank_ksubset(rank: torch.Tensor, k: int, binom: torch.Tensor,
                   nmax: int) -> torch.Tensor:
    """Vectorised colex unranking.  rank: i32[...], k: int -> i32[...]."""
    r = rank.to(torch.int32)
    out = torch.zeros_like(r)
    kk = torch.full_like(r, k)
    for i in range(nmax):
        v = nmax - 1 - i
        c = binom[v][kk]                       # C(v, kk): per-lane gather
        take = (kk > 0) & (r >= c)
        out = torch.where(take, out | (1 << v), out)
        r = torch.where(take, r - c, r)
        kk = torch.where(take, kk - 1, kk)
    return out


def np_unrank_ksubset(rank: int, k: int, n: int) -> int:
    """Host mirror of ``unrank_ksubset`` on Python ints: the ``rank``-th
    ``k``-subset of {0..n-1} in colex order."""
    out = 0
    r = rank
    kk = k
    for v in range(n - 1, -1, -1):
        if kk == 0:
            break
        c = comb(v, kk)
        if r >= c:
            out |= 1 << v
            r -= c
            kk -= 1
    return out
