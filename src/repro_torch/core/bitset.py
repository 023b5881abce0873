"""int32 bitmap-set primitives shared by every optimizer kernel.

Conventions (as in the reference ``repro.core.bitset``)
--------------------------------------------------------
* A *relation set* is an int32 whose bits 0..NMAX-1 mark member relations.
* NMAX <= 30, so every bitmap and every dense-memo index derived from one
  is a non-negative int32.
* ``adj`` is an ``int32[nmax]`` tensor (``adj[v]`` = neighbour bitmap of
  vertex ``v``) or, for the batched engines, per-lane rows ``adjq`` of
  shape ``(..., nmax)``: lane l sees the adjacency of its own query.  The
  ``*_rows`` functions broadcast, so the single-table names (``neighbors``,
  ``grow``, ``is_connected``) are the same functions.

The torch functions are lane-vectorised (``int32[...] -> int32[...]``) and
run on whatever device their inputs live on; they are the plain versions
behind the CUDA kernels and must agree with the reference bit for bit.
The numpy flavour at the bottom is the host mirror used by oracles and plan
validation.

Torch has no int32 popcount and no OR-reduction, so ``popcount`` is the
SWAR bit count and ``_or_last`` folds the last axis pairwise.  The
reference's ``while_loop``s (grow until no lane changes) are Python loops
that stop at the same fixed point.
"""
from __future__ import annotations

import numpy as np
import torch

NMAX_HARD = 30  # int32-sign-safe ceiling for exact algorithms


def nmax_bucket(n: int) -> int:
    """Static NMAX bucket for a query of ``n`` relations."""
    if n > NMAX_HARD:
        raise ValueError(f"exact bitmap algorithms support n <= {NMAX_HARD}, got {n}")
    for b in (8, 16, 24, 30):
        if n <= b:
            return b
    return NMAX_HARD


# ---------------------------------------------------------------------------
# torch flavour (lane-vectorised: every function maps int32[...] -> int32[...])
# ---------------------------------------------------------------------------

def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element bit count of int32 ``x`` (bit 31 included), SWAR.

    Arithmetic right shifts only differ from logical ones in bits that the
    masks clear, and the byte sums below never overflow, so this equals
    the unsigned count for every int32 input."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def lsb(x: torch.Tensor) -> torch.Tensor:
    """Lowest set bit of ``x`` (0 if x == 0): x & (~x + 1)."""
    return x & (~x + 1)


def _shifts(nmax: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(nmax, dtype=torch.int32, device=like.device)


def _or_last(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the last axis (pairwise folding)."""
    while x.shape[-1] > 1:
        if x.shape[-1] & 1:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] | x[..., 1::2]
    return x[..., 0]


def member_matrix(s: torch.Tensor, nmax: int) -> torch.Tensor:
    """(...,) int32 -> (..., nmax) int32 0/1 membership of each vertex."""
    return (s[..., None] >> _shifts(nmax, s)) & 1


def neighbors_rows(s: torch.Tensor, adjq: torch.Tensor) -> torch.Tensor:
    """OR of ``adjq[..., v]`` over all v in s.  ``adjq`` is the shared
    ``(nmax,)`` table or per-lane ``(..., nmax)`` rows (broadcast)."""
    mem = member_matrix(s, adjq.shape[-1]).bool()
    return _or_last(torch.where(mem, adjq, 0))


neighbors = neighbors_rows


def grow_rows(src: torch.Tensor, restrict: torch.Tensor,
              adjq: torch.Tensor) -> torch.Tensor:
    """Paper §3.2.1 grow(): all vertices of ``restrict`` reachable from
    ``src``; sweeps until no lane changes."""
    cur = src & restrict
    while True:
        nxt = (cur | neighbors_rows(cur, adjq)) & restrict
        if torch.equal(nxt, cur):
            return cur
        cur = nxt


grow = grow_rows


def is_connected_rows(s: torch.Tensor, adjq: torch.Tensor) -> torch.Tensor:
    """G[s] connected? (singletons/empty count as connected)."""
    return grow_rows(lsb(s), s, adjq) == s


is_connected = is_connected_rows


def grow_excl_edge_rows(src, restrict, adjq, ubit, vbit):
    """grow() on the graph with the lane's edge (u, v) removed — the
    batched MPDP:Tree split.  ``ubit``/``vbit`` are per-lane one-bit masks
    (0 for padding edges, which exclude nothing)."""
    nmax = adjq.shape[-1]
    sh = _shifts(nmax, src)
    row_is_u = ((ubit[..., None] >> sh) & 1).bool()
    row_is_v = ((vbit[..., None] >> sh) & 1).bool()
    excl = (torch.where(row_is_u, vbit[..., None], 0)
            | torch.where(row_is_v, ubit[..., None], 0))
    rows = adjq & ~excl                                  # (..., nmax)
    return grow_rows(src, restrict, rows)


def pdep(rank: torch.Tensor, mask: torch.Tensor, nmax: int) -> torch.Tensor:
    """Parallel bit deposit: scatter the low ``popcount(mask)`` bits of rank
    onto the set bit positions of ``mask`` (paper §2.2.1)."""
    sh = _shifts(nmax, mask)
    below = (torch.ones_like(sh) << sh) - 1             # (nmax,)
    k = popcount(mask[..., None] & below)               # bits of mask below b
    mask_bit = (mask[..., None] >> sh) & 1
    take = (rank[..., None] >> k) & 1
    return _or_last((mask_bit & take) << sh)


# ---------------------------------------------------------------------------
# numpy flavour (host mirror — oracles, plan validation)
# ---------------------------------------------------------------------------

def np_popcount(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24).astype(np.int32)


def np_neighbors(s: int, adj) -> int:
    out = 0
    v = 0
    ss = int(s)
    while ss:
        if ss & 1:
            out |= int(adj[v])
        ss >>= 1
        v += 1
    return out


def np_grow(src: int, restrict: int, adj) -> int:
    cur = int(src) & int(restrict)
    while True:
        nxt = (cur | np_neighbors(cur, adj)) & int(restrict)
        if nxt == cur:
            return cur
        cur = nxt


def np_is_connected(s: int, adj) -> bool:
    if s == 0:
        return True
    return np_grow(s & (-s), s, adj) == s


def iter_bits(s: int):
    v = 0
    while s:
        if s & 1:
            yield v
        s >>= 1
        v += 1


def np_pdep(rank: int, mask: int) -> int:
    out = 0
    for b in iter_bits(mask):
        if rank & 1:
            out |= 1 << b
        rank >>= 1
    return out
