"""Host-side join-query representation (paper §2.1) and its device mirror.

``JoinGraph`` is the reference's immutable numpy query (relations, edges,
log2 stats, typed-edge metadata), copied so that the same construction
gives the same bits.  ``DeviceGraph`` holds the padded int32/f32 tensors
of one query on an explicit torch device.  ``graph_to_wire`` /
``graph_from_wire`` are the port's copy of the daemon's pure-literal graph
codec: a reference graph sent through the reference ``graph_to_wire`` and
rebuilt here has bit-identical ``log2_card``/``log2_sel``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from . import bitset as bs
from . import conflicts as cf


def _norm_edges(edges, sels, kinds, ldirs, fans):
    """Normalize (u, v) -> (min, max) with the direction bit following the
    swap; dedup same-pair predicates (two inner predicates keep the more
    selective one; a duplicate involving a non-inner kind raises)."""
    norm, seen = [], {}
    nsel, nkind, nldir, nfan = [], [], [], []
    for i, (u, v) in enumerate(edges):
        if u == v:
            raise ValueError("self-join edge")
        k = cf.normalize_kind(kinds[i]) if kinds else cf.KIND_INNER
        d = int(ldirs[i]) if ldirs else 0
        if k == cf.KIND_INNER:
            d = 0
        elif u > v:
            d ^= 1
        e = (min(u, v), max(u, v))
        s = float(sels[i])
        f = float(fans[i]) if fans is not None and fans[i] is not None \
            else float("nan")
        if e in seen:
            j = seen[e]
            if k != cf.KIND_INNER or nkind[j] != cf.KIND_INNER:
                raise ValueError(
                    f"duplicate predicates on relation pair {e} with join "
                    f"kinds {cf.KIND_NAMES[nkind[j]]!r} / "
                    f"{cf.KIND_NAMES[k]!r}: non-inner duplicates cannot be "
                    "merged")
            if s < nsel[j]:        # keep the most selective inner predicate
                nsel[j] = s
                nfan[j] = f
            continue
        seen[e] = len(norm)
        norm.append(e)
        nsel.append(s)
        nkind.append(k)
        nldir.append(d)
        nfan.append(f)
    return norm, nsel, nkind, nldir, nfan


def _build(n, norm, nsel, nkind, nldir, nfan, cards_l2, names):
    """Shared tail of make()/from_log2(): typed analysis + field assembly."""
    if not names:
        names = tuple(f"R{i}" for i in range(n))
    sel_raw = np.minimum(np.asarray(nsel, np.float32), np.float32(0.0))
    fan = np.asarray(nfan, np.float32) if nfan else np.zeros(0, np.float32)
    explicit = bool(len(fan)) and bool(np.isfinite(fan).any())
    typed = any(k != cf.KIND_INNER for k in nkind)
    if typed:
        tes_l, tes_r, eff = cf.analyze(n, norm, nkind, nldir,
                                       cards_l2, sel_raw)
        return JoinGraph(
            n=n, edges=tuple(norm), log2_card=cards_l2, log2_sel=eff,
            names=tuple(names), kinds=tuple(nkind), ldirs=tuple(nldir),
            log2_sel_raw=sel_raw, fan_l2=fan if explicit else None,
            tes_l=tes_l, tes_r=tes_r)
    return JoinGraph(
        n=n, edges=tuple(norm), log2_card=cards_l2, log2_sel=sel_raw,
        names=tuple(names), fan_l2=fan if explicit else None)


@dataclasses.dataclass(frozen=True)
class JoinGraph:
    """Immutable join query: n relations, edges with kinds + selectivities."""

    n: int
    edges: tuple[tuple[int, int], ...]          # (u, v) with u < v, deduped
    log2_card: np.ndarray                       # f32[n]  log2(base cardinality)
    log2_sel: np.ndarray                        # f32[m]  log2(effective sel) (<= 0)
    names: tuple[str, ...] = ()
    kinds: tuple[int, ...] = ()                 # per-edge KIND_* (() = all inner)
    ldirs: tuple[int, ...] = ()                 # 1 -> v is the left operand
    log2_sel_raw: Optional[np.ndarray] = None   # f32[m] raw sels (typed only)
    fan_l2: Optional[np.ndarray] = None         # f32[m] explicit fans (NaN = derived)
    tes_l: tuple[int, ...] = ()                 # per-edge TES bitmaps (typed only)
    tes_r: tuple[int, ...] = ()

    @staticmethod
    def make(n: int,
             edges: Sequence[tuple[int, int]],
             cards: Sequence[float],
             sels: Sequence[float],
             names: Sequence[str] = (),
             kinds: Sequence = (),
             ldirs: Sequence[int] = (),
             fanouts: Optional[Sequence] = None) -> "JoinGraph":
        """Build from linear-space stats.  ``fanouts`` optionally gives
        |u ⋈ v| per edge (``None`` entries = PK-FK default); an explicit
        fan derives that edge's selectivity."""
        cards_l2 = np.log2(np.maximum(np.asarray(cards, np.float64),
                                      1.0)).astype(np.float32)
        sels_l2, fans_l2 = [], []
        for i, s in enumerate(sels):
            f = None if fanouts is None else fanouts[i]
            if f is not None:
                u, v = edges[i]
                fl2 = np.float32(np.log2(max(float(f), 1.0)))
                sels_l2.append(np.float32(float(fl2) - float(cards_l2[u])
                                          - float(cards_l2[v])))
                fans_l2.append(float(fl2))
            else:
                sels_l2.append(np.float32(np.log2(
                    np.clip(np.float64(s), 1e-30, 1.0))))
                fans_l2.append(None)
        norm, nsel, nkind, nldir, nfan = _norm_edges(
            edges, sels_l2, kinds, ldirs, fans_l2)
        return _build(n, norm, nsel, nkind, nldir, nfan, cards_l2,
                      tuple(names))

    @staticmethod
    def from_log2(n: int,
                  edges: Sequence[tuple[int, int]],
                  cards_l2: Sequence[float],
                  sels_l2: Sequence[float],
                  names: Sequence[str] = (),
                  kinds: Sequence = (),
                  ldirs: Sequence[int] = (),
                  fans_l2: Optional[Sequence] = None) -> "JoinGraph":
        """Like make(), but stats already in log2 space; ``fans_l2`` entries
        are carried as explicit fan stats, never re-derived."""
        fans = list(fans_l2) if fans_l2 is not None else None
        norm, nsel, nkind, nldir, nfan = _norm_edges(
            edges, sels_l2, kinds, ldirs, fans)
        cl2 = np.maximum(np.asarray(cards_l2, np.float32), 0.0)
        return _build(n, norm, nsel, nkind, nldir, nfan, cl2, tuple(names))

    @property
    def m(self) -> int:
        return len(self.edges)

    @property
    def full_set(self) -> int:
        return (1 << self.n) - 1

    @property
    def typed(self) -> bool:
        """True when any edge is non-inner (conflict rules apply)."""
        return bool(self.kinds) and any(k != cf.KIND_INNER for k in self.kinds)

    def kind(self, i: int) -> int:
        return self.kinds[i] if self.kinds else cf.KIND_INNER

    def left_op(self, i: int) -> int:
        """Left-operand (preserved/probe side) vertex of edge ``i``."""
        u, v = self.edges[i]
        return v if (self.ldirs and self.ldirs[i]) else u

    def adjacency(self) -> list:
        """Python-int neighbour bitmaps."""
        adj = [0] * self.n
        for (u, v) in self.edges:
            adj[u] |= 1 << v
            adj[v] |= 1 << u
        return adj

    def is_connected(self) -> bool:
        if self.n == 0:
            return True
        return bs.np_grow(1, self.full_set, self.adjacency()) == self.full_set

    def is_tree(self) -> bool:
        return self.m == self.n - 1 and self.is_connected()


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Padded device-side mirror of a JoinGraph (NMAX/EMAX bucketed).  The
    conflict arrays (``typed_edge_arrays``) are on the device only for a
    typed graph; an inner-only one has ``None`` there and the engines pass
    no conflict arrays for it."""

    n: int
    m: int
    nmax: int
    emax: int
    adj: torch.Tensor        # i32[nmax]    adjacency bitmaps
    emask_u: torch.Tensor    # i32[emax]    1 << u  (0 pad)
    emask_v: torch.Tensor    # i32[emax]    1 << v  (0 pad)
    esel_l2: torch.Tensor    # f32[emax]    log2 effective selectivity (0 pad)
    card_l2: torch.Tensor    # f32[nmax]    log2 base cardinality (0 pad)
    typed: bool = False      # any non-inner edge?
    ekind: Optional[torch.Tensor] = None    # i32[emax] KIND_* code (0 pad)
    elm: Optional[torch.Tensor] = None      # i32[emax] 1 << left operand
    erm: Optional[torch.Tensor] = None      # i32[emax] 1 << right operand
    etes_l: Optional[torch.Tensor] = None   # i32[emax] TES bitmap, left side
    etes_r: Optional[torch.Tensor] = None   # i32[emax] TES bitmap, right side

    @staticmethod
    def from_graph(g: JoinGraph, device) -> "DeviceGraph":
        nmax = bs.nmax_bucket(g.n)
        emax = max(8, int(np.ceil(max(g.m, 1) / 8.0)) * 8)
        adj = np.zeros(nmax, np.int32)
        for (u, v) in g.edges:
            adj[u] |= 1 << v
            adj[v] |= 1 << u
        eu = np.zeros(emax, np.int32)
        ev = np.zeros(emax, np.int32)
        es = np.zeros(emax, np.float32)
        for i, (u, v) in enumerate(g.edges):
            eu[i] = 1 << u
            ev[i] = 1 << v
            es[i] = g.log2_sel[i]
        cl = np.zeros(nmax, np.float32)
        cl[: g.n] = g.log2_card

        def put(a):
            return torch.from_numpy(a).to(device)

        conflict = {}
        if g.typed:
            conflict = dict(zip(("ekind", "elm", "erm", "etes_l", "etes_r"),
                                map(put, typed_edge_arrays(g, emax))))
        return DeviceGraph(n=g.n, m=g.m, nmax=nmax, emax=emax, adj=put(adj),
                           emask_u=put(eu), emask_v=put(ev), esel_l2=put(es),
                           card_l2=put(cl), typed=g.typed, **conflict)


def typed_edge_arrays(g: JoinGraph, emax: int):
    """Padded int32[emax] conflict arrays (kind, left- and right-operand
    masks, TES bitmaps) for the engines' lane mask; all zero for an
    inner-only graph (zero pad edges never constrain a lane)."""
    ekind = np.zeros(emax, np.int32)
    elm = np.zeros(emax, np.int32)
    erm = np.zeros(emax, np.int32)
    etl = np.zeros(emax, np.int32)
    etr = np.zeros(emax, np.int32)
    if g.typed:
        for i, (u, v) in enumerate(g.edges):
            l = g.left_op(i)
            r = v if l == u else u
            ekind[i] = g.kinds[i]
            elm[i] = 1 << l
            erm[i] = 1 << r
            etl[i] = g.tes_l[i]
            etr[i] = g.tes_r[i]
    return ekind, elm, erm, etl, etr


# ============================================================ graph codec ==

def graph_to_wire(g: JoinGraph) -> dict:
    """``JoinGraph`` -> pure literals (log2 stats; f32 -> f64 is exact)."""
    d = {"n": g.n,
         "edges": [[u, v] for (u, v) in g.edges],
         "cards_l2": [float(c) for c in g.log2_card],
         "sels_l2": [float(s) for s in (g.log2_sel_raw if g.typed
                                        else g.log2_sel)],
         "names": list(g.names)}
    if g.typed:
        d["kinds"] = list(g.kinds)
        d["ldirs"] = list(g.ldirs)
    if g.fan_l2 is not None and len(g.fan_l2):
        d["fans_l2"] = [float(f) if math.isfinite(float(f)) else None
                        for f in g.fan_l2]
    return d


def graph_from_wire(d: dict) -> JoinGraph:
    """Inverse of ``graph_to_wire``: rebuilds a bit-identical graph."""
    return JoinGraph.from_log2(
        n=int(d["n"]),
        edges=[(int(u), int(v)) for u, v in d["edges"]],
        cards_l2=d["cards_l2"],
        sels_l2=d["sels_l2"],
        names=tuple(d["names"]),
        kinds=[int(k) for k in d.get("kinds", [])],
        ldirs=[int(x) for x in d.get("ldirs", [])],
        fans_l2=d.get("fans_l2"))
