"""Hash-join executor and data generator on the device.

The port's copy of ``repro.execution.executor`` (paper §7.2.3):
 * it executes optimized plans on synthetic data, so the exec-vs-opt
   experiment (Fig. 10) has a real execution side;
 * it is a *semantic oracle*: every optimizer must produce a plan whose
   result multiset is identical.

Data model: one int64 key column per join edge endpoint; edge (u, v) with
selectivity s gets a shared key domain of size ~1/s (capped), so observed
join sizes track the cost model's cardinality math at small scale.  The
keys are the reference's numpy draws, placed on the device; joins are
torch ops over int64 row-id tensors (stable sort, ``searchsorted``,
``repeat_interleave``), so every result is the reference's, row for row
and column for column.  Every edge executes as an inner equi-join, typed
or not, as in the reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.engine import resolve_device
from ..core.joingraph import JoinGraph
from ..core.plan import Plan

_I64 = torch.int64
_PACK = 1 << 20        # key packing radix: k * 2^20 + c, wrapping in int64


def generate_data(g: JoinGraph, max_rows: int = 2000, seed: int = 0,
                  device=None):
    """dict rel -> dict: {"n": rows, "cols": {edge_id: int64 key tensor},
    "device": where the keys live}.  The keys are the reference's draws
    (same ``default_rng(seed)`` calls in the same order), placed on
    ``device``: ``cuda`` unless the caller names another."""
    dev = resolve_device(device)
    r = np.random.default_rng(seed)
    data = {}
    rows = {}
    for v in range(g.n):
        # compress cardinalities into [8, max_rows] preserving ordering
        frac = float(g.log2_card[v]) / max(float(g.log2_card.max()), 1.0)
        n = int(8 + (max_rows - 8) * frac)
        rows[v] = n
        data[v] = {"n": n, "cols": {}, "device": dev}
    for e, (u, v) in enumerate(g.edges):
        # key domain scaled to the *compressed* cardinalities so joins stay
        # non-empty: expected matches ~ rows_u * rows_v / dom
        sel = float(2.0 ** g.log2_sel[e])
        dom = int(np.clip(round(1.0 / max(sel, 1e-9)), 2,
                          max(2, min(rows[u], rows[v]))))
        data[u]["cols"][e] = r.integers(0, dom, rows[u]).astype(np.int64)
        data[v]["cols"][e] = r.integers(0, dom, rows[v]).astype(np.int64)
    for d in data.values():
        d["cols"] = {e: torch.from_numpy(a).to(dev) for e, a in d["cols"].items()}
    return data


class ExecResult:
    """Join result as a matrix of row ids, one column per base relation."""

    def __init__(self, rels: list[int], rows: torch.Tensor):
        self.rels = rels            # sorted base relation ids
        self.rows = rows            # int64[count, len(rels)] on the data's device

    @property
    def count(self) -> int:
        return self.rows.shape[0]

    def canonical(self) -> torch.Tensor:
        """The rows in numpy's ``lexsort(rows.T[::-1])`` order (the first
        column the primary key): stable sorts from the last column to the
        first."""
        order = torch.arange(self.count, dtype=_I64, device=self.rows.device)
        for c in range(self.rows.shape[1] - 1, -1, -1):
            order = order[torch.sort(self.rows[order, c], stable=True).indices]
        return self.rows[order]

    def numpy(self) -> np.ndarray:
        """The rows on the host."""
        return self.rows.cpu().numpy()


def _leaf(v: int, data) -> ExecResult:
    ids = torch.arange(data[v]["n"], dtype=_I64, device=data[v]["device"])
    return ExecResult([v], ids[:, None])


def _join(l: ExecResult, r: ExecResult, g: JoinGraph, data) -> ExecResult:
    lset = set(l.rels)
    rset = set(r.rels)
    preds = [(e, u, v) for e, (u, v) in enumerate(g.edges)
             if (u in lset and v in rset) or (v in lset and u in rset)]
    if not preds:
        raise ValueError("cross product during execution")

    def keycols(res: ExecResult):
        cols = []
        for (e, u, v) in preds:
            rel = u if u in set(res.rels) else v
            ridx = res.rels.index(rel)
            cols.append(data[rel]["cols"][e][res.rows[:, ridx]])
        return cols

    def pack(cols):
        k = cols[0]
        for c in cols[1:]:
            k = k * _PACK + c
        return k

    lkey = pack(keycols(l))
    rkey = pack(keycols(r))
    # build on smaller side
    if l.count <= r.count:
        build_key, probe_key = lkey, rkey
        build, probe = l, r
        swap = False
    else:
        build_key, probe_key = rkey, lkey
        build, probe = r, l
        swap = True
    dev = probe_key.device
    sk, order = torch.sort(build_key, stable=True)
    starts = torch.searchsorted(sk, probe_key)
    ends = torch.searchsorted(sk, probe_key, right=True)
    counts = ends - starts
    total = int(counts.sum())      # the join's one host sync: its output size
    probe_idx = torch.repeat_interleave(
        torch.arange(probe.count, dtype=_I64, device=dev), counts,
        output_size=total)
    if total == 0:
        build_idx = torch.zeros(0, dtype=_I64, device=dev)
    else:
        # output j of probe row i takes build position starts[i] + (j - offs[i])
        offs = torch.cumsum(counts, 0) - counts
        build_idx = order[torch.repeat_interleave(starts - offs, counts,
                                                  output_size=total)
                          + torch.arange(total, dtype=_I64, device=dev)]
    lrows = (build.rows[build_idx] if not swap else probe.rows[probe_idx])
    rrows = (probe.rows[probe_idx] if not swap else build.rows[build_idx])
    rels = l.rels + r.rels
    rows = torch.cat([lrows, rrows], dim=1)
    order_cols = sorted(range(len(rels)), key=rels.__getitem__)
    return ExecResult([rels[i] for i in order_cols],
                      rows[:, torch.tensor(order_cols, device=dev)])


def execute(p: Plan, g: JoinGraph, data) -> ExecResult:
    if p.is_leaf:
        return _leaf(p.relations()[0], data)
    return _join(execute(p.left, g, data), execute(p.right, g, data), g, data)


def execute_timed(p: Plan, g: JoinGraph, data):
    """``execute`` and its host seconds; on a card the window ends in
    ``torch.cuda.synchronize()``, so it holds the device work too."""
    t0 = time.perf_counter()
    res = execute(p, g, data)
    if res.rows.is_cuda:
        torch.cuda.synchronize(res.rows.device)
    return res, time.perf_counter() - t0
