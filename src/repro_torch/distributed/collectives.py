"""The lattice's level-commit collective and the compressed gradient
reductions.

The port of ``repro.distributed.collectives``.  ``min_left_commit`` is the single
exchange of the lattice-sharded exact DP (``core.lattice``): one
(min-cost, max-left tie-break) combine per committed level, fused with the
replicated memo scatter.  The reference runs it inside ``shard_map`` as a
``pmin``/``pmax`` over the ``batch`` axis; the port has one process
driving every shard, so the collective is a torch function over the
shards' tensors: the partial results are copied to the first shard's
device, combined there and the combined values copied into each replica
(no copy at all when every shard lives on one device).  Its calls are
counted on the host in ``STATS``, so a test can hold "collectives only at
level commit" (count == committed levels).

``int8_psum`` is the block-scaled int8 all-reduce of cross-pod gradient
reduction, over the shards' tensors in this one process: each shard
quantizes to int8 with a per-block f32 scale (round half to even), the
int8 payloads are summed in int32, the block scales averaged over the
shards, and the sum dequantized with the averaged scale.
"""
from __future__ import annotations

import torch

from ..tree import tree_map

BLOCK = 256


class CollectiveStats:
    """Host-side accounting of collective dispatches: ``level_commits``
    counts ``min_left_commit`` calls, one per committed DP level."""

    def __init__(self) -> None:
        self.level_commits = 0

    def record_commit(self) -> None:
        self.level_commits += 1

    def snapshot(self) -> int:
        return self.level_commits


STATS = CollectiveStats()


def min_left_commit(memo_cost, memo_left, idx, cost, left, *, flat: int):
    """Combine the shards' partial level bests and scatter them into every
    memo replica, in place.

    ``memo_cost``/``memo_left``: the replicas' float32 / int32 memo
    tensors, one per shard.  ``idx``: the level's set indices (an int64
    tensor of length ``cap``, padded with ``flat``, which is dropped).
    ``cost``/``left``: each shard's partial best over its slice of the
    level's lanes, float32 / int32 tensors of length ``cap`` on the shard's
    device, padded with (INF, 0).  The combine is the semiring of the host
    merges (``chunks._merge_best``): ``best`` the minimum cost over shards,
    then the maximum left bitmap among the shards achieving a finite
    ``best`` (0 where ``best`` is INF), so any partition of the lanes
    gives the same memo contents.  Returns the replicas.
    """
    dev0 = cost[0].device
    c = torch.stack([x.to(dev0) for x in cost])
    lf = torch.stack([x.to(dev0) for x in left])
    best = c.amin(0)
    tie = torch.where((c == best) & torch.isfinite(best), lf, 0)
    bleft = tie.amax(0)
    idx0 = idx.to(dev0)
    keep = torch.nonzero((idx0 >= 0) & (idx0 < flat)).squeeze(1)
    ix, b, bl = idx0[keep], best[keep], bleft[keep]
    for mc, ml in zip(memo_cost, memo_left):
        d = mc.device
        mc[ix.to(d)] = b.to(d)
        ml[ix.to(d)] = bl.to(d)
    STATS.record_commit()
    return memo_cost, memo_left


def _quant(x):
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(flat / torch.clamp_min(scale, 1e-20)), -127, 127)
    return q.to(torch.int8), scale.float(), n


def _dequant(q, scale, n, shape):
    out = (q.float() * scale).reshape(-1)[:n]
    return out.reshape(shape)


def int8_psum(xs):
    """The all-reduce of the shards' tensors ``xs`` (one per shard, equal
    shapes) with int8 payload compression: one result per shard, on the
    shard's device.  The int8 payloads are summed in int32 and
    dequantized with the shard-averaged block scale, the reference's
    scale-averaging approximation (exact when the shards' block scales
    agree).  Sums run over the shards in order, on the first shard's
    device."""
    dev0 = xs[0].device
    qsum, ssum = None, None
    for x in xs:
        q, scale, n = _quant(x.to(dev0).float())
        qsum = q.to(torch.int32) if qsum is None else qsum + q.to(torch.int32)
        ssum = scale if ssum is None else ssum + scale
    avg_scale = ssum / torch.tensor(float(len(xs)), dtype=torch.float32)
    out = _dequant(qsum, avg_scale, n, xs[0].shape).to(xs[0].dtype)
    return [out.to(x.device) for x in xs]


def compressed_grad_reduce(grads, mesh, axis: str = "pod"):
    """Tree-wide compressed all-reduce over one mesh axis (cross-pod DP):
    ``grads`` is replicated on every shard of ``axis`` (the reference's
    ``in_specs=P()``), so each leaf reduces ``mesh.shape[axis]`` equal
    copies."""
    n = mesh.shape[axis]
    return tree_map(lambda g: int8_psum([g] * n)[0], grads)
