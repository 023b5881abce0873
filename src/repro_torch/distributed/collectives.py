"""The lattice's level-commit collective.

The port of ``min_left_commit`` and ``STATS`` from
``repro.distributed.collectives``.  ``min_left_commit`` is the single
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
"""
from __future__ import annotations

import torch


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
    merges (``engine._merge_best``): ``best`` the minimum cost over shards,
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
