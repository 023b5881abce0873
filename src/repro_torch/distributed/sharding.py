"""The DP lane partitioner of the lattice-sharded engine.

The port of ``partition_lanes`` from ``repro.distributed.sharding``: it
splits one DP level's lane space (DPSUB ``sets x 2^i`` lanes, MPDP:Tree
``sets x m`` lanes, the MPDP-general block prefix-sum, or the filter's
colex ranks) into contiguous, balanced per-shard ranges.  Contiguity
matters twice over: filter output concatenated in shard order stays in
global (colex-ascending) set order, and evaluate chunks keep monotone
segment ids, so the in-chunk segment prunes stay valid.
"""
from __future__ import annotations

import numpy as np


def partition_lanes(total: int, parts: int) -> np.ndarray:
    """Balanced contiguous partition of ``[0, total)`` into ``parts`` ranges.

    Returns int64 offsets of shape ``(parts + 1,)``: part ``d`` owns lanes
    ``[offsets[d], offsets[d + 1])``.  The first ``total % parts`` parts get
    one extra lane, so sizes differ by at most one; ``total == 0`` yields
    ``parts`` empty ranges.
    """
    if parts < 1:
        raise ValueError(f"need at least 1 partition, requested {parts}")
    if total < 0:
        raise ValueError(f"negative lane total {total}")
    base, rem = divmod(int(total), parts)
    sizes = np.full(parts, base, np.int64)
    sizes[:rem] += 1
    offs = np.zeros(parts + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    return offs
