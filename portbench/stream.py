"""The queries of a run, drawn from ``--seed``.

Request ``j`` of client ``c`` holds ``queries_per_request`` queries of
size ``sizes[(j + c) % len(sizes)]``, each from a seed of its own hashed
from ``(seed, stream, c, j, i)``; warm-up draws from another stream name,
so no query of the window is ever drawn twice or seen in set-up.

A mix with ``pool_per_size: K`` draws instead from a fixed pool of ``K``
queries of each size and client, the same for every seed, in an order
the seed permutes: each pass over the sizes takes the next query of each
size's permutation, so a window of about ``K`` passes does the same work
whatever the seed.  That is for mixes of few, long requests, whose work a
seed's draw of a few dozen queries would otherwise move (``PERF.md``).
"""
from __future__ import annotations

import dataclasses
import hashlib


def derive(seed: int, *parts) -> int:
    """A 64-bit seed from ``seed`` and ``parts`` (stable across runs)."""
    key = "/".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "big")


def request_queries(gen, mix: dict, seed: int, client: int, j: int,
                    stream: str = "window") -> list[dict]:
    sizes = mix["sizes"]
    n = sizes[(j + client) % len(sizes)]
    per = mix.get("queries_per_request", 1)
    pool = mix.get("pool_per_size")
    if pool is None:
        return [gen.query(n, derive(seed, stream, client, j, i))
                for i in range(per)]
    order = sorted(range(pool),
                   key=lambda k: derive(seed, "pool", client, n, k))
    first = (j // len(sizes)) * per
    return [gen.query(n, derive(0, "pool", client, n,
                                order[(first + i) % pool]))
            for i in range(per)]


def warmup_queries(gen, mix: dict, seed: int) -> list[dict]:
    """``warmup_per_size`` queries of each size the mix sends."""
    return [gen.query(n, derive(seed, "warmup", n, i))
            for n in mix["sizes"] for i in range(mix["warmup_per_size"])]


@dataclasses.dataclass
class Request:
    """One request of the window, as the client saw it."""
    client: int
    j: int
    wires: list
    t_send: float
    t_done: float | None = None
    error: str | None = None
    costs: list | None = None        # the reported cost of each query
    plans: list | None = None        # each query's plan, nested lists
    server_s: float | None = None    # the daemon's own wall for it

    @property
    def ok(self) -> bool:
        return self.error is None and self.t_done is not None


def plan_shape(p):
    """A program ``Plan`` -> nested ``[left, right]`` lists over leaf
    bitmaps (iterative: heuristic plans can be hundreds deep)."""
    out: dict = {}
    stack = [(p, False)]
    while stack:
        node, done = stack.pop()
        if node.left is None:
            out[id(node)] = int(node.rel_set)
        elif done:
            out[id(node)] = [out[id(node.left)], out[id(node.right)]]
        else:
            stack += [(node, True), (node.left, False), (node.right, False)]
    return out[id(p)]
