"""Plan cache keyed by a canonical join-graph signature.

The port's own copy of ``repro.core.plancache``.  A query stream (the
service's workload, or the per-round subproblems of IDP2/UnionDP) repeats
structurally identical queries: the same template with the relations
listed in another order, or re-planned verbatim.  The cache canonicalizes
a ``JoinGraph`` (relabel the vertices by an iterated WL-style refinement
over quantized stats and neighbourhood structure, then rewrite the edge
list in canonical labels) and memoizes the optimized plan shape under that
signature.

The signature, the hash and the file format are the reference's, value
for value: a key computed here equals the reference's key for the same
graph, and a cache file written by either package loads in the other and
serves the same hits.  Every element of a key is a plain Python int,
never a numpy scalar, so ``repr`` (the CRC32 input and the file literal)
is the same in both.

Safety: the signature embeds the complete relabeled edge list plus the
quantized per-vertex/per-edge statistics, so two graphs share a key only
if they are the same query up to vertex relabeling (and stat
quantization).  A hit therefore always yields a structurally valid plan
for the probing graph; its cost is re-derived on the probing graph's
exact stats by ``cost_plan``.  Ties in the refinement are broken by
original index, which is not relabel-invariant: that only shows as a
cache *miss*, never as a wrong hit.

Staleness: a persisted file whose format version or quantization epsilon
differs is wholly invalidated on load, and entries whose recorded
per-relation cardinalities have drifted are dropped by
``PlanCache.invalidate_drift``.  ``save`` writes to a temporary file and
renames it into place; the ``"cache_write"`` fault site (``core.faults``)
can tear that write, and the torn file loads as a cold cache.
"""
from __future__ import annotations


import ast
import dataclasses
import math
import os
import zlib
from collections import OrderedDict

from .plan import Counters, OptimizeResult, Plan, cost_plan

_QUANT = 4096.0          # log2-stat quantization: 1/4096 of a doubling
_REFINE_ROUNDS = 3

# Persistence format version.  Bumped whenever the canonical-signature
# derivation or the entry payload changes shape; files written by a
# different version (or a different quantization epsilon) are *wholly*
# invalidated on load — a key computed under a stale epsilon must never
# serve a hit.  v2: entries additionally carry the per-vertex
# (name, quantized card) stats signature and the quantization epsilon they
# were inserted under, feeding ``PlanCache.invalidate_drift``.
CACHE_FILE_VERSION = 2


def _quantize(x: float) -> int:
    return int(round(float(x) * _QUANT))


def _stable_hash(x) -> int:
    """Process-independent hash for the WL refinement.  Python's ``hash``
    salts str/bytes per process (PYTHONHASHSEED), which would make the
    canonical vertex order — and therefore every persisted cache key —
    differ across service runs; CRC32 over the repr of the (pure int/tuple)
    invariant is deterministic everywhere."""
    return zlib.crc32(repr(x).encode())


def canonical_signature(g) -> tuple[tuple, list[int]]:
    """Return ``(key, perm)`` where ``perm[orig_vertex] = canonical_vertex``.

    The key is a hashable tuple fully describing the query up to relabeling:
    ``(n, canonical edges, quantized cards in canonical order, quantized sels
    in canonical edge order)``.  Typed graphs append per-edge
    ``(kind, canonical left-operand endpoint)`` rows — two queries share a
    key only if their join kinds and operand orientations also match after
    relabeling; inner-only keys are byte-identical to the pre-typed format,
    so persisted caches stay valid.
    """
    n = g.n
    typed = g.typed
    qcard = [_quantize(g.log2_card[v]) for v in range(n)]
    qsel = [_quantize(s) for s in g.log2_sel]
    nbrs: list[list[tuple]] = [[] for _ in range(n)]
    for ei, (u, v) in enumerate(g.edges):
        if typed:
            # role bit separates the preserved/probe endpoint so automorphic-
            # modulo-direction vertices refine apart (inner tags stay 2-tuple)
            lo = g.left_op(ei)
            nbrs[u].append((qsel[ei], g.kinds[ei], int(lo == u), v))
            nbrs[v].append((qsel[ei], g.kinds[ei], int(lo == v), u))
        else:
            nbrs[u].append((qsel[ei], v))
            nbrs[v].append((qsel[ei], u))

    # WL refinement: vertex invariant <- hash(own stats, sorted multiset of
    # (edge stat, neighbour invariant)).  Stats-seeded, so generic queries
    # separate in one or two rounds.  The hash must be process-independent
    # (persisted caches replay keys across service runs).
    inv = [_stable_hash(("card", c)) for c in qcard]
    for _ in range(_REFINE_ROUNDS):
        inv = [_stable_hash(
                   (inv[v],
                    tuple(sorted(t[:-1] + (inv[t[-1]],) for t in nbrs[v]))))
               for v in range(n)]

    order = sorted(range(n), key=lambda v: (inv[v], v))
    perm = [0] * n
    for canon, orig in enumerate(order):
        perm[orig] = canon

    edge_rows = sorted(
        ((min(perm[u], perm[v]), max(perm[u], perm[v])), qsel[ei],
         (g.kinds[ei], perm[g.left_op(ei)]) if typed else ())
        for ei, (u, v) in enumerate(g.edges))
    key = (n,
           tuple(e for e, _, _ in edge_rows),
           tuple(qcard[orig] for orig in order),
           tuple(s for _, s, _ in edge_rows))
    if typed:
        key = key + (tuple(t for _, _, t in edge_rows),)
    return key, perm


def _encode_plan(p: Plan):
    """Canonical plan shape -> pure-literal nested tuples (leaf bitmaps at
    the leaves); costs/rows are zero on canonical plans, so shape is all
    there is to persist."""
    if p.is_leaf:
        return p.rel_set
    return (_encode_plan(p.left), _encode_plan(p.right))


def _decode_plan(e) -> Plan:
    if isinstance(e, int):
        return Plan(rel_set=e, cost=0.0, rows_log2=0.0)
    l, r = e
    lp, rp = _decode_plan(l), _decode_plan(r)
    return Plan(rel_set=lp.rel_set | rp.rel_set, cost=0.0, rows_log2=0.0,
                left=lp, right=rp)


def _relabel_plan(p: Plan, vmap: dict[int, int]) -> Plan:
    """Structure-only relabeling; costs are re-derived by the caller."""
    if p.is_leaf:
        v = vmap[p.relations()[0]]
        return Plan(rel_set=1 << v, cost=0.0, rows_log2=0.0)
    l = _relabel_plan(p.left, vmap)
    r = _relabel_plan(p.right, vmap)
    return Plan(rel_set=l.rel_set | r.rel_set, cost=0.0, rows_log2=0.0,
                left=l, right=r)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PlanCache:
    """LRU cache: canonical signature -> plan shape in canonical labels.

    Each entry also records a *stats signature* — the per-vertex
    ``(relation name, quantized log2 card)`` pairs of the inserting graph —
    and the quantization epsilon (``quant``, steps per log2 doubling) in
    force at insert time.  ``invalidate_drift`` uses both to drop entries
    whose underlying table statistics have since drifted: a stale-stats
    probe (a query still carrying the old estimates) then *misses* and
    re-optimizes instead of replaying a plan chosen for cardinalities that
    no longer exist.  Fresh-stats probes never needed the guard — their
    quantized cards land in a different canonical key anyway.
    """

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self.stats = CacheStats()
        self.stale_load = False   # True when load() rejected a stale file
        # key -> (canonical plan, algorithm, stats signature, quant epsilon)
        self._d: OrderedDict[tuple, tuple[Plan, str, tuple, float]] = \
            OrderedDict()

    def __len__(self) -> int:
        return len(self._d)

    @property
    def hits(self) -> int:
        return self.stats.hits

    @property
    def misses(self) -> int:
        return self.stats.misses

    def get(self, g) -> OptimizeResult | None:
        """Plan for ``g`` if a canonically-equal query was optimized before.

        The cached canonical plan shape is mapped back through ``g``'s own
        canonical permutation and re-costed on ``g``'s exact stats.
        """
        key, perm = canonical_signature(g)
        entry = self._d.get(key)
        if entry is None:
            self.stats.misses += 1
            return None
        self._d.move_to_end(key)
        self.stats.hits += 1
        canon_plan, algo = entry[0], entry[1]
        inv = {c: o for o, c in enumerate(perm)}
        p = cost_plan(_relabel_plan(canon_plan, inv), g)
        return OptimizeResult(plan=p, cost=p.cost, counters=Counters(),
                              algorithm=f"cache[{algo}]", levels=g.n)

    def put(self, g, result: OptimizeResult) -> None:
        key, perm = canonical_signature(g)
        if key in self._d:
            self._d.move_to_end(key)
            return
        canon_plan = _relabel_plan(result.plan, {v: perm[v] for v in range(g.n)})
        stats_sig = tuple(
            (str(g.names[v]) if v < len(g.names) else f"R{v}",
             _quantize(g.log2_card[v]))
            for v in range(g.n))
        self._d[key] = (canon_plan, result.algorithm, stats_sig, _QUANT)
        self.stats.inserts += 1
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self.stats.evictions += 1

    def invalidate_drift(self, rel_rows: dict, *, log2: bool = False) -> int:
        """Drop every entry whose recorded per-relation cardinalities have
        drifted from the current statistics; returns the number dropped.

        ``rel_rows`` maps relation name -> current row count (linear rows;
        pass ``log2=True`` when the values are already log2).  An entry is
        stale when any of its relations appears in ``rel_rows`` with a
        cardinality more than one quantization step (the entry's stored
        epsilon, 1/quant of a log2 doubling) away from the value recorded
        at insert time — beyond that step the canonical key a fresh-stats
        query would compute has moved, so the entry can only ever serve
        probes that still carry the stale estimates.  Relations not named
        in ``rel_rows`` are trusted unchanged; entries whose graphs used
        the positional default names ("R0", "R1", ...) are only matched if
        the caller keys ``rel_rows`` the same way.
        """
        new_l2 = {name: (float(v) if log2 else math.log2(max(float(v), 1.0)))
                  for name, v in rel_rows.items()}
        dropped = [key for key, entry in self._d.items()
                   if len(entry) > 2 and any(
                       name in new_l2 and
                       abs(round(new_l2[name] * entry[3]) - qc) > 1
                       for name, qc in entry[2])]
        for key in dropped:
            del self._d[key]
            self.stats.evictions += 1
        return len(dropped)

    # -------------------------------------------------------- persistence --
    def save(self, path: str) -> None:
        """Persist the cache (atomic rename).  The header stamps the
        persistence format version *and* the canonical-signature
        quantization parameters, so a file written under a different stats
        epsilon self-invalidates on load instead of serving wrong-key hits.

        The on-disk format is a Python literal (``repr`` of pure
        int/float/str/tuple structures, parsed back with
        ``ast.literal_eval``) — **not** pickle, so loading a shared or
        tampered ``--cache-file`` can never execute code.  Canonical plan
        shapes serialize as nested (left, right) tuples of leaf bitmaps;
        costs are re-derived on the probing graph at hit time anyway.
        """
        blob = {"header": {"version": CACHE_FILE_VERSION, "quant": _QUANT,
                           "refine_rounds": _REFINE_ROUNDS},
                "entries": [(key, (_encode_plan(plan), algo, stats_sig, q))
                            for key, (plan, algo, stats_sig, q)
                            in self._d.items()]}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(repr(blob))
        from . import faults
        rule = faults.check("cache_write")
        if rule is not None and rule.action == "corrupt":
            # injected torn write: truncate the temp file mid-literal so the
            # next load() self-invalidates (cold boot), never a wrong hit
            text = repr(blob)
            with open(tmp, "w") as f:
                f.write(text[: len(text) // 3])
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, max_entries: int = 4096) -> "PlanCache":
        """Load a cache persisted by ``save``.

        A header whose version or quantization stamp differs from this
        build's — or an unparseable/foreign file — invalidates the whole
        file: an **empty** cache is returned (with ``stale_load`` set) and
        the stream re-optimizes from scratch; stale-epsilon keys must never
        resolve to hits.  A missing file raises ``FileNotFoundError``
        (callers decide whether that is cold start or error)."""
        with open(path) as f:
            text = f.read()
        cache = cls(max_entries=max_entries)
        try:
            blob = ast.literal_eval(text)
            hdr = blob["header"]
            stale = (hdr["version"] != CACHE_FILE_VERSION
                     or hdr["quant"] != _QUANT
                     or hdr["refine_rounds"] != _REFINE_ROUNDS)
            entries = blob["entries"][-max_entries:] if not stale else []
            for key, (plan_enc, algo, stats_sig, q) in entries:
                cache._d[key] = (_decode_plan(plan_enc), algo,
                                 tuple(tuple(p) for p in stats_sig), float(q))
        except (ValueError, SyntaxError, KeyError, TypeError,
                MemoryError, RecursionError):
            stale = True
            cache._d.clear()
        cache.stale_load = stale
        return cache
