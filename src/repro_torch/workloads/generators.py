"""Synthetic + real-world-like query workloads (paper §7.1/§7.2).

The port's copy of ``repro.workloads.generators``: the same ``random``
draws in the same order, so every generator gives the reference's graph
seed for seed.

Topologies: star, snowflake (depth <= 4), chain, cycle, clique, JOB-like
(mixed tree + small cycles), and a MusicBrainz-like 56-table PK-FK schema
with random-walk query sampling (§7.2.2); ``hypergraph_query`` lowers
multi-way predicates over a chain to cliques; ``typed_query`` and
``mixed_joins_stream`` retype a base topology's bridges to LEFT, FULL,
SEMI and ANTI joins and give some inner edges many-to-many fan-outs.  Cardinalities and selectivities
follow PK-FK conventions: joining fact->dimension keeps fact cardinality
scaled by predicate selectivity; sel(PK-FK edge) ~ 1/card(PK side).
"""
from __future__ import annotations

import random

from ..core.joingraph import JoinGraph


def star(n: int, seed: int = 0, with_selections: bool = True) -> JoinGraph:
    """Fact relation 0 + n-1 dimensions (paper star workload)."""
    r = random.Random(seed)
    cards = [r.uniform(5e6, 5e7)]
    edges, sels = [], []
    for i in range(1, n):
        dim = r.uniform(1e2, 1e6)
        if with_selections:           # selections scale the dimension side
            dim *= r.uniform(0.05, 1.0)
        cards.append(dim)
        edges.append((0, i))
        sels.append(min(1.0, r.uniform(0.5, 2.0) / dim))
    return JoinGraph.make(n, edges, cards, sels)


def snowflake(n: int, seed: int = 0, branch: int = 3, depth: int = 4) -> JoinGraph:
    """Fact at the center; dimension chains up to ``depth`` deep."""
    r = random.Random(seed)
    cards = [r.uniform(5e6, 5e7)]
    edges, sels = [], []
    levels = {0: 0}
    frontier = [0]
    while len(cards) < n:
        nxt = []
        for p in frontier:
            for _ in range(branch):
                if len(cards) >= n:
                    break
                if levels[p] >= depth:
                    continue
                i = len(cards)
                c = r.uniform(1e2, 1e6) * (0.3 ** levels[p])
                c = max(c, 10.0)
                cards.append(c)
                edges.append((p, i))
                sels.append(min(1.0, r.uniform(0.5, 2.0) / c))
                levels[i] = levels[p] + 1
                nxt.append(i)
        if not nxt:  # everything at max depth: restart frontier at leaves
            levels = {k: 0 for k in levels}
            nxt = list(levels.keys())
        frontier = nxt
    return JoinGraph.make(n, edges, cards, sels)


def chain(n: int, seed: int = 0) -> JoinGraph:
    r = random.Random(seed)
    cards = [r.uniform(1e3, 1e7) for _ in range(n)]
    edges = [(i, i + 1) for i in range(n - 1)]
    sels = [min(1.0, r.uniform(0.5, 2.0) / min(cards[u], cards[v]))
            for (u, v) in edges]
    return JoinGraph.make(n, edges, cards, sels)


def cycle(n: int, seed: int = 0) -> JoinGraph:
    g = chain(n, seed)
    r = random.Random(seed + 1)
    edges = list(g.edges) + [(0, n - 1)]
    sels = [float(2.0 ** s) for s in g.log2_sel] + [
        min(1.0, r.uniform(0.5, 2.0) / 1e3)]
    return JoinGraph.make(n, edges, [float(2.0 ** c) for c in g.log2_card], sels)


def clique(n: int, seed: int = 0) -> JoinGraph:
    r = random.Random(seed)
    cards = [r.uniform(1e2, 1e6) for _ in range(n)]
    edges, sels = [], []
    for i in range(n):
        for j in range(i + 1, n):
            edges.append((i, j))
            sels.append(10.0 ** r.uniform(-4.0, -1.0))
    return JoinGraph.make(n, edges, cards, sels)


def job_like(n: int, seed: int = 0) -> JoinGraph:
    """JOB-flavoured: a few hub relations, mostly tree, 1-3 cycles."""
    r = random.Random(seed)
    cards = [r.uniform(1e3, 4e7) for _ in range(n)]
    edges, sels = [], []
    hubs = list(range(min(3, n)))
    for i in range(1, n):
        p = r.choice(hubs) if r.random() < 0.6 and i not in hubs else r.randrange(i)
        if p == i:
            p = r.randrange(i)
        edges.append((p, i))
        sels.append(min(1.0, r.uniform(0.5, 2.0) / min(cards[p], cards[i])))
    for _ in range(r.randrange(1, 4)):
        u, v = r.randrange(n), r.randrange(n)
        if u != v and (min(u, v), max(u, v)) not in [tuple(sorted(e)) for e in edges]:
            edges.append((u, v))
            sels.append(10.0 ** r.uniform(-5.0, -1.0))
    return JoinGraph.make(n, edges, cards, sels)


# ------------------------------------------------------- MusicBrainz-like --

_MB_TABLES = [
    # (name, cardinality) — modeled on MusicBrainz table sizes
    ("artist", 2.2e6), ("artist_credit", 2.1e6), ("artist_credit_name", 3.1e6),
    ("artist_alias", 2.5e5), ("artist_ipi", 4e4), ("artist_isni", 6e4),
    ("release_group", 3.3e6), ("release", 4.3e6), ("release_country", 4.1e6),
    ("release_label", 2.3e6), ("release_status", 8), ("release_packaging", 12),
    ("release_alias", 4e4), ("release_unknown_country", 2e5),
    ("recording", 3.4e7), ("recording_alias", 5e4), ("track", 4.6e7),
    ("medium", 4.9e6), ("medium_format", 100), ("work", 2.1e6),
    ("work_alias", 3e5), ("work_type", 30), ("work_language", 9e5),
    ("label", 2.6e5), ("label_alias", 3e4), ("label_type", 20),
    ("label_ipi", 1e4), ("label_isni", 1.5e4), ("area", 1.2e5),
    ("area_alias", 3e4), ("area_type", 10), ("country_area", 260),
    ("place", 6.5e4), ("place_alias", 1e4), ("place_type", 10),
    ("event", 8e4), ("event_alias", 1e4), ("event_type", 15),
    ("url", 1.2e7), ("gender", 5), ("language", 8000), ("script", 200),
    ("isrc", 2.5e6), ("iswc", 1.2e6), ("tag", 2.4e5), ("artist_tag", 8e5),
    ("release_tag", 5e5), ("recording_tag", 9e5), ("genre", 2000),
    ("annotation", 4.5e6), ("editor", 2.4e6), ("edit", 1.1e8),
    ("vote", 2.2e8), ("instrument", 1100), ("series", 2.3e4), ("cdtoc", 2.6e6),
]

_MB_FKS = [
    ("artist_credit_name", "artist"), ("artist_credit_name", "artist_credit"),
    ("artist_alias", "artist"), ("artist_ipi", "artist"), ("artist_isni", "artist"),
    ("artist", "area"), ("artist", "gender"),
    ("release_group", "artist_credit"),
    ("release", "release_group"), ("release", "artist_credit"),
    ("release", "release_status"), ("release", "release_packaging"),
    ("release", "language"), ("release", "script"),
    ("release_country", "release"), ("release_country", "country_area"),
    ("release_label", "release"), ("release_label", "label"),
    ("release_alias", "release"), ("release_unknown_country", "release"),
    ("recording", "artist_credit"), ("recording_alias", "recording"),
    ("track", "recording"), ("track", "medium"), ("track", "artist_credit"),
    ("medium", "release"), ("medium", "medium_format"),
    ("work_alias", "work"), ("work", "work_type"), ("work_language", "work"),
    ("work_language", "language"),
    ("label", "label_type"), ("label", "area"), ("label_alias", "label"),
    ("label_ipi", "label"), ("label_isni", "label"),
    ("area_alias", "area"), ("area", "area_type"), ("country_area", "area"),
    ("place", "area"), ("place_alias", "place"), ("place", "place_type"),
    ("event", "event_type"), ("event_alias", "event"),
    ("isrc", "recording"), ("iswc", "work"),
    ("artist_tag", "artist"), ("artist_tag", "tag"),
    ("release_tag", "release"), ("release_tag", "tag"),
    ("recording_tag", "recording"), ("recording_tag", "tag"),
    ("tag", "genre"), ("annotation", "editor"),
    ("edit", "editor"), ("vote", "edit"), ("vote", "editor"),
    ("series", "area"), ("cdtoc", "medium"), ("instrument", "area"),
    ("event", "area"),
    # bridge edges (modeled on MusicBrainz's edit_artist / l_artist_url link
    # tables): without them `url` and the edit subsystem are separate
    # components and the random walk can never span the full 56-table schema
    ("edit", "artist"), ("url", "artist"),
]


def musicbrainz_schema():
    names = [t[0] for t in _MB_TABLES]
    cards = {t[0]: t[1] for t in _MB_TABLES}
    idx = {n: i for i, n in enumerate(names)}
    fks = [(idx[a], idx[b]) for (a, b) in _MB_FKS if a in idx and b in idx]
    return names, cards, fks


def musicbrainz_query(n_rels: int, seed: int = 0, pk_fk: bool = True) -> JoinGraph:
    """Random-walk query over the MusicBrainz-like schema (§7.2.2).
    The walk can revisit hubs, so generated queries can contain cycles."""
    names, cards, fks = musicbrainz_schema()
    r = random.Random(seed)
    nbr: dict[int, list[int]] = {}
    for (a, b) in fks:
        nbr.setdefault(a, []).append(b)
        nbr.setdefault(b, []).append(a)
    start = r.choice(list(nbr.keys()))
    picked = [start]
    pset = {start}
    cur = start
    stall = 0
    while len(picked) < n_rels:
        nxt = r.choice(nbr[cur])
        if nxt not in pset:
            picked.append(nxt)
            pset.add(nxt)
        cur = nxt
        stall += 1
        if stall >= 400:
            # trapped in a fully-picked region: restart the walk from a
            # picked vertex that still has unpicked neighbours instead of
            # giving up, so every size up to the schema is reachable
            frontier = [v for v in picked
                        if any(w not in pset for w in nbr[v])]
            if not frontier:
                raise RuntimeError(
                    f"schema component exhausted at {len(picked)} < {n_rels} "
                    "relations")
            cur = r.choice(frontier)
            stall = 0
    lmap = {g: l for l, g in enumerate(picked)}
    edges, sels = [], []
    for (a, b) in fks:
        if a in pset and b in pset:
            # PK side = referenced table b: sel ~ 1/card(b)
            s = min(1.0, r.uniform(0.8, 1.2) / cards[names[b]])
            if not pk_fk:
                s = 10.0 ** r.uniform(-6.0, -1.0)
            edges.append((lmap[a], lmap[b]))
            sels.append(s)
    g = JoinGraph.make(
        n=n_rels, edges=edges,
        cards=[cards[names[p]] * (r.uniform(0.05, 1.0)) for p in picked],
        sels=sels, names=[names[p] for p in picked])
    if not g.is_connected():
        raise RuntimeError("walk produced disconnected graph?")
    return g


def mixed_stream(nq: int, seed: int = 0, sizes=(8, 9, 10, 11, 12, 13, 14)):
    """The canonical mixed-size benchmark stream: ``nq`` musicbrainz random
    walks cycling through ``sizes``, seeds ``100 + seed, 100 + seed + 1,
    ...`` — deterministic, so two processes given the same ``(nq, seed)``
    build bit-identical graphs (and the same graphs as the reference
    package's ``mixed_stream``)."""
    graphs, s = [], seed
    while len(graphs) < nq:
        n = sizes[len(graphs) % len(sizes)]
        graphs.append(musicbrainz_query(n, seed=100 + s))
        s += 1
    return graphs


# ------------------------------------------------- typed / m:n workloads --

def _bridges(n, edges):
    """Indices of bridge edges (removal disconnects), O(m * (n + m)) — the
    generator tier is host-side and small, simplicity wins."""
    adj = [[] for _ in range(n)]
    for i, (u, v) in enumerate(edges):
        adj[u].append((v, i))
        adj[v].append((u, i))
    out = []
    for i, (u, v) in enumerate(edges):
        seen = {u}
        stack = [u]
        while stack:
            x = stack.pop()
            for (y, j) in adj[x]:
                if j != i and y not in seen:
                    seen.add(y)
                    stack.append(y)
        if v not in seen:
            out.append(i)
    return out


def typed_query(n: int, seed: int = 0, base: str = "job",
                noninner: float = 0.35, mn: float = 0.3) -> JoinGraph:
    """Non-inner + many-to-many variant of a base topology.

    Starts from ``TOPOLOGIES[base](n, seed)`` and retypes a ``noninner``
    fraction of its *bridge* edges (non-inner joins must be bridges under
    the conservative conflict rules) to left/semi/anti — plus at most one
    full, demoted to left when another pick lies on its path to the root —
    with the preserved/probe operand oriented toward relation 0, so the TES
    constraints nest and construction always succeeds.  A ``mn``
    fraction of the remaining inner edges trades the PK-FK selectivity for
    an explicit many-to-many fan-out (``fanouts=``, fan > max cardinality).
    ``noninner=0`` and ``mn=0`` reproduce the base query exactly.
    """
    r = random.Random(seed ^ 0x7E57ED)
    g0 = TOPOLOGIES[base](n, seed)
    edges = list(g0.edges)
    cards = [float(2.0 ** c) for c in g0.log2_card]
    sels = [float(2.0 ** s) for s in g0.log2_sel]
    # hop distance from relation 0: the farther endpoint is the right
    # (non-preserved) side of every non-inner edge
    adj = [[] for _ in range(n)]
    for (u, v) in edges:
        adj[u].append(v)
        adj[v].append(u)
    dist = [-1] * n
    dist[0] = 0
    q = [0]
    for x in q:
        for y in adj[x]:
            if dist[y] < 0:
                dist[y] = dist[x] + 1
                q.append(y)
    kinds = ["inner"] * len(edges)
    ldirs = [0] * len(edges)
    cand = _bridges(n, edges)
    r.shuffle(cand)
    picks = cand[: max(1, round(noninner * len(cand))) if noninner else 0]
    # far-side vertex sets of every pick (reachability minus the bridge):
    # FULL requires its complete root side as one operand, so it is only
    # feasible when no other pick lies between it and relation 0 — two such
    # bridges would each require the other to fire first (TES deadlock,
    # rejected by conflicts.analyze)
    rsides = {}
    for i in picks:
        u, v = edges[i]
        far = v if dist[u] <= dist[v] else u
        seen = {far}
        stack = [far]
        while stack:
            x = stack.pop()
            for j, (a, b) in enumerate(edges):
                if j == i:
                    continue
                y = b if a == x else (a if b == x else None)
                if y is not None and y not in seen:
                    seen.add(y)
                    stack.append(y)
        rsides[i] = seen
    full_used = False
    for i in picks:
        u, v = edges[i]
        lo = u if dist[u] <= dist[v] else v       # preserved side -> root
        far = v if lo == u else u
        k = r.choice(("left", "semi", "anti", "full"))
        if k == "full":
            if full_used or any(far in rsides[j] for j in picks if j != i):
                k = "left"
            else:
                full_used = True
        kinds[i] = k
        ldirs[i] = 1 if lo == v else 0
    fanouts = [None] * len(edges)
    for i, k in enumerate(kinds):
        if k == "inner" and r.random() < mn:
            # many-to-many: every row on the bigger side matches several on
            # the other, so |u >< v| exceeds both input cardinalities
            u, v = edges[i]
            fanouts[i] = max(cards[u], cards[v]) * r.uniform(1.5, 50.0)
    return JoinGraph.make(n, edges, cards, sels, names=g0.names,
                          kinds=kinds, ldirs=ldirs, fanouts=fanouts)


def hypergraph_query(n: int, seed: int = 0, n_hyper: int = 2,
                     arity: int = 3) -> JoinGraph:
    """Chain base + ``n_hyper`` multi-way predicates, lowered to cliques.

    A hyperedge over k relations (e.g. a multi-attribute equality) has one
    total selectivity; lowering distributes it evenly over the C(k, 2)
    binary edges of the induced clique in log2 space, so the joint
    selectivity of assembling all k relations is exactly the hyperedge's.
    Lowered edges that collide with an existing inner predicate keep the
    more selective one (the ``JoinGraph.make`` dedup rule).
    """
    r = random.Random(seed ^ 0x42)
    g0 = chain(n, seed)
    edges = [list(e) for e in g0.edges]
    sels = [float(2.0 ** s) for s in g0.log2_sel]
    for _ in range(n_hyper):
        k = min(arity, n)
        verts = r.sample(range(n), k)
        total_l2 = r.uniform(-20.0, -3.0)          # joint log2 selectivity
        pairs = [(a, b) for ai, a in enumerate(verts) for b in verts[ai + 1:]]
        per = total_l2 / len(pairs)
        for (a, b) in pairs:
            edges.append([a, b])
            sels.append(float(2.0 ** per))
    return JoinGraph.make(n, [tuple(e) for e in edges],
                          [float(2.0 ** c) for c in g0.log2_card], sels,
                          names=g0.names)


TOPOLOGIES = {
    "star": star, "snowflake": snowflake, "chain": chain, "cycle": cycle,
    "clique": clique, "job": job_like, "musicbrainz": musicbrainz_query,
}


def mixed_joins_stream(nq: int, seed: int = 0, sizes=(6, 7, 8, 9, 10),
                       noninner: float = 0.35, mn: float = 0.3):
    """Typed analogue of ``mixed_stream``: ``nq`` ``typed_query`` graphs
    cycling through ``sizes`` and base topologies (job / chain / star /
    cycle), each with non-inner bridges and m:n fan-outs per the knobs.
    Deterministic in ``(nq, seed, sizes, knobs)`` like ``mixed_stream``,
    and the same graphs as the reference package's ``mixed_joins_stream``."""
    bases = ("job", "chain", "star", "cycle")
    return [typed_query(sizes[i % len(sizes)], seed=200 + seed + i,
                        base=bases[i % len(bases)],
                        noninner=noninner, mn=mn)
            for i in range(nq)]
