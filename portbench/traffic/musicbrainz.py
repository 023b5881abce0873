"""MusicBrainz-like random-walk queries (MPDP paper, SIGMOD 2022, §7.2.2).

A frozen copy of ``musicbrainz_query`` in the port's
``workloads/generators.py``: the same 56-table schema, the same
``random.Random`` draws in the same order, emitted as the wire dict of
``wire.make_wire`` instead of a ``JoinGraph``.  Later changes to the
program's generator do not move this benchmark's traffic.
"""
from __future__ import annotations

import random

from .wire import is_connected, make_wire

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


def query(n_rels: int, seed: int) -> dict:
    """Random-walk query over the MusicBrainz-like schema (paper
    §7.2.2), as a wire dict.  The walk can revisit hubs, so queries can
    contain cycles."""
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
            edges.append((lmap[a], lmap[b]))
            sels.append(s)
    w = make_wire(
        n_rels, edges,
        [cards[names[p]] * (r.uniform(0.05, 1.0)) for p in picked],
        sels, [names[p] for p in picked])
    if not is_connected(w):
        raise RuntimeError("walk produced disconnected graph?")
    return w
