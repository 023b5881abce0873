"""The frozen generators give the port's wire dicts, draw for draw."""
import pytest

from portbench.traffic import musicbrainz, snowflake
from repro_torch.core.joingraph import graph_to_wire
from repro_torch.workloads import generators as gen

SEEDS = [0, 1, 2, 7, 99, 12345, 2**31 - 1, 2**31 + 5, 2**40 + 7, 2**63 + 11]


@pytest.mark.parametrize("seed", SEEDS)
def test_musicbrainz_matches_the_port(seed):
    for n in (2, 8, 12, 13, 14, 15, 16, 18, 19, 20, 25):
        assert musicbrainz.query(n, seed) == \
            graph_to_wire(gen.musicbrainz_query(n, seed=seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_snowflake_matches_the_port(seed):
    for n in (2, 12, 16, 100, 200, 300, 400):
        assert snowflake.query(n, seed) == \
            graph_to_wire(gen.snowflake(n, seed=seed))


def test_stream_seeds_are_distinct_and_stable():
    from portbench.stream import derive
    seen = {derive(5, "window", c, j, 0) for c in range(4) for j in range(500)}
    seen |= {derive(5, "warmup", n, i) for n in range(12, 17) for i in range(2)}
    assert len(seen) == 4 * 500 + 10
    assert derive(5, "window", 0, 0, 0) == derive(5, "window", 0, 0, 0)


def test_a_pool_gives_every_seed_the_same_queries_in_another_order():
    from portbench.stream import request_queries
    mix = {"sizes": [100, 200], "pool_per_size": 3}

    class Gen:
        @staticmethod
        def query(n, seed):
            return (n, seed)

    runs = [[request_queries(Gen, mix, s, 0, j)[0] for j in range(6)]
            for s in (1, 2, 3)]
    assert all(sorted(r) == sorted(runs[0]) for r in runs)
    assert len(set(runs[0])) == 6 and len({tuple(r) for r in runs}) > 1
    assert [n for n, _ in runs[0]] == [100, 200] * 3
