"""The port's plan cache (``repro_torch.core.plancache``) vs the JAX
reference's, on the CPU.

* ``canonical_signature`` of a port graph gives the reference's key and
  permutation, value for value and ``repr`` for ``repr`` (the CRC32 input
  and the file literal), on the generators, on relabeled copies and on
  typed graphs;
* a cache file saved by either package loads in the other and serves the
  same hits: equal plan shapes and ``==`` costs (``cost_plan`` on the
  probing graph in both);
* mirrors of the reference's robustness suite
  (``tests/test_plancache_robustness.py``), of its persistence and drift
  tests (``tests/test_pipeline.py``) and of its cache tests in
  ``tests/test_batch.py``, on the port's ``optimize_many(device="cpu")``.
"""
import ast
import os
import subprocess
import sys
import threading

import pytest

from repro.core import batch as rbatch
from repro.core.plancache import PlanCache as RPlanCache
from repro.core.plancache import canonical_signature as rsig
from repro.workloads import generators as rgen
from repro_torch.core import engine as teng
from repro_torch.core import joingraph as tjg
from repro_torch.core.plan import validate_plan
from repro_torch.core.plancache import CACHE_FILE_VERSION, PlanCache
from repro_torch.core.plancache import canonical_signature as tsig
from repro_torch.workloads import generators as tgen
from tests.helpers import rand_graph, typed_pool
from tests.test_batch import relabeled
from tests.test_torch_batch import one_torch_thread, port  # noqa: F401


def shape(p):
    return p.rel_set if p.is_leaf else (shape(p.left), shape(p.right))


def optimize_many(graphs, **kw):
    return teng.optimize_many(graphs, device="cpu", **kw)


# ----------------------------------------------------- canonical keys ----

SIG_GRAPHS = ([rgen.chain(9, 1), rgen.star(8, 2), rgen.cycle(7, 3),
               rgen.clique(6, 4), rgen.snowflake(14, 5), rgen.job_like(10, 6),
               rgen.musicbrainz_query(16, 7), rgen.musicbrainz_query(30, 8),
               rand_graph(10, 4, 43)]
              + [relabeled(rand_graph(10, 4, 43), seed=s)[0] for s in (3, 7)]
              + [relabeled(rgen.musicbrainz_query(12, 5), seed=1)[0]]
              + [rgen.typed_query(12, seed=3),
                 rgen.typed_query(20, seed=11, base="musicbrainz"),
                 rgen.typed_query(9, seed=5, base="star")]
              + typed_pool(4, sizes=(4, 5, 6, 7)))


@pytest.mark.parametrize("g", SIG_GRAPHS,
                         ids=[f"g{i}" for i in range(len(SIG_GRAPHS))])
def test_canonical_signature_matches_reference(g):
    key, perm = tsig(port(g))
    rkey, rperm = rsig(g)
    assert key == rkey and perm == rperm
    assert repr(key) == repr(rkey)          # plain ints, no numpy scalars
    assert ast.literal_eval(repr(key)) == key


def test_relabeled_copies_share_a_key():
    g = port(rand_graph(10, 4, 43))
    for s in (3, 7):
        assert tsig(port(relabeled(rand_graph(10, 4, 43), seed=s)[0]))[0] == \
            tsig(g)[0]


# ------------------------------------------------- files cross packages ----

CROSS = [rgen.musicbrainz_query(10, 4), rgen.cycle(8, 2), rgen.star(7, 3),
         rand_graph(9, 3, 5), rgen.typed_query(9, seed=3)]


def probes():
    """The stream, a relabeled copy of one query and a miss."""
    return CROSS + [relabeled(CROSS[3], seed=2)[0], rand_graph(8, 1, 99)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_file_crosses_packages(writer, tmp_path):
    path = str(tmp_path / "plans.plancache")
    if writer == "reference":
        cache = RPlanCache()
        rbatch.optimize_many(CROSS, cache=cache)
        cache.save(path)
        loaded = PlanCache.load(path)
        back = RPlanCache.load(path)
    else:
        cache = PlanCache()
        optimize_many([port(g) for g in CROSS], cache=cache)
        cache.save(path)
        loaded = RPlanCache.load(path)
        back = PlanCache.load(path)
    assert not loaded.stale_load and len(loaded) == len(CROSS)
    port_cache, ref_cache = (loaded, back) if writer == "reference" \
        else (back, loaded)
    for g in probes():
        r, t = ref_cache.get(g), port_cache.get(port(g))
        assert (r is None) == (t is None)
        if r is None:
            continue
        assert t.algorithm == r.algorithm
        assert shape(t.plan) == shape(r.plan)
        assert t.cost == r.cost
        validate_plan(t.plan, port(g))
    assert vars(port_cache.stats) == vars(ref_cache.stats)
    assert port_cache.hits == len(CROSS) + 1


# ------------------------------------- tests/test_plancache_robustness ----

GRAPHS = [tgen.chain(5, 1), tgen.star(6, 2)]


@pytest.fixture(scope="module")
def warm_cache():
    cache = PlanCache()
    optimize_many(GRAPHS, cache=cache)
    assert len(cache) == len(GRAPHS)
    return cache


def test_good_file_roundtrips(warm_cache, tmp_path):
    path = str(tmp_path / "good.plancache")
    warm_cache.save(path)
    loaded = PlanCache.load(path)
    assert not loaded.stale_load
    assert len(loaded) == len(warm_cache)
    res = optimize_many(GRAPHS, cache=loaded)
    assert loaded.stats.hits == len(GRAPHS) and len(res) == len(GRAPHS)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        PlanCache.load(str(tmp_path / "nope.plancache"))


@pytest.mark.parametrize("garbage", [
    b"",
    b"\x00\x01\x02 not a literal at all",
    b"{'header': ",
    b"[1, 2, 3]",
    b"{'header': {'version': 999}}",
    b"__import__('os').system('true')",
], ids=["empty", "binary", "unterminated", "wrong-shape", "missing-keys",
        "code-injection"])
def test_corrupt_file_degrades_to_cold(tmp_path, garbage):
    path = str(tmp_path / "bad.plancache")
    with open(path, "wb") as f:
        f.write(garbage)
    loaded = PlanCache.load(path)
    assert loaded.stale_load and len(loaded) == 0


def test_truncated_file_degrades_to_cold(warm_cache, tmp_path):
    path = str(tmp_path / "trunc.plancache")
    warm_cache.save(path)
    size = os.path.getsize(path)
    for frac in (0.25, 0.5, 0.9):
        with open(path, "rb") as f:
            head = f.read(int(size * frac))
        tpath = str(tmp_path / f"trunc{frac}.plancache")
        with open(tpath, "wb") as f:
            f.write(head)
        loaded = PlanCache.load(tpath)
        assert loaded.stale_load and len(loaded) == 0, f"frac={frac}"


def test_version_drift_invalidates_whole_file(warm_cache, tmp_path):
    path = str(tmp_path / "ver.plancache")
    warm_cache.save(path)
    text = open(path).read()
    bumped = text.replace(f"'version': {CACHE_FILE_VERSION}",
                          f"'version': {CACHE_FILE_VERSION + 1}", 1)
    assert bumped != text
    with open(path, "w") as f:
        f.write(bumped)
    loaded = PlanCache.load(path)
    assert loaded.stale_load and len(loaded) == 0


def test_tampered_entry_payload_degrades_to_cold(warm_cache, tmp_path):
    path = str(tmp_path / "tamper.plancache")
    warm_cache.save(path)
    text = open(path).read()
    with open(path, "w") as f:
        f.write(text.replace("'entries': [(", "'entries': [(None, ", 1))
    loaded = PlanCache.load(path)
    assert loaded.stale_load and len(loaded) == 0


def test_concurrent_rewrite_never_tears(warm_cache, tmp_path):
    """``save`` writes a temporary file and renames it: a reader racing the
    writer sees the old or the new complete file, never a torn mix."""
    path = str(tmp_path / "race.plancache")
    warm_cache.save(path)
    stop = threading.Event()
    failures: list[str] = []

    def writer():
        while not stop.is_set():
            warm_cache.save(path)

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    try:
        for _ in range(200):
            loaded = PlanCache.load(path)
            if loaded.stale_load or len(loaded) != len(warm_cache):
                failures.append(f"torn read: stale={loaded.stale_load} "
                                f"entries={len(loaded)}")
                break
    finally:
        stop.set()
        w.join(timeout=10)
    assert not w.is_alive()
    assert not failures, failures[0]


def test_save_leaves_no_temp_droppings(warm_cache, tmp_path):
    path = str(tmp_path / "tidy.plancache")
    for _ in range(3):
        warm_cache.save(path)
    assert os.listdir(tmp_path) == ["tidy.plancache"]


def test_stale_load_capped_entries(warm_cache, tmp_path):
    path = str(tmp_path / "cap.plancache")
    warm_cache.save(path)
    loaded = PlanCache.load(path, max_entries=1)
    assert not loaded.stale_load and len(loaded) == 1


# ------------------------------------ tests/test_pipeline.py, persistence ----

def test_plancache_save_load_roundtrip(tmp_path):
    path = str(tmp_path / "plans.plancache")
    g = port(rand_graph(9, 3, 5))
    g2 = port(rand_graph(8, 1, 6))
    cache = PlanCache()
    optimize_many([g, g2], cache=cache)
    cache.save(path)
    loaded = PlanCache.load(path)
    assert len(loaded) == len(cache) == 2
    assert not loaded.stale_load
    hit = loaded.get(g)
    assert hit is not None and hit.algorithm.startswith("cache[")
    fresh = teng.optimize(g, "auto", device="cpu")
    assert abs(hit.cost - fresh.cost) <= 1e-4 * max(1.0, abs(fresh.cost))
    validate_plan(hit.plan, g)


def test_plancache_stale_quantization_invalidates(tmp_path):
    path = str(tmp_path / "plans.plancache")
    cache = PlanCache()
    optimize_many([port(rand_graph(7, 1, 9))], cache=cache)
    cache.save(path)
    with open(path) as f:
        blob = ast.literal_eval(f.read())
    blob["header"]["quant"] = 1024.0
    with open(path, "w") as f:
        f.write(repr(blob))
    loaded = PlanCache.load(path)
    assert loaded.stale_load and len(loaded) == 0
    with open(path, "w") as f:
        f.write("__import__('os')")
    assert PlanCache.load(path).stale_load
    with open(path, "w") as f:
        f.write("{]")
    assert PlanCache.load(path).stale_load


def test_plancache_signature_is_process_stable():
    """Persisted keys replay across processes: the refinement hash does not
    depend on ``PYTHONHASHSEED``."""
    g = tgen.musicbrainz_query(11, seed=33)
    key, _ = tsig(g)
    code = ("from repro_torch.core.plancache import canonical_signature\n"
            "from repro_torch.workloads import generators as gen\n"
            "print(repr(canonical_signature(gen.musicbrainz_query(11, "
            "seed=33))[0]))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONHASHSEED="271828",
               PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, cwd=root,
                         check=True, timeout=120)
    assert out.stdout.strip() == repr(key)


def test_plancache_drift_invalidation():
    g = tgen.musicbrainz_query(10, seed=4)
    cache = PlanCache()
    cache.put(g, teng.optimize(g, "auto", device="cpu"))
    assert cache.get(g) is not None
    rows = {name: float(2.0 ** g.log2_card[v])
            for v, name in enumerate(g.names)}
    assert cache.invalidate_drift(rows) == 0
    assert cache.get(g) is not None
    rows[g.names[0]] *= 4.0
    assert cache.invalidate_drift(rows) == 1
    assert len(cache) == 0
    assert cache.get(g) is None
    cache.put(g, teng.optimize(g, "auto", device="cpu"))
    assert cache.invalidate_drift({"not_a_table_here": 123.0}) == 0
    assert cache.get(g) is not None


def test_plancache_drift_survives_persistence(tmp_path):
    path = str(tmp_path / "plans.plancache")
    g = tgen.musicbrainz_query(9, seed=11)
    cache = PlanCache()
    cache.put(g, teng.optimize(g, "auto", device="cpu"))
    cache.save(path)
    loaded = PlanCache.load(path)
    assert not loaded.stale_load and len(loaded) == 1
    assert loaded.invalidate_drift({g.names[2]: 1.0}) == 1
    assert loaded.get(g) is None


# ------------------------------------------------ tests/test_batch.py ----

def test_cache_repeat_hit_identical_plan():
    g = port(rand_graph(9, 3, 42))
    cache = PlanCache()
    r1 = optimize_many([g], cache=cache)[0]
    assert (cache.hits, cache.misses) == (0, 1)
    r2 = optimize_many([g], cache=cache)[0]
    assert (cache.hits, cache.misses) == (1, 1)
    assert shape(r1.plan) == shape(r2.plan)
    assert r2.algorithm.startswith("cache[")
    validate_plan(r2.plan, g)


def test_cache_isomorphic_relabel_hit():
    g = port(rand_graph(10, 4, 43))
    g2 = port(relabeled(rand_graph(10, 4, 43), seed=7)[0])
    assert tsig(g)[0] == tsig(g2)[0]
    cache = PlanCache()
    optimize_many([g], cache=cache)
    r = optimize_many([g2], cache=cache)[0]
    assert cache.hits == 1
    validate_plan(r.plan, g2)
    fresh = teng.optimize(g2, "auto", device="cpu")
    assert abs(r.cost - fresh.cost) <= 1e-4 * max(1.0, abs(fresh.cost))


def test_cache_distinct_stats_miss():
    g = port(rand_graph(8, 2, 44))
    bumped = tjg.JoinGraph.make(
        g.n, list(g.edges),
        [float(2.0 ** c) * 3.0 for c in g.log2_card],
        [float(2.0 ** s) for s in g.log2_sel])
    cache = PlanCache()
    optimize_many([g], cache=cache)
    optimize_many([bumped], cache=cache)
    assert cache.hits == 0 and cache.misses == 2


def test_cache_lru_eviction():
    cache = PlanCache(max_entries=2)
    optimize_many([port(rand_graph(6, 1, 50 + i)) for i in range(3)],
                  cache=cache)
    assert len(cache) == 2
    assert cache.stats.evictions == 1


def test_cache_hits_inside_one_stream():
    g = port(rand_graph(9, 3, 60))
    g2 = port(relabeled(rand_graph(9, 3, 60), seed=3)[0])
    cache = PlanCache()
    rs = optimize_many([g, g2, g], cache=cache)
    assert cache.stats.inserts == 1 and cache.hits == 2
    for gx, r in zip([g, g2, g], rs):
        validate_plan(r.plan, gx)


def test_small_lru_reinserts_evicted_representative():
    """``resolve_deferred`` re-inserts a representative that a one-entry
    LRU evicted mid-stream, as the reference does."""
    graphs = [rgen.chain(6, 1), rgen.star(6, 2), rgen.chain(6, 1)]
    rc, tc = RPlanCache(max_entries=1), PlanCache(max_entries=1)
    ref = rbatch.optimize_many(graphs, cache=rc)
    got = optimize_many([port(g) for g in graphs], cache=tc)
    assert vars(tc.stats) == vars(rc.stats)
    assert [shape(r.plan) for r in got] == [shape(r.plan) for r in ref]
    assert got[2].algorithm == ref[2].algorithm
