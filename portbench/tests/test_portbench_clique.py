"""The clique configuration and its readers.

* the frozen ``traffic/clique.py`` gives the port's ``generators.clique``
  wire dicts, draw for draw;
* ``manifest.validate`` accepts the benchmark with its new entries, and
  the new cell assembles;
* ``blocks.dense_share``, ``engine.chunk_ms`` and
  ``engine.chunks_per_query`` read the value a hand-built list of spans
  and counters gives, and nothing on a buffer that dropped spans or on a
  program without the spans or counters;
* a tiny clique cell (``tinycell`` copy, 9-10 relations) runs traced on
  the CPU, correct, with all three readings;
* the new cell's control (the reference in bfloat16) is not correct.
"""
import collections
import json
from types import SimpleNamespace

import pytest

import tinycell
from tinycell import REPO

READERS = ("blocks.dense_share", "engine.chunk_ms", "engine.chunks_per_query")
SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**31 + 5, 2**40 + 7, 2**63 + 11]


@pytest.fixture
def recorder():
    """The program's recorder, on and empty; left off and empty after."""
    from repro_torch.core import telemetry
    telemetry.clear()
    telemetry.enable()
    yield telemetry
    telemetry.disable()
    telemetry.clear()


@pytest.mark.parametrize("seed", SEEDS)
def test_clique_matches_the_port(seed):
    from portbench.traffic import clique
    from repro_torch.core.joingraph import graph_to_wire
    from repro_torch.workloads import generators as gen
    for n in (2, 4, 9, 12, 13, 14, 15, 16):
        assert clique.query(n, seed) == \
            graph_to_wire(gen.clique(n, seed=seed))


def test_manifest_accepts_the_new_entries():
    from portbench import manifest
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest.validate(bench)
    cell = manifest.Cell(bench, "clique.one12_15")
    assert cell.mix["sizes"] == [12, 13, 14, 15] and cell.mix["clients"] == 1
    assert cell.chips == 1 and "pool_per_size" not in cell.mix
    assert {m["name"] for m in cell.end_to_end} == {"queries_per_s",
                                                   "setup_s"}
    assert set(READERS) <= {m["name"] for m in cell.per_layer}
    assert cell.own["limits"]["cost_gap"] == 1e-3
    assert cell.generator().query(12, 5)["n"] == 12


def reader(name):
    from portbench import manifest
    return manifest.load_reader(name)


S = 1_000_000_000           # ns a second


def run_view(sizes=(12, 13)):
    """A window of [10 s, 12 s] and a client's requests over two sizes."""
    reqs = [SimpleNamespace(wires=[{"n": n}]) for n in sizes * 3]
    return SimpleNamespace(window=(10.0, 12.0), requests=reqs)


def test_dense_share_reads_the_spans(recorder):
    for a, b in ((9.5, 10.5), (11.0, 11.2), (11.9, 12.9), (13.0, 14.0)):
        recorder.record("blocks.dense", int(a * S), int(b * S))
    got = reader("blocks.dense_share").read(run_view())
    assert got == pytest.approx((0.5 + 0.2 + 0.1) / 2.0)


def test_chunk_ms_reads_the_spans(recorder):
    for end, ms in ((9.9, 50.0), (10.5, 1.0), (11.0, 2.0), (11.5, 4.0),
                    (12.5, 50.0)):
        recorder.record("engine.chunk", int((end - ms * 1e-3) * S),
                        int(end * S))
    assert reader("engine.chunk_ms").read(run_view()) == pytest.approx(2.0)


def test_chunks_per_query_counts_whole_passes(recorder):
    # five requests answered in the window (the fifth starts a pass that
    # the window cuts), one before it and one after
    for rid, (end, chunks) in enumerate(
            [(9.5, 1000), (10.2, 10), (10.6, 20), (11.0, 10), (11.4, 20),
             (11.8, 99), (12.4, 1000)], start=1):
        recorder.record("daemon.encode", int((end - 0.01) * S),
                        int(end * S), request=rid)
        with recorder.request(rid):
            recorder.count("engine.chunks", chunks)
    recorder.count("engine.chunks", 5000)          # under no request
    got = reader("engine.chunks_per_query").read(run_view())
    assert got == pytest.approx((10 + 20 + 10 + 20) / 4)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_after_drops(name, recorder, monkeypatch):
    monkeypatch.setattr(recorder, "_buf", collections.deque(maxlen=4))
    for rid, end in enumerate((10.5, 11.0, 11.5), start=1):
        for span in ("blocks.dense", "engine.chunk", "daemon.encode"):
            recorder.record(span, int((end - 0.1) * S), int(end * S),
                            request=rid)
    assert recorder.dropped() > 0
    assert reader(name).read(run_view()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_a_program_without_them(name, recorder,
                                                           monkeypatch):
    """A program that predates them: spans of other names, no counters."""
    mod = reader(name)
    for rid, end in enumerate((10.5, 11.0, 11.5, 11.8), start=1):
        for span in ("engine.evaluate", "engine.phase_a", "daemon.encode"):
            recorder.record(span, int((end - 0.1) * S), int(end * S),
                            request=rid)
    older = SimpleNamespace(spans=recorder.spans, dropped=recorder.dropped,
                            enable=recorder.enable)
    monkeypatch.setattr(mod, "telemetry", older)
    assert mod.read(run_view()) is None
    monkeypatch.setattr(mod, "telemetry", None)          # no program at all
    assert mod.read(run_view()) is None


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The ``tinycell`` copy with a clique cell of 9-10 relations, past
    ``cyc_cap`` (mu 28 and 36): phase A's dense path at every level."""
    root = tmp_path_factory.mktemp("bench")
    base = tinycell.make(root)
    (base / "traffic" / "tinyclique.json").write_text(json.dumps({
        "driver": "daemon", "clients": 1, "queries_per_request": 1,
        "sizes": [9, 10], "warmup_per_size": 1, "guarantee": "exact"}))
    own = json.loads((base / "workloads" / "clique.one12_15.json")
                     .read_text())
    own.update(sample=None, profile_seconds=1, control_requests=4)
    (base / "workloads" / "clique.tinyclique.json").write_text(
        json.dumps(own))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "clique.tinyclique",
                              "config": "clique", "traffic": "tinyclique",
                              "chips": 1, "why": "test cell"})
    for m in bench["per_layer"]:
        if "clique.one12_15" in m.get("workloads", []):
            m["workloads"].append("clique.tinyclique")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def test_tiny_clique_cell_reads_its_metrics(base):
    from repro_torch.core import telemetry
    try:
        rc, res = tinycell.run(base, "clique.tinyclique", 2**31 + 21,
                               trace=1, seconds=3.0)
    finally:
        telemetry.disable()
        telemetry.clear()
    assert rc == 0 and res["correct"], res
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < m["blocks.dense_share"] < 1
    assert m["engine.chunk_ms"] > 0
    # a pass is one query of 9 and one of 10 relations, so whole passes
    # read the mean of their two counts
    assert m["engine.chunks_per_query"] > 0
    assert res["checks"]["cost_gap"]["value"] <= 1e-3


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(seed):
    """The cell's control, the plain reference in bfloat16 (here at two
    requests a seed; ``portbench.control`` takes the cell's
    ``control_requests``), comes out not correct."""
    from portbench import control, manifest
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    got = control.readings(manifest.Cell(bench, "clique.one12_15"), seed, 2)
    assert not got["correct"], got
