"""The harness takes later cells, configurations and metrics as data:
files and entries added to a copy, no code edited."""
import json

import pytest

from portbench import manifest
from tinycell import REPO, make


def _bench(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_the_manifest_is_valid():
    manifest.validate(json.loads((REPO / "BENCHMARK.json").read_text()))


def test_a_new_config_cell_and_metric_are_found(tmp_path):
    base = make(tmp_path)
    cfg = json.loads((base / "configs" / "musicbrainz.json").read_text())
    cfg["name"] = "musicbrainz_small"
    (base / "configs" / "musicbrainz_small.json").write_text(json.dumps(cfg))
    (base / "workloads" / "musicbrainz_small.tiny.json").write_text(
        (base / "workloads" / "musicbrainz.tiny.json").read_text())
    (base / "metrics" / "client.requests_per_s.py").write_text(
        "def read(run):\n"
        "    t0, t1 = run.window\n"
        "    return len(run.requests) / (t1 - t0)\n")
    bench = _bench(tmp_path)
    bench["configs"].append({
        "name": "musicbrainz_small", "source": "https://example.org/x",
        "file": "portbench/configs/musicbrainz_small.json", "reduced": [],
        "why": "a throwaway configuration"})
    bench["workloads"].append({
        "name": "musicbrainz_small.tiny", "config": "musicbrainz_small",
        "traffic": "tiny", "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({
        "name": "client.requests_per_s", "unit": "requests/s",
        "better": "higher", "source": "host_clock", "layer": "client",
        "moves": "queries_per_s", "workloads": ["musicbrainz_small.tiny"]})
    manifest.validate(bench, base)
    cell = manifest.Cell(bench, "musicbrainz_small.tiny", base)
    assert cell.mix["sizes"] == [6, 7, 8]
    assert "client.requests_per_s" in cell.readers(True)
    assert {"queries_per_s", "setup_s"} <= set(cell.readers(False))
    assert cell.generator().query(6, 1)["n"] == 6


@pytest.mark.parametrize("edit,fault", [
    (lambda b: b["per_layer"][0].update(name="bad name"), "valid name"),
    (lambda b: b["per_layer"][0].update(name="x" * 65), "valid name"),
    (lambda b: b["end_to_end"][0].update(unit="queries per s"), "unit"),
    (lambda b: b["end_to_end"][0].update(unit="µs"), "unit"),
    (lambda b: b["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda b: b["per_layer"][0].update(why="no such key"), "keys"),
    (lambda b: b["workloads"][0].update(chips=2), "chips"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0])), "twice"),
    (lambda b: b["workloads"][0].update(traffic="nosuchmix",
                                        name="musicbrainz.nosuchmix"),
     "no file"),
    (lambda b: b["per_layer"].append(dict(b["per_layer"][0],
                                          name="no.reader")), "no reader"),
    (lambda b: b["configs"][0].update(why="two\nlines"), "one line"),
])
def test_faults_are_refused(tmp_path, edit, fault):
    base = make(tmp_path)
    bench = _bench(tmp_path)
    edit(bench)
    with pytest.raises(manifest.ManifestError, match=fault):
        manifest.validate(bench, base)


def test_names_and_units_use_the_allowed_characters():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.NAME_RE.match(m["name"])
        assert manifest.UNIT_RE.match(m["unit"])
    for w in bench["workloads"]:
        for k in ("name", "config", "traffic"):
            assert manifest.NAME_RE.match(w[k])
    for c in bench["configs"]:
        assert all(manifest.NAME_RE.match(k) for k in c["reduced"])
    for path in (REPO / "portbench").rglob("*"):
        rel = path.relative_to(REPO).as_posix()
        assert all(ch.isascii() and (ch.isalnum() or ch in "_.-/")
                   for ch in rel), rel
