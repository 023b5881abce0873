"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` is assembled from four kinds of file, so
that a later cell, mix, configuration or metric is added as files and
entries, with no edit to one that is already here:

* ``configs/<config>.json``: the deployment (source, query generator,
  optimizer settings, guarantees, what was cut);
* ``traffic/<traffic>.json``: the mix (driver, clients, sizes, warm-up,
  which guarantee the answers are held to), read by the driver module
  ``drivers/<driver>.py`` over the generator ``traffic/<generator>.py``;
* ``workloads/<cell>.json``: the cell's own check (sample size, limits)
  and its profiled sub-window;
* ``metrics/<metric>.py``: one reader a metric, end-to-end or per-layer.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class ManifestError(ValueError):
    pass


def _load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise ManifestError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def _check_name(value, what: str) -> None:
    if not isinstance(value, str) or not NAME_RE.match(value):
        raise ManifestError(f"{what}: {value!r} is not a valid name")


def _check_line(value, what: str) -> None:
    if (not isinstance(value, str) or not 1 <= len(value) <= 200
            or "\n" in value or "\t" in value):
        raise ManifestError(f"{what}: must be one line of 1 to 200 "
                            "characters")


def load_reader(name: str, base: Path = HERE):
    """The reader module ``metrics/<name>.py`` (names may hold dots)."""
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        raise ManifestError(f"metric {name}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise ManifestError(f"metric {name}: {path} has no read(run)")
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def validate(bench: dict, base: Path = HERE) -> None:
    """Check the manifest's form and that every name it uses has its
    file; raise ``ManifestError`` on the first fault."""
    want = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(bench) != want:
        raise ManifestError(f"keys {sorted(bench)} != {sorted(want)}")
    configs = {}
    for c in bench["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise ManifestError(f"config keys {sorted(c)}")
        _check_name(c["name"], "config name")
        _check_line(c["source"], f"config {c['name']} source")
        _check_line(c["why"], f"config {c['name']} why")
        for k in c["reduced"]:
            _check_name(k, f"config {c['name']} reduced key")
        if c["name"] in configs:
            raise ManifestError(f"config {c['name']} twice")
        if Path(c["file"]).name != f"{c['name']}.json":
            raise ManifestError(f"config {c['name']}: file {c['file']}")
        configs[c["name"]] = _load_json(base / "configs" / f"{c['name']}.json",
                                        f"config {c['name']}")
    cells, pairs, used = set(), set(), set()
    for w in bench["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise ManifestError(f"workload keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            _check_name(w[k], f"workload {k}")
        _check_line(w["why"], f"workload {w['name']} why")
        if w["name"] != f"{w['config']}.{w['traffic']}":
            raise ManifestError(f"workload {w['name']}: not config.traffic")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: unknown config")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips {w['chips']}")
        if w["name"] in cells or (w["config"], w["traffic"]) in pairs:
            raise ManifestError(f"workload {w['name']} twice")
        cells.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        mix = _load_json(base / "traffic" / f"{w['traffic']}.json",
                         f"traffic {w['traffic']}")
        _load_json(base / "workloads" / f"{w['name']}.json",
                   f"workload {w['name']}")
        for mod in (f"drivers/{mix['driver']}.py",
                    f"traffic/{configs[w['config']]['generator']}.py"):
            if not (base / mod).is_file():
                raise ManifestError(f"workload {w['name']}: no {mod}")
    if used != set(configs):
        raise ManifestError(f"configs used by no cell: "
                            f"{sorted(set(configs) - used)}")
    names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            _check_name(m["name"], f"{kind} metric name")
            if m["name"] in names:
                raise ManifestError(f"metric {m['name']} twice")
            names.add(m["name"])
            if not UNIT_RE.match(m.get("unit", "")):
                raise ManifestError(f"metric {m['name']}: unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                raise ManifestError(f"metric {m['name']}: better")
            if m.get("source") not in SOURCES:
                raise ManifestError(f"metric {m['name']}: source")
            for c in m.get("workloads", []):
                if c not in cells:
                    raise ManifestError(f"metric {m['name']}: unknown cell {c}")
            load_reader(m["name"], base)
    for m in bench["end_to_end"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound",
                                        "source"}:
            raise ManifestError(f"end-to-end {m['name']}: keys {sorted(m)}")
        if m["source"] not in ("host_clock", "device_trace"):
            raise ManifestError(f"end-to-end {m['name']}: source")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "source",
                                        "layer", "moves"}:
            raise ManifestError(f"per-layer {m['name']}: keys {sorted(m)}")
        _check_line(m["layer"], f"per-layer {m['name']} layer")
        if m["moves"] not in e2e:
            raise ManifestError(f"per-layer {m['name']}: moves {m['moves']}")
    for c in cells:
        got = [m["name"] for m in bench["end_to_end"] if applies(m, c)]
        if "setup_s" not in got or len(got) < 2:
            raise ManifestError(f"cell {c}: end-to-end metrics {got}")
        if not any(applies(m, c) for m in bench["per_layer"]):
            raise ManifestError(f"cell {c}: no per-layer metric")


class Cell:
    """Everything a run of one cell reads, found by name."""

    def __init__(self, bench: dict, name: str, base: Path = HERE):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise ManifestError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = by_name[name]
        self.name = name
        self.config = _load_json(
            base / "configs" / f"{self.workload['config']}.json", "config")
        self.mix = _load_json(
            base / "traffic" / f"{self.workload['traffic']}.json", "traffic")
        self.own = _load_json(base / "workloads" / f"{name}.json", "workload")
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]
        self.base = base

    @property
    def chips(self) -> int:
        return self.workload["chips"]

    def generator(self):
        return importlib.import_module(
            f"portbench.traffic.{self.config['generator']}")

    def driver(self):
        return importlib.import_module(f"portbench.drivers.{self.mix['driver']}")

    def readers(self, trace: bool) -> dict:
        ms = self.per_layer if trace else self.end_to_end
        return {m["name"]: (m, load_reader(m["name"], self.base)) for m in ms}
