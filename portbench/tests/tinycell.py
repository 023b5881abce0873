"""A throwaway copy of the benchmark with a small cell, for the tests that
drive a run on the CPU: ``BENCHMARK.json`` and ``portbench/`` copied under
a temporary root, plus a mix of 6-8-relation queries (``tiny``) and the
cells ``musicbrainz.tiny`` and ``snowflake.tiny_heuristic``."""
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def make(root: Path) -> Path:
    """Copy the benchmark under ``root``; return the copy's folder."""
    base = root / "portbench"
    shutil.copytree(REPO / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (base / "traffic" / "tiny.json").write_text(json.dumps({
        "driver": "daemon", "clients": 2, "queries_per_request": 1,
        "sizes": [6, 7, 8], "warmup_per_size": 1, "guarantee": "exact"}))
    (base / "traffic" / "tiny_heuristic.json").write_text(json.dumps({
        "driver": "heuristic", "clients": 1, "queries_per_request": 1,
        "sizes": [20, 24], "warmup_per_size": 1, "guarantee": "heuristic"}))
    own = {"sample": None, "profile_seconds": 1, "control_requests": 6,
           "limits": json.loads((base / "workloads" /
                                 "musicbrainz.q12_16.json").read_text())[
                                     "limits"]}
    (base / "workloads" / "musicbrainz.tiny.json").write_text(json.dumps(own))
    heur = json.loads((base / "workloads" /
                       "snowflake.uniondp100_400.json").read_text())
    heur.update(sample=None, control_requests=4)
    (base / "workloads" / "snowflake.tiny_heuristic.json").write_text(
        json.dumps(heur))
    bench["workloads"] += [
        {"name": "musicbrainz.tiny", "config": "musicbrainz",
         "traffic": "tiny", "chips": 1, "why": "test cell"},
        {"name": "snowflake.tiny_heuristic", "config": "snowflake",
         "traffic": "tiny_heuristic", "chips": 1, "why": "test cell"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["musicbrainz.tiny", "snowflake.tiny_heuristic"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def run(base: Path, cell: str, seed: int, trace: int = 0,
        seconds: float = 2.0):
    """Drive one run of ``cell`` on the CPU; return (exit code, the
    result's dict)."""
    import contextlib
    import io

    import torch

    from portbench import run as harness
    torch.set_num_threads(1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run_cell(["--workload", cell, "--seed", str(seed),
                               "--seconds", str(seconds), "--trace",
                               str(trace)], device="cpu", base=base)
    lines = [x for x in out.getvalue().splitlines() if x.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)
