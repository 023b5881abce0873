#!/usr/bin/env python3
"""Warm walls of the port's service path, synchronous against pipelined,
on one card.

Usage:  python3 tools/service_times.py [--repeat N]

Runs ``service.optimize_stream`` on cuda over the two streams of
``chip_smoke.py``'s phase 8: s1, stream (a) (``mixed_stream(32, seed=0,
sizes=12..16)``) plus ``musicbrainz_query(20, seed=11)`` (solo) under
``auto``, and s2, stream (b) (``mixed_stream(8, seed=1, sizes=10..13)``)
plus ``musicbrainz_query(17, seed=11)`` (solo) under ``dpsub``.  One
untimed run of each part in each mode comes first, then N rounds; round j
runs the two modes synchronous-then-pipelined when j is even and the other
way round when it is odd, so a drift of the host's speed weighs on both.
Every pipelined run must give the synchronous run's costs, plans and
counters.  Prints one JSON line per timed run (wall seconds ending in
``torch.cuda.synchronize()``, stage seconds summed over the flights and
solo runs, each flight's ``wall_s`` and ``finalize_s``), then one line
per part with the medians and the rounds in which the pipelined run was
the faster.  Exits non-zero without a card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def parts(gen):
    """(label, graphs, algorithm)."""
    return [("s1", gen.mixed_stream(32, seed=0, sizes=(12, 13, 14, 15, 16))
             + [gen.musicbrainz_query(20, seed=11)], "auto"),
            ("s2", gen.mixed_stream(8, seed=1, sizes=(10, 11, 12, 13))
             + [gen.musicbrainz_query(17, seed=11)], "dpsub")]


def key(res):
    """What a pipelined run must reproduce bit for bit."""
    def shape(p):
        return p.rel_set if p.is_leaf else (shape(p.left), shape(p.right))
    return [(r.cost, shape(r.plan), r.counters.evaluated, r.counters.ccp,
             r.algorithm) for r in res]


def run(torch, service, graphs, algorithm, pipeline) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, rep = service.optimize_stream(graphs, algorithm, pipeline=pipeline)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    members = {qi for fl in rep.flights for qi in fl.queries}
    runs = [fl.queries[0] for fl in rep.flights] + [
        qi for qi in range(len(graphs)) if qi not in members]
    stages: dict[str, float] = {}
    for qi in runs:
        for k, v in res[qi].timings.items():
            stages[k] = stages.get(k, 0.0) + v
    return res, {"wall_s": wall, "stages": stages,
                 "flights": [{"space": fl.space, "queries": len(fl.queries),
                              "wall_s": fl.wall_s,
                              "finalize_s": fl.finalize_s}
                             for fl in rep.flights]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=5, help="timed rounds")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("service_times: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from repro_torch.core import service
    from repro_torch.workloads import generators as gen
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    todo = parts(gen)
    want = {}
    for label, graphs, algorithm in todo:          # warm-up, untimed
        want[label] = key(run(torch, service, graphs, algorithm, False)[0])
        if key(run(torch, service, graphs, algorithm, True)[0]) != want[label]:
            raise AssertionError(f"{label}: the pipelined run differs")
    walls = {(label, mode): [] for label, _, _ in todo
             for mode in ("synchronous", "pipelined")}
    for j in range(args.repeat):
        for label, graphs, algorithm in todo:
            for pipeline in ((False, True) if j % 2 == 0 else (True, False)):
                res, out = run(torch, service, graphs, algorithm, pipeline)
                if key(res) != want[label]:
                    raise AssertionError(f"{label} round {j}: results differ")
                mode = "pipelined" if pipeline else "synchronous"
                walls[(label, mode)].append(out["wall_s"])
                print(json.dumps({"part": label, "mode": mode, "round": j,
                                  **out}), flush=True)
    for label, _, _ in todo:
        sync, pipe = walls[(label, "synchronous")], walls[(label, "pipelined")]
        print(json.dumps({
            "part": label, "median_synchronous_s": statistics.median(sync),
            "median_pipelined_s": statistics.median(pipe),
            "pipelined_faster_rounds": sum(p < s for s, p in zip(sync, pipe)),
            "rounds": len(sync)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
