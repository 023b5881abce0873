#!/usr/bin/env python3
"""Warm wall and stage seconds of the PyTorch/CUDA port on one card.

Usage:  python3 tools/port_stage_times.py [--src DIR] [--repeat N]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so one
copy of the script times another tree of the port as well; it builds that
tree's kernels at first use.  On cuda it runs the parts that
``chip_smoke.py`` runs through the batched filter and the MPDP:Tree and
MPDP-general evaluates: stream (a) (``mixed_stream(32, seed=0,
sizes=12..16)`` under ``auto``: one tree and one general flight), stream
(b) (``mixed_stream(8, seed=1, sizes=10..13)`` under ``dpsub``), and the
solo parts d1 (``musicbrainz_query(20, seed=11)``, MPDP-general), d2
(``snowflake(20, seed=1)``) and d4 (``chain(25, seed=1)``) under
``mpdp``.  One untimed pass over every part
comes first, so that each torch and CUDA module the path uses is loaded
before the clock starts; then N timed passes.  Prints one JSON line per
timed pass and part: wall seconds (ending in ``torch.cuda.synchronize()``),
stage seconds (summed over a stream's flights) and the kernel launches.
Then one more pass per part under ``torch.profiler`` prints the part's
device events and device-busy seconds.  Exits non-zero without
a card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parts(gen):
    """(label, kind, graphs or graph, algorithm)."""
    return [("a", "many", gen.mixed_stream(32, seed=0, sizes=(12, 13, 14, 15, 16)),
             "auto"),
            ("b", "many", gen.mixed_stream(8, seed=1, sizes=(10, 11, 12, 13)),
             "dpsub"),
            ("d1", "solo", gen.musicbrainz_query(20, seed=11), "mpdp"),
            ("d2", "solo", gen.snowflake(20, seed=1), "mpdp"),
            ("d4", "solo", gen.chain(25, seed=1), "mpdp")]


def run(torch, batch, engine, kind, what, algorithm) -> dict:
    """One pass of a part: {"wall_s", "stages"}."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "many":
        res = batch.optimize_many(what, algorithm)
    else:
        res = [engine.optimize(what, algorithm)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages: dict[str, float] = {}
    for timings in {r.algorithm: r.timings for r in res}.values():
        for k, v in timings.items():
            stages[k] = stages.get(k, 0.0) + v
    return {"wall_s": wall, "stages": stages}


def profile_part(torch, fn) -> dict:
    """Device events and device-busy seconds of one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"device_events": len(dev),
            "device_busy_s": sum(e.time_range.elapsed_us() for e in dev) / 1e6}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="directory that holds the repro_torch package")
    ap.add_argument("--repeat", type=int, default=5, help="timed passes")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("port_stage_times: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from repro_torch.core import batch, engine
    from repro_torch.kernels import ops
    from repro_torch.workloads import generators as gen
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": os.path.abspath(args.src),
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    todo = parts(gen)
    for _, kind, what, algorithm in todo:          # warm-up, untimed
        run(torch, batch, engine, kind, what, algorithm)
    for j in range(args.repeat):
        for label, kind, what, algorithm in todo:
            before = dict(ops.LAUNCHES)
            out = run(torch, batch, engine, kind, what, algorithm)
            out.update(part=label, run=j, launches={
                k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]})
            print(json.dumps(out), flush=True)
    for label, kind, what, algorithm in todo:
        prof = profile_part(torch, lambda: run(torch, batch, engine, kind,
                                               what, algorithm))
        print(json.dumps({"part": label, "profile": prof}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
