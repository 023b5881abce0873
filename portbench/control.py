"""The control of a cell's check: the plain reference put in the program's
place and computed in bfloat16, the precision one step below the float32
that the configurations state.  Its answers go through the same
comparison as a run's (``check.judge``, the cell's sample and limits),
which has to call them not correct.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13

prints one JSON line a seed with the numbers compared.  The exact cells'
control is the exact DP in bfloat16 (``reference/exact.py``); the heuristic
cells' is GOO in bfloat16 (``reference/greedy.py``).  Each seed draws the
cell's own stream of queries (``stream.request_queries``), as many
requests as the cell's ``control_requests``.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import check, manifest
from .reference import exact, greedy
from .reference.costmodel import BF16
from .stream import Request, request_queries


def control_requests(cell, seed: int, count: int) -> list[Request]:
    gen, mix = cell.generator(), cell.mix
    clients = mix["clients"]
    solve = (exact.solve if mix["guarantee"] == "exact" else greedy.solve)
    out = []
    for k in range(count):
        c, j = k % clients, k // clients
        wires = request_queries(gen, mix, seed, c, j)
        answers = [solve(w, BF16) for w in wires]
        out.append(Request(client=c, j=j, wires=wires, t_send=0.0, t_done=0.0,
                           costs=[a[0] for a in answers],
                           plans=[a[1] for a in answers]))
    return out


def readings(cell, seed: int, count: int | None = None) -> dict:
    count = count or cell.own["control_requests"]
    reqs = control_requests(cell, seed, count)
    limits = cell.own["limits"]
    nums = check.judge(reqs, guarantee=cell.mix["guarantee"],
                       sample=cell.own.get("sample"), seed=seed, limits=limits)
    correct, _ = check.verdict(nums, limits)
    return {"seed": seed, "requests": count, "correct": correct, **nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args(argv)
    bench = json.loads((manifest.HERE.parent / "BENCHMARK.json").read_text())
    cell = manifest.Cell(bench, args.workload)
    for s in args.seeds.split(","):
        print(json.dumps({"workload": args.workload,
                          **readings(cell, int(s), args.requests)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
