"""Render the roofline table from the dry-run's record.  The port of
``repro.launch.report``: the same table from a file of either package.

    PYTHONPATH=src python -m repro_torch.launch.report [results/dryrun_torch.json]

The ``temp`` column and the summary's list of cells over the card's HBM
read ``memory.temp_size_in_bytes``; the limit is one H100's
(``roofline.HBM_BYTES``).
"""
from __future__ import annotations

import json
import sys

from .roofline import HBM_BYTES

DEFAULT_PATH = "results/dryrun_torch.json"


def fmt_s(x):
    if x >= 1:
        return f"{x:7.2f}s"
    if x >= 1e-3:
        return f"{1e3*x:6.2f}ms"
    return f"{1e6*x:6.1f}us"


def render(path=DEFAULT_PATH, mesh="single", fh=sys.stdout):
    with open(path) as f:
        data = json.load(f)
    rows = []
    for k, v in sorted(data.items()):
        if v.get("mesh") != mesh:
            continue
        if v.get("status") == "skipped":
            rows.append((v["arch"], v["shape"], "skipped", "", "", "", "", "", ""))
            continue
        if v.get("status") != "ok":
            rows.append((v["arch"], v["shape"], "ERROR", "", "", "", "", "", ""))
            continue
        r = v["roofline"]
        dom = r["bottleneck"].replace("_s", "")
        ucr = v.get("useful_compute_ratio")
        rows.append((
            v["arch"], v["shape"], dom,
            fmt_s(r["compute_s"]), fmt_s(r["memory_s"]), fmt_s(r["collective_s"]),
            f"{v['memory']['temp_size_in_bytes']/1e9:.1f}G",
            f"{ucr:.2f}" if ucr else "-",
            f"{v['compile_s']:.0f}s",
        ))
    hdr = ("arch", "shape", "bound", "compute", "memory", "collective",
           "temp", "useful", "compile")
    widths = [max(len(str(r[i])) for r in rows + [hdr]) for i in range(len(hdr))]
    line = " | ".join(h.ljust(w) for h, w in zip(hdr, widths))
    print(line, file=fh)
    print("-" * len(line), file=fh)
    for r in rows:
        print(" | ".join(str(c).ljust(w) for c, w in zip(r, widths)), file=fh)


def summary(path=DEFAULT_PATH, fh=sys.stdout):
    with open(path) as f:
        data = json.load(f)
    ok = sum(1 for v in data.values() if v.get("status") == "ok")
    sk = sum(1 for v in data.values() if v.get("status") == "skipped")
    er = sum(1 for v in data.values() if v.get("status") == "error")
    print(f"cells: ok={ok} skipped={sk} error={er}", file=fh)
    over = [(k, v["memory"]["temp_size_in_bytes"] / 1e9) for k, v in data.items()
            if v.get("status") == "ok"
            and v["memory"]["temp_size_in_bytes"] > HBM_BYTES]
    if over:
        print(f"over {HBM_BYTES / 1e9:.0f}GB HBM (temp):", file=fh)
        for k, g in sorted(over, key=lambda x: -x[1]):
            print(f"  {k}: {g:.1f} GB", file=fh)


if __name__ == "__main__":
    p = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_PATH
    summary(p)
    for m in ("single", "multi"):
        print(f"\n=== mesh: {m} ===")
        render(p, m)
