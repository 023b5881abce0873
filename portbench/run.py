"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up imports ``repro_torch`` (from the
checkout's ``src/``), starts the cell's driver (``drivers/``) on the card
and warms it up with queries of every size the mix sends, drawn apart from
the window's.  The window then runs the mix's closed loop for ``--seconds``
seconds.  With ``--trace 0`` the result line carries the cell's end-to-end
metrics; with ``--trace 1`` set-up also wraps the program's layers for the
per-layer readers (``tracing.py``), and after the window the traffic runs
on for the cell's ``profile_seconds`` under ``torch.profiler`` with the
lane-building kernels' launches captured; that sub-window gives the
device's busy and idle time, the breakdown and the kernels' roofline.

Once the window has closed and the peak memory is read, every answer due
in the window is awaited and the answers (or a sample drawn from the
seed) are held against the plain reference (``check.py``).  The numbers
compared go, each beside its limit, to the last lines of standard error
and under ``checks``, the last key of the result line: the last line of
standard output.  No card, too few cards, or a module of JAX or of the
JAX package loaded by the end: a message on standard error, no result,
exit code 2 or 3.
"""
from __future__ import annotations

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import check, manifest  # noqa: E402
from .tracing import GAP_SPANS, Recorder  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LATE_WAIT_S = 60.0          # how long past the close an answer is awaited


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class Context:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.config = cell.config
        self.mix = cell.mix
        self.seed = seed
        self.device = device
        self.gen = cell.generator()


class RunView:
    """What a metric's reader sees of one run."""

    def __init__(self, **kw):
        self.recorder = None
        self.device_trace = None
        self.kernel_bounds: dict = {}
        self.__dict__.update(kw)


def _install(recorder: Recorder, readers: dict) -> bool:
    spans = dict(GAP_SPANS)
    capture = False
    for _, mod in readers.values():
        spans.update(getattr(mod, "SPANS", {}))
        capture = capture or getattr(mod, "CAPTURE", False)
    for name, spec in spans.items():
        target, summarize = spec if isinstance(spec, tuple) else (spec, None)
        recorder.span(name, target, summarize)
    if capture:
        from .yardstick.work import KERNELS
        for k, (_, arg_names) in KERNELS.items():
            recorder.capture(k, arg_names)
    return capture


def _profile(recorder: Recorder, capture: bool, seconds: float):
    """The profiled sub-window, the traffic running on.  A trace that
    holds no kernel (CUPTI's kernel records were lost: seen in about one
    traced run in five, with the copies still recorded) is taken again,
    up to three times."""
    from .yardstick.devtrace import DeviceTrace
    for attempt in range(3):
        recorder.launches.clear()
        devtrace = DeviceTrace()
        recorder.capturing = capture
        devtrace.start()
        time.sleep(max(0.0, devtrace.w0 + seconds - time.perf_counter()))
        recorder.capturing = False
        devtrace.stop()
        if devtrace.kernel_events():
            return devtrace
        print(f"portbench: profiled sub-window {attempt + 1} recorded no "
              f"kernel, only {len(devtrace.events)} copies; taken again",
              file=sys.stderr)
    return devtrace


def _bounds(recorder: Recorder) -> dict:
    from .yardstick.work import bound_s
    out: dict = {}
    for name, args, outs in recorder.launches:
        out.setdefault(name, []).append(bound_s(name, args, outs))
    recorder.launches.clear()
    return out


def _breakdown(view) -> dict:
    """The device's costliest operations and its idle gaps by what the host
    was doing (the innermost span of the program then, else a client's)."""
    import numpy as np
    tr, rec = view.device_trace, view.recorder
    ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1][1])[:10]
    out = {"device_ops": [[name[:160], secs] for name, (_, secs) in ops]}
    gaps = tr.gaps()
    if not gaps:
        out["idle_gaps"] = []
        return out
    mid = np.array([(a + b) / 2 for a, b in gaps])
    order = np.argsort(mid)
    mid = mid[order]
    length = np.array([b - a for a, b in gaps])[order]
    names = ["outside any span"]
    label = np.zeros(len(mid), np.int64)
    spans = [s for s in rec.spans if s[2] >= tr.w0 and s[1] <= tr.w1]
    client_first = sorted(spans, key=lambda s: (s[0] != "client.wait", s[1]))
    for name, a, b, _, _ in client_first:
        lo, hi = np.searchsorted(mid, a), np.searchsorted(mid, b, "right")
        if hi > lo:
            if name not in names:
                names.append(name)
            label[lo:hi] = names.index(name)
    per = np.bincount(label, weights=length, minlength=len(names))
    top = sorted(range(len(names)), key=lambda i: -per[i])[:10]
    where = "" if tr.aligned else " (clocks not aligned)"
    out["idle_gaps"] = [[f"in {names[i]}{where}", float(per[i])]
                        for i in top if per[i] > 0]
    return out


def _by_size(requests) -> dict:
    """Per query size: requests answered, their median and largest
    client-side seconds."""
    import numpy as np
    by: dict = {}
    for r in requests:
        if r.ok:
            by.setdefault(r.wires[0]["n"], []).append(r.t_done - r.t_send)
    return {n: [len(v), float(np.median(v)), max(v)]
            for n, v in sorted(by.items())}


def run_cell(argv=None, *, device=None, base: Path | None = None) -> int:
    """One run; ``device`` and ``base`` are for the tests, which drive the
    rest of a run on the CPU."""
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    base = base or manifest.HERE
    bench = json.loads((base.parent / "BENCHMARK.json").read_text())
    cell = manifest.Cell(bench, args.workload, base)

    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA "
                  f"card(s), this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))

    ctx = Context(cell, args.seed, device)
    trace = bool(args.trace)
    # keep CUPTI subscribed from one profiler start to the next, so
    # that a sub-window taken again records kernels too
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    readers = cell.readers(trace)
    recorder = Recorder() if trace else None
    capture = _install(recorder, readers) if trace else False
    drv = cell.driver().Driver(ctx)
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    profile_s = float(cell.own["profile_seconds"]) if trace else 0.0
    devtrace = None
    t0 = time.perf_counter()
    t1 = t0 + args.seconds
    drv.start(float("inf") if trace else t1)
    time.sleep(max(0.0, t1 - time.perf_counter()))
    if trace and device.type == "cuda":
        devtrace = _profile(recorder, capture, profile_s)
    drv.t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    finished = drv.join(LATE_WAIT_S)
    view = RunView(window=(t0, t1), setup_s=t0 - T_PROC0,
                   requests=list(drv.requests), recorder=recorder,
                   device_trace=devtrace)
    if trace:
        recorder.restore()
        view.kernel_bounds = _bounds(recorder)
    metrics = {}
    for name, (m, mod) in readers.items():
        v = mod.read(view)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": m["unit"]}
    counters = drv.counters()
    drv.close()
    del drv
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = cell.own["limits"]
    numbers = check.judge(view.requests, guarantee=cell.mix["guarantee"],
                          sample=cell.own.get("sample"), seed=args.seed,
                          limits=limits)
    if not finished:
        numbers["unanswered"] += 1            # a request never came back
    correct, table = check.verdict(numbers, limits)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if devtrace is not None:
        device_info.update(busy_s=devtrace.busy_s(),
                           window_s=devtrace.window_s)
    out = {"correct": correct,
           "attempted": sum(len(r.wires) for r in view.requests),
           "failed": numbers["failed"],
           "metrics": metrics,
           "device": device_info}
    if devtrace is not None:
        out["breakdown"] = _breakdown(view)
    info = {"requests": len(view.requests), "checked": numbers["checked"],
            **counters, "seconds_by_size": _by_size(view.requests)}
    print(f"portbench: {args.workload} seed {args.seed}: "
          + json.dumps(info), file=sys.stderr)
    for name, row in table.items():
        print(f"check {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    out["checks"] = table
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    return run_cell(argv)


if __name__ == "__main__":
    sys.exit(main())
