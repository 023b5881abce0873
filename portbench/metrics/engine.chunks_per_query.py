"""engine.chunks_per_query: the chunks the engines dispatched (the
program's ``engine.chunks`` counter: filter spans and evaluate chunks, as
an engine's ``chunks_dispatched`` counts them) for the queries answered
in the window, over their count.  A request is answered in the window when
its ``daemon.encode`` span ended there; of those, the first whole passes
over the mix's sizes are counted (the requests of the last, unfinished
pass are left out), so the reading does not move with the size at which
the window happens to close.  Read from the program's own counters and
spans (``repro_torch.core.telemetry``), which loading this reader turns
on.  It reads nothing where the recorder's buffer dropped spans, or where
the program keeps no counters."""
try:
    from repro_torch.core import telemetry
except ImportError:                  # no program beside the benchmark
    telemetry = None
if hasattr(telemetry, "enable"):
    telemetry.enable()


def read(run):
    if not hasattr(telemetry, "counts"):
        return None          # a program without the counters
    spans = telemetry.spans()
    if not spans or telemetry.dropped() or not run.requests:
        return None
    t0, t1 = run.window
    done = sorted((s.t1, s.request) for s in spans
                  if s.name == "daemon.encode" and t0 <= s.t1 * 1e-9 <= t1)
    passes = len({r.wires[0]["n"] for r in run.requests})
    done = done[: len(done) - len(done) % passes]
    if not done:
        return None
    keep = {rid for _, rid in done}
    chunks = sum(k for (name, rid), k in telemetry.counts().items()
                 if name == "engine.chunks" and rid in keep)
    per = sum(len(r.wires) for r in run.requests) / len(run.requests)
    return chunks / (len(keep) * per)
