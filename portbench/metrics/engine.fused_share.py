"""engine.fused_share: the share of the engines' evaluate chunks that ran
the fused evaluate epilogue, one kernel launch a chunk (the program's
``engine.fused_chunks`` counter) over every evaluate chunk (its
``engine.eval_chunks`` counter), both counted where the engines read a
chunk's result back and summed over every request the recorder counted.  It needs no window,
so it reads alike under the daemon and in-process.  Read from the
program's own counters (``repro_torch.core.telemetry``), which loading
this reader turns on.  It reads nothing where the program counts no
evaluate chunk: a program without the counters."""
try:
    from repro_torch.core import telemetry
except ImportError:                  # no program beside the benchmark
    telemetry = None
if hasattr(telemetry, "enable"):
    telemetry.enable()


def read(run):
    if not hasattr(telemetry, "counts"):
        return None          # a program without the counters
    counts = telemetry.counts()
    chunks = sum(k for (name, _), k in counts.items()
                 if name == "engine.eval_chunks")
    if not chunks:
        return None
    fused = sum(k for (name, _), k in counts.items()
                if name == "engine.fused_chunks")
    return fused / chunks
