"""engine.device_fold_share: the share of the engines' evaluate chunks
that folded into their level's key buffer on the device, with no read-back
of their own (the program's ``engine.folded_chunks`` counter), over every
evaluate chunk (its ``engine.eval_chunks`` counter), both counted where a
level loop takes a chunk body's result and summed over every request the
recorder counted.  It needs no window, so it reads alike under the daemon
and in-process.  Read from the program's own counters
(``repro_torch.core.telemetry``), which loading this reader turns on.  It
reads nothing where the program has no device fold
(``repro_torch.core.chunks.DeviceFold``) or counts no evaluate chunk."""
try:
    from repro_torch.core import chunks, telemetry
except ImportError:                  # no program beside the benchmark
    chunks = telemetry = None
if hasattr(telemetry, "enable"):
    telemetry.enable()


def read(run):
    if not hasattr(chunks, "DeviceFold") or not hasattr(telemetry, "counts"):
        return None          # a program without the device fold
    counts = telemetry.counts()
    evals = sum(k for (name, _), k in counts.items()
                if name == "engine.eval_chunks")
    if not evals:
        return None
    folded = sum(k for (name, _), k in counts.items()
                 if name == "engine.folded_chunks")
    return folded / evals
