"""engine.chunk_ms: the median length, in ms, of one evaluate chunk of the
engines' level loops (the program's ``engine.chunk`` spans: a chunk's
launch and the drain after it, with the fetches it waits for), over the
chunks that ended inside the window.  Read from the program's own spans
(``repro_torch.core.telemetry``), which loading this reader turns on.  It
reads nothing where the recorder's buffer dropped spans, or where no
``engine.chunk`` span was recorded at all: a program without the span."""
import numpy as np

try:
    from repro_torch.core import telemetry
except ImportError:                  # no program beside the benchmark
    telemetry = None
if hasattr(telemetry, "enable"):
    telemetry.enable()


def read(run):
    spans = telemetry.spans() if hasattr(telemetry, "spans") else []
    chunks = [s for s in spans if s.name == "engine.chunk"]
    if not chunks or telemetry.dropped():
        return None          # no such span, or a full buffer lost some
    t0, t1 = run.window
    ms = [(s.t1 - s.t0) * 1e-6 for s in chunks if t0 <= s.t1 * 1e-9 <= t1]
    return float(np.median(ms)) if ms else None
