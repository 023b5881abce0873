"""daemon.queue_ms: the median wait of a request in the daemon's queue,
from its admission to the worker's pickup (the program's ``daemon.queue``
span), over the requests whose reply was encoded (``daemon.encode``
ended) inside the window.  Read from the program's own spans
(``repro_torch.core.telemetry``), which loading this reader turns on.
Where the recorder's buffer dropped spans the reading would undercount,
so it reads nothing."""
import numpy as np

try:
    from repro_torch.core import telemetry
except ImportError:                  # no program beside the benchmark
    telemetry = None
if hasattr(telemetry, "enable"):
    telemetry.enable()


def read(run):
    spans = telemetry.spans() if hasattr(telemetry, "spans") else []
    if not spans or telemetry.dropped():
        return None          # no program span, or a full buffer lost some
    t0, t1 = run.window
    done = {s.request for s in spans
            if s.name == "daemon.encode" and t0 <= s.t1 * 1e-9 <= t1}
    waits = [(s.t1 - s.t0) * 1e-6 for s in spans
             if s.name == "daemon.queue" and s.request in done]
    return float(np.median(waits)) if waits else 0.0
