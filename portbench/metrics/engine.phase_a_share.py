"""engine.phase_a_share: the seconds of phase A of MPDP-general (the
program's ``engine.phase_a`` spans: the batched and solo engines' block
decomposition of a level on the host) inside the window, over the window.
It reads 0 where no query is cyclic.  Read from the program's own spans
(``repro_torch.core.telemetry``), which loading this reader turns on.
Where the recorder's buffer dropped spans the reading would undercount,
so it reads nothing."""
from portbench.tracing import clip

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
    return sum(clip(s.t0 * 1e-9, s.t1 * 1e-9, t0, t1) for s in spans
               if s.name == "engine.phase_a") / (t1 - t0)
