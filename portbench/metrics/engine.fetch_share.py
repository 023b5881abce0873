"""engine.fetch_share: the share of the level loop's stages (the
program's ``engine.filter`` and ``engine.evaluate`` spans) inside the
window that the host spends blocked in a device-to-host read
(``engine.fetch`` spans whose parent is one of those stages).  Read from
the program's own spans (``repro_torch.core.telemetry``), which loading
this reader turns on.  Where the recorder's buffer dropped spans
the reading would undercount, so it reads nothing."""
from portbench.tracing import clip

STAGES = ("engine.filter", "engine.evaluate")

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
    loop = {s.id for s in spans if s.name in STAGES}
    stages = sum(clip(s.t0 * 1e-9, s.t1 * 1e-9, t0, t1) for s in spans
                 if s.name in STAGES)
    fetch = sum(clip(s.t0 * 1e-9, s.t1 * 1e-9, t0, t1) for s in spans
                if s.name == "engine.fetch" and s.parent in loop)
    return fetch / stages if stages > 0 else 0.0
