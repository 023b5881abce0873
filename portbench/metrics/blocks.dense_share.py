"""blocks.dense_share: the seconds of phase A's dense path (the program's
``blocks.dense`` spans: ``blocks.np_pairs_for_sets`` on a query whose
cyclomatic number exceeds ``cyc_cap``, as every clique of 9 relations or
more does) inside the window, over the window.  Read from the program's
own spans (``repro_torch.core.telemetry``), which loading this reader turns
on.  It reads nothing where the recorder's buffer dropped spans (the
reading would undercount), or where no ``blocks.dense`` span was recorded
at all: a program without the span."""
from portbench.tracing import clip

try:
    from repro_torch.core import telemetry
except ImportError:                  # no program beside the benchmark
    telemetry = None
if hasattr(telemetry, "enable"):
    telemetry.enable()


def read(run):
    spans = telemetry.spans() if hasattr(telemetry, "spans") else []
    dense = [s for s in spans if s.name == "blocks.dense"]
    if not dense or telemetry.dropped():
        return None          # no such span, or a full buffer lost some
    t0, t1 = run.window
    return sum(clip(s.t0 * 1e-9, s.t1 * 1e-9, t0, t1)
               for s in dense) / (t1 - t0)
