"""uniondp.host_share: the share of UnionDP's ``solve`` (the program's
outermost ``uniondp.solve`` spans) inside the window spent outside its
batched subproblem passes (``uniondp.subsolve`` spans): partitioning,
sub-graph extraction, plan expansion and merges, and the re-optimisation's
host work.  Read from the program's own spans
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
    solves = {s.id for s in spans if s.name == "uniondp.solve"}
    solve = sum(clip(s.t0 * 1e-9, s.t1 * 1e-9, t0, t1) for s in spans
                if s.id in solves and s.parent not in solves)
    sub = sum(clip(s.t0 * 1e-9, s.t1 * 1e-9, t0, t1) for s in spans
              if s.name == "uniondp.subsolve")
    return (solve - sub) / solve if solve > 0 else 0.0
