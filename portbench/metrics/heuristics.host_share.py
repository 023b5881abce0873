"""heuristics.host_share: the share of the heuristic's ``solve`` wall in the
window spent outside its ``optimize_many`` calls (partitioning, the
re-costing and merges on the host)."""
from portbench.tracing import clip

SPANS = {"heuristics.solve": "repro_torch.heuristics.uniondp:solve",
         "heuristics.optimize_many": "repro_torch.core.engine:optimize_many"}


def read(run):
    t0, t1 = run.window
    solve = sum(clip(a, b, t0, t1) for _, a, b, _, _ in
                run.recorder.spans_named("heuristics.solve"))
    inner = sum(clip(a, b, t0, t1) for _, a, b, _, _ in
                run.recorder.spans_named("heuristics.optimize_many"))
    if solve <= 0:
        return None
    return (solve - inner) / solve
