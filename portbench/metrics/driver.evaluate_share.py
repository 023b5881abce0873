"""driver.evaluate_share: the ``filter`` and ``evaluate`` stage seconds of
``OptimizeResult.timings`` (host spans around the level loop's stages that
end in a sync), over the window.  A flight's results carry copies of one
dict, so each distinct dict counts once a call; a call counts when it
ends inside the window."""

STAGES = ("filter", "evaluate")


def _stage_seconds(out):
    results = out[0] if isinstance(out, tuple) else out
    seen = {tuple(sorted(r.timings.items())) for r in results if r.timings}
    return sum(dict(t).get(k, 0.0) for t in seen for k in STAGES)


SPANS = {
    "driver.stages.stream": (
        "repro_torch.core.service:StreamOptimizer.optimize_stream",
        _stage_seconds),
    "driver.stages.batch": ("repro_torch.core.batch:optimize_many",
                            _stage_seconds),
}


def read(run):
    t0, t1 = run.window
    total = sum(extra for name in SPANS
                for _, _, b, _, extra in run.recorder.spans_named(name)
                if t0 <= b <= t1)
    return total / (t1 - t0)
