"""driver.phase_a_share: seconds inside phase A of MPDP-general (the host
driver ``core/blocks.np_pairs_for_sets``, as ``core/batch`` and
``core/engine`` reach it) in the window, over the window.  It reads 0 where
no query is cyclic."""
from portbench.tracing import clip

SPANS = {"driver.phase_a": "repro_torch.core.blocks:np_pairs_for_sets"}


def read(run):
    t0, t1 = run.window
    return sum(clip(a, b, t0, t1)
               for _, a, b, _, _ in run.recorder.spans_named("driver.phase_a")
               ) / (t1 - t0)
