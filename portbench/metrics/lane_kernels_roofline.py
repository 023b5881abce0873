"""lane_kernels_roofline: the lane-building kernels' share of their
roofline in the profiled sub-window, in %: for each kernel, its launches
in the device trace times the mean bound of the launches captured there
(``yardstick/work.py``: the larger of bytes over 3.35 TB/s and int32
operations over the assumed 16.7 T/s), summed, over the kernels' device
seconds."""

CAPTURE = True


def read(run):
    if run.device_trace is None:
        return None
    dev = run.device_trace.kernels()
    bound = time = 0.0
    for k, (n, secs) in dev.items():
        got = run.kernel_bounds.get(k)
        if not got or not n:
            continue
        bound += n * sum(b for b, _ in got) / len(got)
        time += secs
    if time <= 0 or bound <= 0:
        return None
    return 100.0 * bound / time
