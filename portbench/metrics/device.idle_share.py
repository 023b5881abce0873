"""device.idle_share: 1 less the union of device activity (every kernel,
copy and set) over the profiled sub-window's length."""


def read(run):
    if run.device_trace is None:
        return None
    tr = run.device_trace
    return 1.0 - tr.busy_s() / tr.window_s
