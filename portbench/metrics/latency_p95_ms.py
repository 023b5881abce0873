"""latency_p95_ms: the 95th percentile (linear interpolation) of the
client-side time of every request completed inside the window, from the
client's send to its decoded reply; a failed request counts with its
time."""
import numpy as np


def read(run):
    t1 = run.window[1]
    lat = [r.t_done - r.t_send for r in run.requests if r.t_done <= t1]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
