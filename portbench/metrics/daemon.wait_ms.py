"""daemon.wait_ms: the median over requests completed in the window of
the client-side time less the daemon's own wall for it (the reply's
``wall_s``): socket, codecs, and the queue behind other tenants."""
import numpy as np


def read(run):
    t1 = run.window[1]
    waits = [r.t_done - r.t_send - r.server_s for r in run.requests
             if r.ok and r.t_done <= t1 and r.server_s is not None]
    if not waits:
        return None
    return float(np.median(np.asarray(waits))) * 1e3
