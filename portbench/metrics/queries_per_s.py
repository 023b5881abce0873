"""queries_per_s: the queries answered over the window's length, all the
work of the window counted: every request answered inside it, and of each
request still out when it closes the share of its time that lay inside.
(A count of whole answers alone swings by one long request.)"""


def read(run):
    t0, t1 = run.window
    done = 0.0
    for r in run.requests:
        if not r.ok or r.t_send >= t1:
            continue
        if r.t_done <= t1:
            done += len(r.wires)
        else:
            done += len(r.wires) * (t1 - max(r.t_send, t0)) \
                / (r.t_done - r.t_send)
    return done / (t1 - t0)
