"""idle_pct: the share of the traced window in which no operation ran on the
device, in percent. Read under the name of each cell kind's split of it
(``idle_pct.embed``, ``idle_pct.dedup``), each moving its kind's rate."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
