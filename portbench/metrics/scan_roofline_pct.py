"""scan_roofline_pct: the least seconds of the window's scans (N(N−1)/2 · D · 2
int8 operations a pass at the int8 peak, the rows read once) over the
device's busy seconds while the host was in ``scan``, in percent."""
from portbench import roofline


def read(run):
    if run.trace is None or not run.window.get("passes"):
        return None
    busy = run.trace.busy_within("scan")
    if busy <= 0:
        return None
    bound = run.window["passes"] * roofline.scan_bound_s(run.window["rows"], run.config["embed_dim"])
    return 100.0 * bound / busy
