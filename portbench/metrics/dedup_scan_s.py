"""dedup_scan_s: seconds a pass in the port's ``StageTimer`` stage ``scan``
(every tile of the upper triangle, and the counts read back)."""


def read(run):
    w = run.window
    s = w.get("stage_s", {}).get("scan")
    return s / w["passes"] if s is not None and w.get("passes") else None
