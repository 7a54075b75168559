"""dedup_normalize_s: seconds a pass in the port's ``StageTimer`` stage
``normalize`` (the host's float32 normalization of the rows and their pad to
whole panels); None where the port has no such stage."""


def read(run):
    w = run.window
    s = w.get("stage_s", {}).get("normalize")
    return s / w["passes"] if s is not None and w.get("passes") else None
