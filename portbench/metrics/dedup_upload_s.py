"""dedup_upload_s: seconds a pass in the port's ``StageTimer`` stage ``upload``
(the wire's copy to the device); None where the port has no such stage."""


def read(run):
    w = run.window
    s = w.get("stage_s", {}).get("upload")
    return s / w["passes"] if s is not None and w.get("passes") else None
