"""dedup_recheck_s: seconds a pass in the port's ``StageTimer`` stage ``recheck``
(the host's float32 recheck of the candidates); None where the port has no
such stage."""


def read(run):
    w = run.window
    s = w.get("stage_s", {}).get("recheck")
    return s / w["passes"] if s is not None and w.get("passes") else None
