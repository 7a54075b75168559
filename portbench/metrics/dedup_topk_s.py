"""dedup_topk_s: seconds a pass in the port's ``StageTimer`` stage ``topk`` (the
hit panels and their uploads, the device's top-k over every column panel, and
its read back); None where the port has no such stage."""


def read(run):
    w = run.window
    s = w.get("stage_s", {}).get("topk")
    return s / w["passes"] if s is not None and w.get("passes") else None
