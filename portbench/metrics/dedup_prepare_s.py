"""dedup_prepare_s: seconds a pass in the port's ``StageTimer`` stage
``prepare`` (host normalization and quantization, and the upload)."""


def read(run):
    w = run.window
    s = w.get("stage_s", {}).get("prepare")
    return s / w["passes"] if s is not None and w.get("passes") else None
