"""dedup_quantize_s: seconds a pass in the port's ``StageTimer`` stage
``quantize_rows`` (the host's int8 quantization of the rows, or the float16
cast, and the pad of the width); None where the port has no such stage."""


def read(run):
    w = run.window
    s = w.get("stage_s", {}).get("quantize_rows")
    return s / w["passes"] if s is not None and w.get("passes") else None
