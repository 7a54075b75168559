"""dedup_rows_per_s: the rows of every whole pass of the window, over the
seconds of those passes."""


def read(run):
    w = run.window
    return w["rows"] * w["passes"] / w["seconds"] if w.get("passes") else None
