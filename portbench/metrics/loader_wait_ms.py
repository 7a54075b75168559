"""loader_wait_ms: milliseconds a batch of the window that the embed loop
waited on the loader's next batch (the harness's ``loader_wait`` span)."""


def read(run):
    n = run.window.get("batches")
    return 1e3 * run.spans.totals.get("loader_wait", 0.0) / n if n else None
