"""write_ms: milliseconds a batch of the window in the store's
``write_rows`` and waiting on the sidecar writes (the harness's
``store_write`` and ``sidecar_wait`` spans)."""


def read(run):
    n = run.window.get("batches")
    t = run.spans.totals
    return 1e3 * (t.get("store_write", 0.0) + t.get("sidecar_wait", 0.0)) / n if n else None
