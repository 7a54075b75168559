"""naflex_mfu: the least seconds of the window's work at the bf16 peak
(``naflex_roofline.window_bound_s``: each image's four crops at ``seq_len``
and its native row at its real patch count, the patch embeddings, the
position resize and the MAP heads included) over the seconds the device was
busy in the traced window, in percent. None where the run recorded no
native rows (a program without the native path in the loop)."""
from portbench import naflex_roofline


def read(run):
    w = run.window
    batches = w.get("native_batches")
    if run.trace is None or not w.get("images") or not batches or run.trace.busy_s <= 0:
        return None
    crops = w["images"] * (w["crops_per_forward"] // run.traffic["batch_size"])
    lengths = [n for b in batches for n in b]
    return 100.0 * naflex_roofline.window_bound_s(run.config, crops, lengths) / run.trace.busy_s
