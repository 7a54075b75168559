"""embed_mfu: the least seconds of the window's images at the card's peaks, by
the configuration's published shapes (``roofline.vit_image_bound_s``), over
the seconds the device was busy in the traced window (the union of its
operations: the forwards, the stats, the uploads), in percent. The host's
stalls show in ``idle_pct``, not here."""
from portbench import roofline


def read(run):
    w = run.window
    if run.trace is None or not w.get("images") or run.trace.busy_s <= 0:
        return None
    per_image = roofline.vit_image_bound_s(run.config, w["crops_per_forward"] // run.traffic["batch_size"])
    return 100.0 * per_image * w["images"] / run.trace.busy_s
