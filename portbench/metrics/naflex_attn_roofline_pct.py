"""naflex_attn_roofline_pct: the least seconds of every attention launch in
the window, each at its real lengths (``naflex_roofline.attention_bound_s``):
the crops' launches over a forward's crops at ``seq_len`` (the counters of
``attention_kernels.json`` less the launches given per-sequence lengths),
and each native forward's ``layers`` launches over its rows' real patch
counts; over the device seconds of the kernels that table names, in
percent. None where the run recorded no native rows."""
import json
import os

from portbench import naflex_roofline

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "attention_kernels.json")


def read(run):
    w = run.window
    batches = w.get("native_batches")
    if run.trace is None or not batches:
        return None
    with open(TABLE) as f:
        table = json.load(f)
    cfg = run.config
    launches = sum(run.counters.get(e["counter"], 0) for e in table["counters"])
    crop_launches = launches - w.get("varlen_launches", 0)
    crop_lengths = [cfg["seq_len"]] * w["crops_per_forward"]
    bound = crop_launches * naflex_roofline.attention_bound_s(crop_lengths, cfg["width"])
    bound += cfg["layers"] * sum(naflex_roofline.attention_bound_s(b, cfg["width"])
                                 for b in batches)
    names = table["kernel_names"]
    device = run.trace.op_seconds(lambda n: any(k in n for k in names))
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
