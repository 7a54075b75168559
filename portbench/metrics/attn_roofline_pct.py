"""attn_roofline_pct: the least seconds of the attention launches that the
port's counters report in the window, each at the cell's shape (a forward's
crops × S tokens × 3·width), over the device seconds of the attention kernels
in the trace, in percent. The table of counters, their element sizes and the
kernels' names is ``attention_kernels.json`` beside this file."""
import json
import os

from portbench import roofline

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "attention_kernels.json")


def read(run):
    if run.trace is None:
        return None
    with open(TABLE) as f:
        table = json.load(f)
    cfg = run.config
    bound = 0.0
    for entry in table["counters"]:
        launches = run.counters.get(entry["counter"], 0)
        bound += launches * roofline.attention_launch_s(
            run.window["crops_per_forward"], cfg["seq_len"], cfg["width"],
            entry["in_bytes"], entry["out_bytes"])
    names = table["kernel_names"]
    device = run.trace.op_seconds(lambda n: any(k in n for k in names))
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
