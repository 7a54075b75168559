"""Readings of a cell's control: the plain reference computed one precision
step below the configuration's, put in the program's place, at the cell's own
size, and held against the reference by the numbers that decide ``correct``.
A sound limit lies below every reading this prints. Where the driver reads
them, the line also carries ``faults``: what a misplaced answer would read at
the cell's size, from the reference's own outputs.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

One line of JSON a seed. The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench import registry
from portbench.run import Run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    for seed in args.seeds:
        run = Run(cell, seed, 0.0, False, torch.device(args.device))
        numbers = registry.driver(cell["traffic"]).control(run)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": numbers,
                          "faults": run.faults, "limits": cell["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
