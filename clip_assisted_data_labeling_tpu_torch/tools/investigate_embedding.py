"""Debug printer for .pt feature sidecars (port of the JAX package's
``tools/investigate_embedding.py``): recursively dumps the dict structure,
tensor shapes, and scalar values.

    python -m clip_assisted_data_labeling_tpu_torch.tools.investigate_embedding <uuid>.pt

Host only: it reads the sidecar with ``store/sidecar.read_sidecar`` and
prints the same lines as the JAX tool."""
from __future__ import annotations

import argparse

import numpy as np


def print_structure(obj, indent: int = 0) -> None:
    pad = " " * indent
    if isinstance(obj, dict):
        for key, value in obj.items():
            if isinstance(value, dict):
                print(f"{pad}{key}:")
                print_structure(value, indent + 2)
            else:
                print(f"{pad}{key}: {_describe(value)}")
    else:
        print(f"{pad}{_describe(obj)}")


def _describe(value) -> str:
    """``scalar <value>`` for a 0-d value (a float or a 0-d array), else the
    array's shape and dtype."""
    arr = np.asarray(value)
    if arr.ndim == 0:
        return f"scalar {float(arr):.6f}"
    return f"array shape={tuple(arr.shape)} dtype={arr.dtype}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("pt_file", help="path to a <uuid>.pt sidecar")
    args = parser.parse_args(argv)

    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    d = read_sidecar(args.pt_file)
    for model, feats in d.items():
        print(f"{model}:")
        if isinstance(feats, dict):
            for k, v in feats.items():
                print(f"  {k}: {_describe(v)}")
        else:
            print(f"  {_describe(feats)}")


if __name__ == "__main__":
    main()
