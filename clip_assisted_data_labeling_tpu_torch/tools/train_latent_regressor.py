"""Prompt-latent → score regressor (port of the JAX package's
``tools/train_latent_regressor.py``).

    python -m clip_assisted_data_labeling_tpu_torch.tools.train_latent_regressor \\
        --train_data_dir <dir> --train_data_names <name> [--device cpu]

Given a dataset of diffusion prompt embeddings (``<uuid>.pth`` tensors, e.g.
[2, 77, 768] c/uc stacks) and the label CSV ``<name>.csv``, learns a mapping
from prompt latents to aesthetic scores. Rows without a human label use
``predicted_label * 0.5`` as a soft pseudo-label; a row with neither, or
without a readable ``.pth``, is skipped. The CSV is read with the stdlib
``csv`` module (no pandas) and shuffled with
``np.random.RandomState(seed).permutation(n)``, the order of pandas'
``sample(frac=1, random_state=seed)``; training is the port's stage 4
(``pipeline/train.train_regressor`` on ``--device``, default ``cuda``) and
the checkpoint its ``save_model``.
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.config import TrainConfig
from clip_assisted_data_labeling_tpu_torch.pipeline.train import save_model, train_regressor
from clip_assisted_data_labeling_tpu_torch.store.database import _NA
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device


def _number(cell: str | None) -> float:
    """A CSV cell as pandas reads a numeric one: NaN for a missing value.
    Raises (KeyError for an absent column, ValueError for text)."""
    if cell is None:
        raise KeyError("column absent")
    return np.nan if cell in _NA else float(cell)


def load_latents(train_data_dir: str, train_data_names: list[str],
                 seed: int = 42):
    """(features [N, F] float32, labels [N] float32) over the datasets'
    rows in their seeded shuffle order."""
    features, labels = [], []
    for name in train_data_names:
        with open(os.path.join(train_data_dir, name + ".csv"), newline="") as f:
            rows = list(csv.DictReader(f))  # blank lines skipped, as pandas skips them
        # seeded: --random_seed must make the whole run reproducible, and an
        # unseeded shuffle here feeds the (seeded) split different row sets
        order = np.random.RandomState(seed).permutation(len(rows))
        n_samples, skips = 0, 0
        for i in order:
            row = rows[i]
            try:
                label = _number(row.get("label"))
                if np.isnan(label):
                    label = _number(row.get("predicted_label")) * 0.5
                if np.isnan(label):
                    raise ValueError("no label")
                latents = torch.load(
                    os.path.join(train_data_dir, name, f"{row['uuid']}.pth"),
                    map_location="cpu", weights_only=True,
                )
                features.append(np.asarray(latents.float().numpy()).reshape(-1))
                labels.append(float(label))
                n_samples += 1
            except Exception:  # no label, or no readable latents: skip the row
                skips += 1
        print(f"Loaded {n_samples} samples from {name}" + (f" ({skips} skipped)" if skips else ""))
    return np.stack(features).astype(np.float32), np.asarray(labels, np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--train_data_dir", required=True)
    parser.add_argument("--train_data_names", type=str, nargs="+", required=True)
    parser.add_argument("--model_name", default="latent_regressor")
    parser.add_argument("--test_fraction", type=float, default=0.25)
    parser.add_argument("--n_epochs", type=int, default=40)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--weight_decay", type=float, default=6e-4)
    parser.add_argument("--dropout_prob", type=float, default=0.5)
    parser.add_argument("--hidden_sizes", type=int, nargs="+", default=[264, 128, 64])
    parser.add_argument("--random_seed", type=int, default=42)
    parser.add_argument("--dont_save", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = TrainConfig(
        clip_models_to_use=("prompt_latents",),
        crop_names=("prompt_latents",),
        test_fraction=args.test_fraction,
        n_epochs=args.n_epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.weight_decay,
        dropout_prob=args.dropout_prob,
        hidden_sizes=tuple(args.hidden_sizes),
        random_seed=args.random_seed,
        model_name=args.model_name,
        dont_save=args.dont_save,
    )
    features, labels = load_latents(args.train_data_dir, args.train_data_names,
                                    seed=args.random_seed)
    print("Features shape:", features.shape)
    model, history = train_regressor(features, labels, cfg, ["prompt_latents"], device=device)
    path = None if args.dont_save else save_model(model, history, cfg)
    return model, history, path


if __name__ == "__main__":
    main()
