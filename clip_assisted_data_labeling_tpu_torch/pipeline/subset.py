"""Stage 6 — export a score-filtered subset of the dataset (port of the JAX
package's ``pipeline/subset.py``).

The score of a row is its human label rescaled by the largest label where
it has one, else its predicted label. Rows in [min_score, max_score] whose
image passes the aspect-ratio and pixel-count gates have each chosen
extension copied per uuid; the output folder's name gives the range and, at
the end, the image count. ``--test`` dry-runs. Counters count only files
that exist (the reference counted every extension of every row).

Each image's size comes from its file header (``data/imsize.image_size``:
PIL where installed, else the PNG or JPEG header), with no pixel decode.
The CSV is read with the stdlib ``csv`` module (``store/database.py``).
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from clip_assisted_data_labeling_tpu_torch.config import SubsetConfig
from clip_assisted_data_labeling_tpu_torch.data.imsize import image_size
from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase, database_path_for


def _max_label(labels: np.ndarray) -> float:
    """The largest human label, as pandas' max gives it: NaN skipped, and NaN
    for a column without a label."""
    has_label = ~np.isnan(labels)
    return labels[has_label].max() if has_label.any() else np.nan


def final_scores(labels: np.ndarray, predicted: np.ndarray) -> np.ndarray:
    """Per row: label / max label where a human label exists (the label as
    it is when the max is 0), else the predicted label; NaN where neither."""
    max_actual_label = _max_label(labels)
    scaled = labels / max_actual_label if max_actual_label else labels
    return np.where(~np.isnan(labels), scaled, predicted)


def copy_subset(input_dir: str, cfg: SubsetConfig, output_suffix: str = "_subset") -> str | None:
    database_path = database_path_for(input_dir)
    if not os.path.exists(database_path):
        raise FileNotFoundError(f"no label database {database_path}")
    database = LabelDatabase.load_or_create(input_dir)
    print(f"Loaded database with {len(database)} rows")

    labels = database.column("label")
    print(f"Max actual label: {_max_label(labels)}")

    finals = final_scores(labels, database.column("predicted_label"))
    in_range = (cfg.min_score <= finals) & (finals <= cfg.max_score)
    selected = [u for u, ok in zip(database.column("uuid"), in_range) if ok]
    print(
        f"Found {len(selected)} rows with {cfg.min_score} < final_label < {cfg.max_score}"
    )

    suffix = f"_{cfg.min_score:.2f}_to_{cfg.max_score:.2f}" + output_suffix
    output_folder = input_dir.rstrip("/") + suffix
    if cfg.test:
        print("##### Running in TEST MODE: not actually copying any files #####")
    else:
        if os.path.exists(output_folder) and os.listdir(output_folder):
            # leftovers of an interrupted run would be counted into this run's
            # _{n}_imgs suffix: refuse before any copy
            raise SystemExit(
                f"{output_folder} already exists and is not empty — delete it "
                "(or rename the previous run's output) and re-run"
            )
        os.makedirs(output_folder, exist_ok=True)

    counter = dict.fromkeys(cfg.extensions, 0)
    for uuid in selected:
        img_path = os.path.join(input_dir, f"{uuid}.jpg")
        try:
            width, height = image_size(img_path)
        except Exception as e:  # a missing or unreadable image: report, skip
            print(f"Could not open {img_path}, {e}")
            continue
        aspect = width / height
        if (
            aspect < cfg.min_aspect_ratio
            or aspect > cfg.max_aspect_ratio
            or width * height <= cfg.min_n_pixels
        ):
            continue
        for ext in cfg.extensions:
            src = os.path.join(input_dir, f"{uuid}{ext}")
            if os.path.exists(src):
                if not cfg.test:
                    shutil.copy(src, os.path.join(output_folder, f"{uuid}{ext}"))
                counter[ext] += 1

    for ext, count in counter.items():
        print(f"Copied {count} files with extension {ext} to {output_folder}")

    if not cfg.test:
        img_exts = (".jpg", ".jpeg", ".png")
        n_imgs = len([f for f in os.listdir(output_folder) if f.endswith(img_exts)])
        final_folder = output_folder + f"_{n_imgs}_imgs"
        if os.path.exists(final_folder):
            # a previous identical run's output: keep both
            i = 2
            while os.path.exists(f"{final_folder}_{i}"):
                i += 1
            print(f"{final_folder} already exists — saving as {final_folder}_{i}")
            final_folder = f"{final_folder}_{i}"
        os.rename(output_folder, final_folder)
        return final_folder
    return None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--min_score", type=float, required=True)
    parser.add_argument("--max_score", type=float, default=1.0)
    parser.add_argument("--extensions", nargs="+", default=[".jpg", ".txt", ".pt", ".pth"])
    parser.add_argument("--min_aspect_ratio", type=float, default=0.25)
    parser.add_argument("--max_aspect_ratio", type=float, default=4.00)
    parser.add_argument("--min_n_pixels", type=int, default=512 * 512)
    parser.add_argument("--test", action="store_true")
    args = parser.parse_args(argv)

    cfg = SubsetConfig(
        min_score=args.min_score,
        max_score=args.max_score,
        extensions=tuple(args.extensions),
        min_aspect_ratio=args.min_aspect_ratio,
        max_aspect_ratio=args.max_aspect_ratio,
        min_n_pixels=args.min_n_pixels,
        test=args.test,
    )
    return copy_subset(args.input_dir, cfg)


if __name__ == "__main__":
    main()
