"""Standalone directory scorer (port of the JAX package's
``pipeline/predict_simple.py``): score every image in a directory with a
trained regressor and the encoders it names, print the scores, and copy
each image to ``<dir>_aesthetic_scores/{score:.3f}_<name>`` unless
``--no_copy``.

Images decode through the loader's ``decode_rgb`` (cv2, else PIL, else the
port's PNG reader). CLI: the JAX scorer's flags plus ``--device`` (default
``cuda``; ``cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
import os
import shutil

from clip_assisted_data_labeling_tpu_torch.data.loader import decode_rgb
from clip_assisted_data_labeling_tpu_torch.models.aesthetic import AestheticRegressor

IMG_EXTENSIONS = (".jpg", ".png", ".jpeg", ".bmp", ".webp")


def predict_images(img_paths, model_path, output_dir=None, model_weights_dir=None,
                   device="cuda"):
    """{path: score} for each image; copies go to ``output_dir`` if set."""
    regressor = AestheticRegressor(model_path, model_weights_dir=model_weights_dir,
                                   device=device)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)

    print("\nPredicting aesthetic scores...")
    scores = {}
    for image_path in img_paths:
        score, _ = regressor.predict_score(decode_rgb(image_path))
        print(f"Score: {score:.3f} for {os.path.basename(image_path)}")
        scores[image_path] = score
        if output_dir is not None:
            shutil.copy(
                image_path,
                os.path.join(output_dir, f"{score:.3f}_" + os.path.basename(image_path)),
            )
    return scores


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_img_dir", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--model_weights_dir", type=str, default=None,
                        help="local CLIP weights directory")
    parser.add_argument("--no_copy", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    paths = [
        os.path.join(args.input_img_dir, f)
        for f in os.listdir(args.input_img_dir)
        if os.path.splitext(f)[1].lower() in IMG_EXTENSIONS
    ]
    print(f"Found {len(paths)} images in {args.input_img_dir}")
    out = None if args.no_copy else args.input_img_dir.rstrip("/") + "_aesthetic_scores"
    return predict_images(paths, args.model_path, out, args.model_weights_dir,
                          device=args.device)


if __name__ == "__main__":
    main()
