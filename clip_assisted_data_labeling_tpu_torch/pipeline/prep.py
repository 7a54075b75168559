"""Stage 0 — dataset prep: uuid-rename all file groups, normalize images
(port of the JAX package's ``pipeline/prep.py``).

Files sharing a basename (image + prompt sidecars) get one uuid4-hex name;
rename-in-place or copy mode; optional downscale of images above
--max_n_pixels and jpg conversion (quality 95); natural-sorted traversal;
interactive 'yes' confirmation before destructive rename (``--yes`` skips
it for scripted runs).

Reference bugs fixed, as the JAX package fixes them:
  * each axis is scaled by sqrt(max_n_pixels / (w*h)), not by the full
    pixel ratio (which over-shrank);
  * LANCZOS, not the removed PIL Image.ANTIALIAS;
  * --shuffle_file_order shuffles the uuid list in place.

Each image's size comes from its header (``data/imsize.header_size``: PNG or
JPEG; PIL's for other formats), so a file that needs no resize and no
conversion is renamed or copied without PIL. Only a resize or a conversion
imports PIL; where PIL is missing, such a file fails inside the per-file
try and is counted as skipped, as any file the JAX stage cannot process.
Host only: no device.
"""
from __future__ import annotations

import argparse
import math
import os
import random
import shutil

from clip_assisted_data_labeling_tpu_torch.data.imsize import header_size
from clip_assisted_data_labeling_tpu_torch.utils.naming import natural_sort, new_uuid

ALL_IMG_EXTENSIONS = [
    ".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif", ".webp",
    ".JPEG", ".JPG", ".PNG", ".BMP", ".TIFF", ".TIF", ".WEBP",
]


def _image_size(path: str) -> tuple[int, int]:
    """(width, height): from the header where it is a PNG or a JPEG, else
    PIL's (which raises for a file it cannot identify)."""
    size = header_size(path)
    if size is None:
        from PIL import Image

        with Image.open(path) as img:
            size = img.size
    return size


def process_file(orig_path: str, new_path: str, mode: str, max_n_pixels: int,
                 convert_to_jpg: bool) -> tuple[int, int]:
    """Normalize + move one file; returns (converted, resized) flags."""
    os.makedirs(os.path.dirname(new_path), exist_ok=True)
    ext = os.path.splitext(orig_path)[1]
    converted, resized = 0, 0

    if ext in ALL_IMG_EXTENSIONS:
        width, height = _image_size(orig_path)
        if width * height > max_n_pixels:
            from PIL import Image

            scale = math.sqrt(max_n_pixels / (width * height))
            img = Image.open(orig_path).resize(
                (max(1, int(width * scale)), max(1, int(height * scale))),
                Image.LANCZOS,
            )
            if convert_to_jpg:
                new_path = os.path.splitext(new_path)[0] + ".jpg"
                img = img.convert("RGB")
            img.save(new_path, quality=95)
            resized = 1
            if mode == "rename":
                os.remove(orig_path)
        elif convert_to_jpg and ext.lower() not in (".jpg", ".jpeg"):
            from PIL import Image

            new_path = os.path.splitext(new_path)[0] + ".jpg"
            Image.open(orig_path).convert("RGB").save(new_path, quality=95)
            if mode == "rename":
                os.remove(orig_path)
            converted = 1

    if not converted and not resized:
        if mode == "rename":
            os.rename(orig_path, new_path)
        else:
            shutil.copy(orig_path, new_path)
    return converted, resized


def plan_renames(root_dir: str, output_dir: str,
                 shuffle_file_order: bool) -> list[tuple[str, str]]:
    """Walk the tree and assign each basename-group its uuid destination.

    Within a directory, groups are visited in natural-sort order and the
    uuids are themselves natural-sorted before assignment, so sorted-by-name
    order survives the rename (unless shuffled).
    """
    moves: list[tuple[str, str]] = []
    for subdir, _dirs, files in os.walk(root_dir):
        groups: dict[str, list[str]] = {}
        for name in natural_sort(files):
            stem, ext = os.path.splitext(name)
            groups.setdefault(stem, []).append(ext)

        uuids = natural_sort([new_uuid() for _ in groups])
        if shuffle_file_order:
            random.shuffle(uuids)

        dest_dir = subdir.replace(root_dir, output_dir, 1)
        for uid, (stem, exts) in zip(uuids, groups.items()):
            for ext in exts:
                moves.append(
                    (os.path.join(subdir, stem + ext),
                     os.path.join(dest_dir, uid + ext))
                )
    return moves


def prep_dataset_directory(root_dir: str, output_dir: str, mode: str,
                           max_n_pixels: int, convert_imgs_to_jpg: bool,
                           shuffle_file_order: bool) -> dict:
    os.makedirs(output_dir, exist_ok=True)
    moves = plan_renames(root_dir, output_dir, shuffle_file_order)
    print(f"Prep: {len(moves)} files under {root_dir} -> {output_dir} ({mode})")

    stats = {"renamed": 0, "converted": 0, "resized": 0, "skipped": 0}
    for orig, new in moves:
        try:
            c, r = process_file(orig, new, mode, max_n_pixels, convert_imgs_to_jpg)
            stats["renamed"] += 1
            stats["converted"] += c
            stats["resized"] += r
        except Exception as e:  # one bad file is reported and skipped, not fatal
            print(f"Could not process {orig}: {e}")
            stats["skipped"] += 1
    print(
        f"Prep done: {stats['renamed']} files processed "
        f"({stats['converted']} jpg-converted, {stats['resized']} downscaled, "
        f"{stats['skipped']} skipped)"
    )
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--mode", type=str, default="copy", choices=["copy", "rename"])
    parser.add_argument("--max_n_pixels", type=int, default=2048 * 2048)
    parser.add_argument("--convert_imgs_to_jpg", action="store_true")
    parser.add_argument("--shuffle_file_order", action="store_true")
    parser.add_argument("--yes", action="store_true",
                        help="skip the interactive confirmation for rename mode")
    args = parser.parse_args(argv)

    if args.mode == "copy" and args.output_dir is None:
        raise ValueError("Output directory must be specified when mode is 'copy'")
    if args.output_dir is None:
        args.output_dir = args.root_dir
        args.mode = "rename"

    if args.mode == "rename" and not args.yes:
        print(f"rename mode is DESTRUCTIVE: every file under {args.root_dir} "
              "will be renamed in place (and possibly downscaled/converted).")
        if input("Type 'yes' to continue: ") != "yes":
            raise ValueError("Aborted")

    return prep_dataset_directory(
        args.root_dir, args.output_dir, args.mode, args.max_n_pixels,
        args.convert_imgs_to_jpg, args.shuffle_file_order,
    )


if __name__ == "__main__":
    main()
