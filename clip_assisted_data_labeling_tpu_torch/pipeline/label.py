"""Stage 3 — the human labelling loop (port of the JAX package's
``pipeline/label.py``, the same interaction contract).

Numkeys 0-9 map to labels 0.0-0.9, left/right navigate, q/ESC quits; the
existing label, or the predicted label, and the prompt sidecar's text are
overlaid; a progress bar tracks position; the CSV autosaves every 5 new
labels (at most once per 15 s once a save takes 0.2 s) and on exit; a
timestamped single-slot backup of the database is taken at session start;
labelled rows get their label copied into predicted_label (fix_database)
before the images are sorted.

Images load through the port's decode chain (``data/loader.decode_rgb``:
cv2, else PIL, else the port's PNG reader for PNG content under any name)
in cv2's BGR order. Where cv2 is installed the frames are the JAX
package's; without it the letterbox resizes bilinearly in numpy and the
overlay draws only the progress bar (no text).

The display is behind ui.LabelBackend: ``--backend opencv`` (default) for
the real window, ``--backend headless --keys 3,7,q`` for scripted runs,
which then prints the uuids it was shown. The diversity sorts run on
``--device`` (default ``cuda``; ``cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import logging
import os
import time

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.data import loader
from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase
from clip_assisted_data_labeling_tpu_torch.ui.backend import (
    HeadlessBackend,
    LabelBackend,
    OpenCVBackend,
)
from clip_assisted_data_labeling_tpu_torch.ui.sorting import (
    SORT_OPTIONS,
    prompt_sort_option,
    re_order_images,
)
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device
from clip_assisted_data_labeling_tpu_torch.utils.naming import natural_sort

log = logging.getLogger(__name__)

CANVAS = (1706, 960)  # reference letterbox size (_3:96)


def _resize_bilinear(image: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Bilinear resize on pixel centres (cv2's INTER_LINEAR mapping, in
    float64 with round half up) for when cv2 is not installed."""
    def taps(n_in, n_out):
        src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0, n_in - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, (src - lo)[:, None]

    y0, y1, wy = taps(image.shape[0], new_h)
    x0, x1, wx = taps(image.shape[1], new_w)
    img = image.astype(np.float64)
    rows = img[y0] * (1 - wy[:, :, None]) + img[y1] * wy[:, :, None]
    out = rows[:, x0] * (1 - wx[None]) + rows[:, x1] * wx[None]
    return np.floor(out + 0.5).astype(np.uint8)


def letterbox(image: np.ndarray, size=CANVAS) -> np.ndarray:
    """Fit-to-canvas letterbox (reference _3:96-109)."""
    h, w = image.shape[:2]
    ratio = min(size[0] / w, size[1] / h)
    new_w, new_h = int(w * ratio), int(h * ratio)
    if loader.cv2 is not None:
        resized = loader.cv2.resize(image, (new_w, new_h))
    else:
        resized = _resize_bilinear(image, new_w, new_h)
    canvas = np.zeros((size[1], size[0], 3), np.uint8)
    rh, rw = resized.shape[:2]
    y0 = (size[1] - rh) // 2
    x0 = (size[0] - rw) // 2
    canvas[y0 : y0 + rh, x0 : x0 + rw] = resized
    return canvas


def _read_bgr(path: str) -> np.ndarray | None:
    """[H, W, 3] uint8 in cv2's BGR order, or None where the file does not
    decode (the reference's ``cv2.imread`` returns None there)."""
    try:
        rgb = loader.decode_rgb(path)
    except Exception as e:  # a missing or broken image is skipped, not fatal
        log.warning("Could not decode %s: %s", path, e)
        return None
    return np.ascontiguousarray(rgb[:, :, ::-1])


def load_image_and_prompt(uuid: str, root_dir: str):
    """Image + prompt text from .txt/.json sidecars (reference _3:246-266)."""
    image = _read_bgr(os.path.join(root_dir, uuid + ".jpg"))
    prompt = ""
    txt = os.path.join(root_dir, uuid + ".txt")
    if os.path.exists(txt):
        with open(txt) as f:
            for line in f:
                prompt = line
    jpath = os.path.join(root_dir, uuid + ".json")
    if os.path.exists(jpath):
        try:
            with open(jpath) as f:
                prompt = json.load(f).get("text_input", "")
        except (OSError, ValueError, AttributeError):  # unreadable or foreign: no prompt
            prompt = ""
    return image, prompt


class ThumbnailCache:
    """LRU of letterboxed view frames keyed by uuid.

    Caching the LETTERBOXED canvas (fixed size, so memory is bounded at
    capacity·canvas bytes ≈ 2-3 MB each) makes repeat views disk-free;
    unloadable images cache as None so broken files are not re-probed every
    pass. ``show`` paths must draw on a COPY (the annotate overlay mutates
    its frame)."""

    def __init__(self, capacity: int = 64, loader=None):
        self.capacity = capacity
        self._loader = loader
        self._store: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, uuid: str, root_dir: str):
        """(letterboxed uint8 frame | None, prompt) — cached after first load."""
        if uuid in self._store:
            self._store.move_to_end(uuid)
            self.hits += 1
            return self._store[uuid]
        self.misses += 1
        load = self._loader or load_image_and_prompt
        image, prompt = load(uuid, root_dir)
        entry = (letterbox(image) if image is not None else None, prompt)
        self._store[uuid] = entry
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
        return entry


def _progress_bar(image: np.ndarray, progress: float) -> None:
    """The progress bar (reference _3:222-233), drawn in place: the pixels of
    cv2's two filled rectangles, corners included, clipped to the frame."""
    rows, cols = image.shape[:2]
    bar_w = int(cols * 0.8)
    x0 = int(cols * 0.1)
    y0 = rows - 10
    image[y0:rows, x0:x0 + bar_w + 1] = (255, 255, 255)
    image[y0:rows, x0:x0 + int(progress * bar_w) + 1] = (0, 255, 0)


def _annotate(image, label, predicted_label, prompt, progress):
    cv2 = loader.cv2
    if cv2 is None:
        pass  # no text without cv2: the frame keeps its bar
    elif label is not None and not (isinstance(label, float) and np.isnan(label)):
        cv2.putText(image, f"{label:.2f} || {prompt}", (10, 60),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (200, 100, 25), 2)
    elif predicted_label is not None and not (
        isinstance(predicted_label, float) and np.isnan(predicted_label)
    ):
        cv2.putText(image, f"predicted: {predicted_label:.3f} || {prompt}", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (200, 100, 25), 2)
    else:
        cv2.putText(image, f"{prompt}", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (200, 100, 25), 2)
    _progress_bar(image, progress)
    return image


def _is_labeled(label) -> bool:
    if label is None or label == "":
        return False
    try:
        return not np.isnan(float(label))
    except (TypeError, ValueError):
        return False


def label_dataset(
    root_dir: str,
    backend: LabelBackend,
    sort: str = "uuid",
    skip_labeled_files: bool = True,
    device: str | torch.device = "cuda",
) -> LabelDatabase:
    """One labelling session over the ``**/*.jpg`` images of ``root_dir``
    in the ``sort`` order (the diversity orders on ``device``); returns the
    saved database."""
    device = resolve_device(device)
    image_files = natural_sort(
        glob.glob(os.path.join(root_dir, "**/*.jpg"), recursive=True)
    )
    db = LabelDatabase.load_or_create(root_dir)
    if os.path.exists(db.path):
        db.create_backup()
    print(f"Found {db.n_labeled()} labeled images ({len(image_files)} total) in {db.path}")

    db.fix_database()
    image_files = re_order_images(image_files, db, root_dir, sort, device=device)
    if not image_files:
        print("No images to label.")
        return db

    current = 0
    new_labels = 0
    consecutive_skips = 0
    last_save_t = 0.0
    save_cost = 0.0
    thumbs = ThumbnailCache()
    while True:
        if consecutive_skips >= len(image_files):
            # every remaining image is labeled or unloadable — don't busy-spin
            print("No more images to label.")
            break
        image_file = image_files[current]
        uuid = os.path.splitext(os.path.basename(image_file))[0]
        label = db.get_label(uuid)
        if _is_labeled(label) and skip_labeled_files:
            current = (current + 1) % len(image_files)
            consecutive_skips += 1
            continue
        skip_labeled_files = False

        thumb, prompt = thumbs.get(uuid, root_dir)
        if thumb is None:
            current = (current + 1) % len(image_files)
            consecutive_skips += 1
            continue
        consecutive_skips = 0
        frame = _annotate(
            thumb.copy(),  # the overlay draws in place; keep the cache clean
            label if _is_labeled(label) else None,
            db.get_predicted_label(uuid),
            prompt,
            current / max(1, len(image_files)),
        )

        # optional backend hook: oracle and scripted backends learn WHICH
        # image the next show() call displays
        on_image = getattr(backend, "on_image", None)
        if on_image is not None:
            on_image(uuid)
        key = backend.show(frame, current / max(1, len(image_files)))
        if key in "0123456789" and len(key) == 1:
            db.relabel(uuid, int(key) / 10.0)
            current += 1
            new_labels += 1
            # autosave every 5 new labels (reference _3:329-331); once a
            # single save becomes humanly noticeable, at most one per 15 s
            if new_labels % 5 == 0 and (
                save_cost < 0.2 or time.monotonic() - last_save_t >= 15
            ):
                t0 = time.monotonic()
                db.save()
                last_save_t = time.monotonic()
                save_cost = last_save_t - t0
                print(f"{db.n_labeled()} of {len(db)} images in the database labeled")
        elif key == "quit":
            break
        elif key == "left":
            current -= 1
        elif key == "right":
            current += 1
        current %= len(image_files)

    backend.close()
    db.save()
    print(f"{db.n_labeled()} of {len(db)} images in the database labeled")
    return db


def print_shown(backend: HeadlessBackend, session: str = "session") -> None:
    """One line naming, in order, the uuids a headless session showed."""
    print(f"headless {session}: {len(backend.shown_uuids)} frames shown: "
          f"{','.join(backend.shown_uuids)}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--skip_labeled_files", action="store_true")
    parser.add_argument("--sort", type=str, default=None,
                        choices=list(SORT_OPTIONS) + [None],
                        help="acquisition ordering; prompts interactively if omitted")
    parser.add_argument("--backend", type=str, default="opencv",
                        choices=["opencv", "headless"])
    parser.add_argument("--keys", type=str, default="",
                        help="comma-separated scripted keys for --backend headless "
                        "(e.g. '3,7,left,9,q')")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for the diversity sorts: cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    sort = args.sort or prompt_sort_option()
    if args.backend == "headless":
        keys = [("quit" if k in ("q", "esc") else k) for k in args.keys.split(",") if k]
        backend: LabelBackend = HeadlessBackend(keys)
    else:
        backend = OpenCVBackend()
    label_dataset(args.root_dir, backend, sort=sort,
                  skip_labeled_files=args.skip_labeled_files, device=device)
    if isinstance(backend, HeadlessBackend):
        print_shown(backend)


if __name__ == "__main__":
    main()
