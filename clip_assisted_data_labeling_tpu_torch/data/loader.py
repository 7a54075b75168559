"""Host-side image pipeline: threaded decode → centered canvas → batches
(port of the JAX package's ``data/loader.py``; the native C++ decoder,
``data/native_loader.py``, is not ported yet).

  * Decode with cv2 if installed, else PIL, else — for ``.png`` files — the
    port's own reader (data/png.py); anything else raises and the file is
    skipped and reported. PNG is lossless, so all three give the same pixels.
  * Images larger than the canvas are pre-downscaled (cv2 INTER_AREA, else
    PIL's box filter, else a numpy box filter).
  * Batches have static shapes (canvas [B, c, c, 3] uint8); the final
    partial batch is zero-padded with ``n_valid`` marking real rows.
  * Canvas buckets: a batch of small images ships on a small canvas; files
    are sorted by size so batches are size-homogeneous.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS, IMG_EXTENSIONS
from clip_assisted_data_labeling_tpu_torch.data.imsize import image_size
from clip_assisted_data_labeling_tpu_torch.data.png import read_png
from clip_assisted_data_labeling_tpu_torch.ops.crops import make_crop_params
from clip_assisted_data_labeling_tpu_torch.ops.image_stats import make_stat_params

log = logging.getLogger(__name__)

try:  # optional decoders: a GPU host may have neither
    import cv2
except ImportError:
    cv2 = None
try:
    from PIL import Image
except ImportError:
    Image = None


def decoder_name() -> str:
    """Which decoder this process uses: 'cv2', 'PIL' or 'png' (.png only)."""
    return "cv2" if cv2 is not None else ("PIL" if Image is not None else "png")


def find_images(root_dir: str, recursive: bool = True) -> list[str]:
    """Image discovery (reference _1_embed_with_CLIP.py:53-58)."""
    paths = []
    if recursive:
        for root, _dirs, files in os.walk(root_dir):
            for name in files:
                if name.endswith(IMG_EXTENSIONS):
                    paths.append(os.path.join(root, name))
    else:
        for name in os.listdir(root_dir):
            if name.endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(root_dir, name))
    return paths


@dataclasses.dataclass
class Batch:
    canvas: np.ndarray  # [B, c, c, 3] uint8
    crop_params: np.ndarray  # [B, n_crops, 2, 4] float32
    stat_params: np.ndarray  # [B, 8] float32
    paths: list[str]  # length n_valid
    n_valid: int


def decode_rgb(path: str) -> np.ndarray:
    """Decode one image file → [H, W, 3] uint8 RGB; raises if unreadable."""
    if cv2 is not None:
        cv2.setNumThreads(1)  # the thread pool is the parallelism
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    if path.lower().endswith(".png"):
        return read_png(path)
    raise ValueError(f"cannot decode {path}: no cv2 or PIL, and not a PNG")


def _box_downscale(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Area-average shrink (box-overlap weights) for when neither cv2 nor
    PIL is installed."""
    def weights(n_in, n_out):
        ss = n_in / n_out
        u = np.arange(n_out, dtype=np.float64)[:, None]
        j = np.arange(n_in, dtype=np.float64)[None, :]
        w = np.clip(np.minimum((u + 1) * ss, j + 1) - np.maximum(u * ss, j), 0, None)
        return w / w.sum(1, keepdims=True)

    out = np.einsum("vy,yxc->vxc", weights(img.shape[0], new_h), img.astype(np.float64))
    out = np.einsum("ux,vxc->vuc", weights(img.shape[1], new_w), out)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def fit_to_canvas(img: np.ndarray, canvas_size: int):
    """(img, w, h): an [H, W, 3] uint8 image shrunk so that its longer edge
    fits ``canvas_size`` (cv2 INTER_AREA, else PIL's box filter, else
    ``_box_downscale``), or as it is where it fits already."""
    h, w = img.shape[:2]
    if max(h, w) > canvas_size:
        scale = canvas_size / max(h, w)
        new_w, new_h = max(1, int(w * scale)), max(1, int(h * scale))
        if cv2 is not None:
            img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA)
        elif Image is not None:
            img = np.asarray(Image.fromarray(img).resize((new_w, new_h), Image.BOX))
        else:
            img = _box_downscale(img, new_w, new_h)
        h, w = new_h, new_w
    return img, w, h


def _decode_one(path: str, canvas_size: int):
    try:
        img = decode_rgb(path)
    except Exception as e:  # a bad file is skipped and reported, not fatal
        log.warning("Could not decode %s: %s", path, e)
        return None
    return fit_to_canvas(img, canvas_size)


def _probe_size(path: str) -> int | None:
    """Longest edge from the file header (no pixel decode), or None."""
    try:
        return max(image_size(path))
    except Exception:  # unreadable: sorts last, skipped at decode
        return None


class BatchedImageLoader:
    """Iterates batches with background decode + prefetch."""

    def __init__(
        self,
        image_paths: list[str],
        canvas_size: int,
        out_size: int,
        batch_size: int,
        num_workers: int = 8,
        crop_names=ALL_CROPS,
        prefetch_batches: int = 4,
        bucketed: bool = False,
        sort_by_size: bool = False,
    ):
        self.image_paths = list(image_paths)
        self.canvas_size = canvas_size + (canvas_size % 2)
        self.out_size = out_size
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.crop_names = crop_names
        self.prefetch_batches = prefetch_batches
        # buckets are quarters of the max canvas, 64-aligned
        self.bucket_sizes = (
            sorted({max(64, (self.canvas_size * q // 4) // 64 * 64) for q in (1, 2, 3, 4)})
            if bucketed
            else [self.canvas_size]
        )
        self.skipped: list[str] = []
        if sort_by_size and len(self.image_paths) > 1:
            self.image_paths = self._sorted_by_size(self.image_paths)

    def __len__(self) -> int:
        return (len(self.image_paths) + self.batch_size - 1) // self.batch_size

    def _sorted_by_size(self, paths: list[str]) -> list[str]:
        """Order files by post-downscale canvas footprint so each batch lands
        in the smallest bucket that fits it."""
        c = self.canvas_size

        def key(p: str) -> int:
            s = _probe_size(p)
            return c + 1 if s is None else min(s, c)

        with ThreadPoolExecutor(self.num_workers) as pool:
            sizes = list(pool.map(key, paths))
        return [p for _s, p in sorted(zip(sizes, paths))]

    def _make_batch(self, chunk: list[str], pool: ThreadPoolExecutor) -> Batch:
        bs, c = self.batch_size, self.canvas_size
        decoded = []
        for path, dec in zip(chunk, pool.map(_decode_one, chunk, [c] * len(chunk))):
            if dec is None:
                log.warning("Skipping unreadable image %s", path)
                self.skipped.append(path)
                continue
            decoded.append((path, *dec))

        chunk_max = max((max(w, h) for _p, _i, w, h in decoded), default=0)
        cb = next((b for b in self.bucket_sizes if b >= chunk_max), c)

        canvas = np.zeros((bs, cb, cb, 3), np.uint8)
        # padding rows carry valid geometry (all-zero params would give 0/0)
        crop_params = np.broadcast_to(
            make_crop_params(cb, cb, cb, self.out_size, self.crop_names),
            (bs, len(self.crop_names), 2, 4),
        ).copy()
        stat_params = np.broadcast_to(make_stat_params(cb, cb, cb), (bs, 8)).copy()
        paths: list[str] = []
        for fill, (path, img, w, h) in enumerate(decoded):
            oy, ox = (cb - h) // 2, (cb - w) // 2
            canvas[fill, oy: oy + h, ox: ox + w] = img
            crop_params[fill] = make_crop_params(w, h, cb, self.out_size, self.crop_names)
            stat_params[fill] = make_stat_params(w, h, cb)
            paths.append(path)
        return Batch(canvas, crop_params, stat_params, paths, len(paths))

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        sentinel = object()
        stop = threading.Event()
        error: list[BaseException] = []

        def _put(item) -> bool:
            # bounded put that gives up once the consumer abandoned iteration
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for start in range(0, len(self.image_paths), self.batch_size):
                        if stop.is_set():
                            return
                        chunk = self.image_paths[start: start + self.batch_size]
                        batch = self._make_batch(chunk, pool)
                        if batch.n_valid and not _put(batch):
                            return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                error.append(e)
            finally:
                _put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise RuntimeError("image loader producer thread failed") from error[0]
                    break
                yield item
        finally:
            stop.set()
            while not q.empty():  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=30)
