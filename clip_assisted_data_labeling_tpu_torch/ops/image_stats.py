"""The 22 handcrafted ``img_stat_*`` features as batched torch ops (port of the
JAX package's ``ops/image_stats.py``; plain tensor code there as here).

The reference computes these per image on the host with cv2: downscale to
~768² pixels, then channel means/stds, gray/HSV statistics, colorfulness,
histogram entropy and a tanh-squashed Laplacian variance. Here the whole batch
runs on the device over the same centered canvas the crop pipeline uses.

Reference quirks replicated (they are baked into every existing sidecar):
  * the downscale transposes the aspect ratio
    (``new_w = sqrt(max_n_pixels * H/W)``); width/height/aspect use it as is,
  * cv2's BGR2GRAY / BGR2HSV run on an RGB array, so gray and HSV see R and B
    swapped — the literal BGR formulas are applied to the RGB channel order,
  * colorfulness uses the literal channel indices the reference ends up using.

The dynamic (new_h, new_w) resample grid lives inside a fixed 1536×768
container (orientation-normalized so rows ≥ cols; every stat is transpose-
invariant) with masked reductions over the valid region, replicating both
cv2 INTER_AREA regimes: box-overlap averaging when both axes shrink, cv2's
2-tap zoom emulation otherwise. :func:`image_stats_reference` is the host
cv2 path (``--exact_stats``): the reference's own computation on one image.
"""
from __future__ import annotations

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.utils.timer import layer

STAT_SIZE = 768  # the reference targets 768*768 total pixels
GRID_ROWS, GRID_COLS = 1536, 768
_EPS = float(np.finfo(np.float64).eps)  # the reference uses np.finfo(float).eps

IMG_STAT_KEYS = (
    "img_stat_width",
    "img_stat_height",
    "img_stat_aspect_ratio",
    "img_stat_mean_color",
    "img_stat_std_color",
    "img_stat_mean_red",
    "img_stat_mean_green",
    "img_stat_mean_blue",
    "img_stat_std_red",
    "img_stat_std_green",
    "img_stat_std_blue",
    "img_stat_mean_gray",
    "img_stat_std_gray",
    "img_stat_mean_hue",
    "img_stat_mean_sat",
    "img_stat_mean_val",
    "img_stat_std_hue",
    "img_stat_std_sat",
    "img_stat_std_val",
    "img_stat_colorfulness",
    "img_stat_image_entropy",
    "img_stat_laplacian_variance",
)


def make_stat_params(width: int, height: int, canvas_size: int) -> np.ndarray:
    """Host-side scalars for one image: float32 [8] =
    (x_origin, y_origin, width, height, new_w, new_h, 0, 0), new_w/new_h by
    the reference's transposed-aspect downscale formula."""
    ox = (canvas_size - width) // 2
    oy = (canvas_size - height) // 2
    max_n = STAT_SIZE * STAT_SIZE
    new_w = int(np.sqrt(max_n * height / width))
    new_h = int(np.sqrt(max_n * width / height))
    return np.array([ox, oy, width, height, new_w, new_h, 0, 0], dtype=np.float32)


def _dyn_axis_weights(lo, extent, n_out, both_shrink, canvas_size: int,
                      container: int) -> torch.Tensor:
    """[B, container, canvas] resample weights for a per-image output length
    n_out (rows ≥ n_out are zero), replicating cv2.resize INTER_AREA. lo,
    extent, n_out: [B] float32; both_shrink: [B] bool."""
    dev = lo.device
    u = torch.arange(container, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(canvas_size, dtype=torch.float32, device=dev)[None, None, :]
    lo, extent, n_out = lo[:, None, None], extent[:, None, None], n_out[:, None, None]
    valid = u < n_out

    # shrink regime: box overlap over [lo + u·ss, lo + (u+1)·ss)
    ss = extent / n_out
    f_lo = lo + u * ss
    f_hi = lo + (u + 1.0) * ss
    w_area = torch.clamp(torch.minimum(f_hi, j + 1.0) - torch.maximum(f_lo, j), min=0.0)
    w_area = w_area / torch.clamp(w_area.sum(-1, keepdim=True), min=1e-12)

    # zoom regime: cv2's INTER_AREA general-path 2-tap coefficients
    inv = n_out / extent
    sx = torch.floor(u * ss)
    fx = (u + 1.0) - (sx + 1.0) * inv
    fx = torch.where(fx <= 0.0, torch.zeros_like(fx), fx - torch.floor(fx))
    zero = torch.zeros((), device=dev)
    sx0 = lo + torch.minimum(torch.maximum(sx, zero), extent - 1.0)
    sx1 = lo + torch.minimum(torch.maximum(sx + 1.0, zero), extent - 1.0)
    w_zoom = (1.0 - fx) * (j == sx0) + fx * (j == sx1)

    w = torch.where(both_shrink[:, None, None], w_area, w_zoom)
    return torch.where(valid, w, torch.zeros_like(w))


def _rgb_quirky_gray(img: torch.Tensor) -> torch.Tensor:
    """cv2 BGR2GRAY applied to an RGB array: channel 0 is taken as B."""
    r, g, b = img[..., 2], img[..., 1], img[..., 0]
    return torch.clamp(torch.round(0.299 * r + 0.587 * g + 0.114 * b), 0.0, 255.0)


def _rgb_quirky_hsv(img: torch.Tensor):
    """cv2 BGR2HSV (8-bit) applied to an RGB array."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]  # literal cv2 BGR roles
    v = torch.maximum(torch.maximum(b, g), r)
    m = torch.minimum(torch.minimum(b, g), r)
    d = v - m
    one = torch.ones_like(d)
    zero = torch.zeros_like(d)
    safe_d = torch.where(d == 0.0, one, d)
    h = torch.where(
        v == r,
        60.0 * (g - b) / safe_d,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe_d,
                    240.0 + 60.0 * (r - g) / safe_d),
    )
    h = torch.where(d == 0.0, zero, torch.where(h < 0.0, h + 360.0, h))
    h8 = torch.round(h / 2.0)
    safe_v = torch.where(v == 0.0, one, v)
    s8 = torch.where(v == 0.0, zero, torch.round(255.0 * d / safe_v))
    return h8, s8, v


def image_stats_batch(canvas_u8: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """[B, C, C, 3] uint8 canvases + [B, 8] params → [B, 22] float32 features
    (the profiler range ``stats``)."""
    with layer("stats"):
        return _stats_batch(canvas_u8, params)


def _stats_batch(canvas_u8: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    canvas = canvas_u8.to(torch.float32)
    params = params.to(device=canvas.device, dtype=torch.float32)
    bsz, csize = canvas.shape[0], canvas.shape[1]
    dev = canvas.device
    ox, oy, w, h, new_w, new_h = (params[:, i] for i in range(6))

    tall = new_h >= new_w
    rn = torch.clamp(torch.where(tall, new_h, new_w), max=float(GRID_ROWS))
    cn = torch.where(tall, new_w, new_h)
    row_lo = torch.where(tall, oy, ox)
    row_extent = torch.where(tall, h, w)
    col_lo = torch.where(tall, ox, oy)
    col_extent = torch.where(tall, w, h)
    both_shrink = (new_w <= w) & (new_h <= h)

    wr = _dyn_axis_weights(row_lo, row_extent, rn, both_shrink, csize, GRID_ROWS)
    wc = _dyn_axis_weights(col_lo, col_extent, cn, both_shrink, csize, GRID_COLS)
    # orientation-normalize so container axis 0 samples the longer output axis
    canvas_or = torch.where(tall[:, None, None, None], canvas, canvas.transpose(1, 2))
    img = torch.bmm(wr, canvas_or.reshape(bsz, csize, csize * 3))  # [B, R, C*3]
    img = img.reshape(bsz, GRID_ROWS, csize, 3).permute(0, 1, 3, 2)
    img = torch.bmm(img.reshape(bsz, GRID_ROWS * 3, csize), wc.transpose(1, 2))
    img = img.reshape(bsz, GRID_ROWS, 3, GRID_COLS).permute(0, 1, 3, 2)
    img = torch.clamp(torch.round(img), 0.0, 255.0)  # uint8 grid, as cv2 returns

    ri = torch.arange(GRID_ROWS, dtype=torch.float32, device=dev)
    ci = torch.arange(GRID_COLS, dtype=torch.float32, device=dev)
    mask = (ri[None, :, None] < rn[:, None, None]) & (ci[None, None, :] < cn[:, None, None])
    count = rn * cn

    def mmean(x):
        return torch.where(mask, x, torch.zeros_like(x)).sum((1, 2)) / count

    def mstd(x):
        mu = mmean(x)[:, None, None]
        return torch.sqrt(mmean((x - mu) ** 2))

    gray = _rgb_quirky_gray(img)
    hue, sat, val = _rgb_quirky_hsv(img)

    # colorfulness (with the reference's channel-role quirk)
    cb, cg, cr = img[..., 0], img[..., 1], img[..., 2]
    rg = torch.abs(cr - cg)
    yb = torch.abs(0.5 * (cr + cg) - cb)
    std_root = torch.sqrt(mstd(rg) ** 2 + mstd(yb) ** 2)
    mean_root = torch.sqrt(mmean(rg) ** 2 + mmean(yb) ** 2)
    colorfulness = (std_root + 0.3 * mean_root) / 100.0

    # histogram entropy over the valid gray uint8 grid
    hist = torch.zeros((bsz, 256), dtype=torch.float32, device=dev).scatter_add_(
        1, gray.to(torch.int64).reshape(bsz, -1), mask.reshape(bsz, -1).to(torch.float32)
    )
    p = hist / count[:, None]
    entropy = -torch.sum(p * torch.log2(p + _EPS), dim=1) / 8.0

    # Laplacian variance: 3x3 [[0,1,0],[1,-4,1],[0,1,0]], reflect-101 border at
    # the dynamic grid edge, population variance, tanh(var * 1e-4)
    rr = ri[None, :]
    cc = ci[None, :]
    up = torch.clamp(torch.where(rr == 0, torch.ones_like(rr), rr - 1), 0, GRID_ROWS - 1)
    down = torch.clamp(torch.where(rr == rn[:, None] - 1, rn[:, None] - 2, rr + 1),
                       0, GRID_ROWS - 1)
    left = torch.clamp(torch.where(cc == 0, torch.ones_like(cc), cc - 1), 0, GRID_COLS - 1)
    right = torch.clamp(torch.where(cc == cn[:, None] - 1, cn[:, None] - 2, cc + 1),
                        0, GRID_COLS - 1)

    def rows(idx):
        idx = idx.to(torch.int64).expand(bsz, GRID_ROWS)
        return gray.gather(1, idx[:, :, None].expand(bsz, GRID_ROWS, GRID_COLS))

    def cols(idx):
        idx = idx.to(torch.int64).expand(bsz, GRID_COLS)
        return gray.gather(2, idx[:, None, :].expand(bsz, GRID_ROWS, GRID_COLS))

    lap = rows(up) + rows(down) + cols(left) + cols(right) - 4.0 * gray
    lap_mu = mmean(lap)[:, None, None]
    lap_var = torch.tanh(mmean((lap - lap_mu) ** 2) * 1e-4)

    rgb_means = [mmean(img[..., k]) for k in range(3)]
    rgb_stds = [mstd(img[..., k]) for k in range(3)]
    all_mu = (rgb_means[0] + rgb_means[1] + rgb_means[2]) / 3.0
    # np.std over the full (H, W, 3) array: population std around the joint mean
    all_std = torch.sqrt(
        sum(mmean((img[..., k] - all_mu[:, None, None]) ** 2) for k in range(3)) / 3.0
    )

    return torch.stack(
        [
            new_w / 768.0,
            new_h / 768.0,
            new_w / new_h,
            all_mu / 255.0,
            all_std / 255.0,
            rgb_means[0] / 255.0,
            rgb_means[1] / 255.0,
            rgb_means[2] / 255.0,
            rgb_stds[0] / 255.0,
            rgb_stds[1] / 255.0,
            rgb_stds[2] / 255.0,
            mmean(gray) / 255.0,
            mstd(gray) / 255.0,
            mmean(hue) / 255.0,
            mmean(sat) / 255.0,
            mmean(val) / 255.0,
            mstd(hue) / 255.0,
            mstd(sat) / 255.0,
            mstd(val) / 255.0,
            colorfulness,
            entropy,
            lap_var,
        ],
        dim=1,
    )


def image_stats_reference(rgb_image: np.ndarray, max_n_pixels: int = 768 * 768) -> dict:
    """Host replica of the reference's cv2 stats (utils/image_features.py:
    51-94) on one [H, W, 3] uint8 RGB image, every quirk included (JAX
    ``image_stats_reference``, ops/image_stats.py:280). Imports cv2 here, at
    the first call."""
    import cv2

    h_dim, w_dim = rgb_image.shape[:2]
    new_w = int(np.sqrt(max_n_pixels * h_dim / w_dim))
    new_h = int(np.sqrt(max_n_pixels * w_dim / h_dim))
    img = cv2.resize(rgb_image, (new_w, new_h), interpolation=cv2.INTER_AREA)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)

    bf, gf, rf = cv2.split(img.astype("float"))
    rg = np.abs(rf - gf)
    yb = np.abs(0.5 * (rf + gf) - bf)
    colorfulness = (np.sqrt(rg.std() ** 2 + yb.std() ** 2)
                    + 0.3 * np.sqrt(rg.mean() ** 2 + yb.mean() ** 2)) / 100.0

    hist = cv2.calcHist([gray], [0], None, [256], [0, 256]).astype(np.float64)
    hist /= hist.sum()
    entropy = float(-np.sum(hist * np.log2(hist + _EPS)) / 8.0)

    lap = cv2.Laplacian(gray, cv2.CV_64F)
    lap_var = float(np.tanh(np.var(lap) * 1e-4))

    vals = [
        img.shape[1] / 768,
        img.shape[0] / 768,
        img.shape[1] / img.shape[0],
        np.mean(img) / 255,
        np.std(img) / 255,
        np.mean(img[:, :, 0]) / 255,
        np.mean(img[:, :, 1]) / 255,
        np.mean(img[:, :, 2]) / 255,
        np.std(img[:, :, 0]) / 255,
        np.std(img[:, :, 1]) / 255,
        np.std(img[:, :, 2]) / 255,
        np.mean(gray) / 255,
        np.std(gray) / 255,
        np.mean(hsv[:, :, 0]) / 255,
        np.mean(hsv[:, :, 1]) / 255,
        np.mean(hsv[:, :, 2]) / 255,
        np.std(hsv[:, :, 0]) / 255,
        np.std(hsv[:, :, 1]) / 255,
        np.std(hsv[:, :, 2]) / 255,
        colorfulness,
        entropy,
        lap_var,
    ]
    return dict(zip(IMG_STAT_KEYS, [float(v) for v in vals]))
