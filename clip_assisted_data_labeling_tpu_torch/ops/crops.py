"""Fused 4-crop extraction + resize + CLIP normalization (port of the JAX
package's ``ops/crops.py``; plain tensor code there as here).

Separable resampling is a pair of matmuls. For each crop a row-weight matrix
``Wy[R, C]`` and a column-weight matrix ``Wx[R, C]`` over the fixed-size input
canvas encode the crop window, the PIL-bicubic kernel, antialias scaling and
edge clipping at once::

    out = Wy @ (clip8(img @ Wx^T))

Semantics replicated from the reference (utils/embedder.py:164-251):
  * crop geometry: centre / black-padded square / two area-fraction subcrops,
    with int-floor subcrop sizing and boundary clamping,
  * torchvision Resize(int) (shorter edge → R, longer edge int-truncated) and
    CenterCrop (round-half-even offsets),
  * PIL bicubic: Catmull-Rom (a=-0.5), support 2, antialias kernel stretch,
    per-output-pixel weight normalization over the clipped window, horizontal
    then vertical pass with uint8 rounding between passes (parity mode:
    float32, ``floor(x + 0.5)``),
  * square_padded_crop samples real black canvas pixels, as PIL's paste does.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.config import (
    ALL_CROPS,
    CLIP_MEAN,
    CLIP_STD,
    CROP_CENTRE,
    CROP_SQUARE_PADDED,
    CROP_SUB1,
    CROP_SUB2,
    SUBCROP_AREA_FRACTIONS,
)

# Per-axis resample parameters packed as float32: (offset, scale, lo, hi).
# center_of(output u) = offset + u * scale, valid source window = [lo, hi).
N_AXIS_PARAMS = 4


def _round_half_even(x: float) -> int:
    # Python round() semantics (torchvision CenterCrop offsets).
    return int(round(x))


def crop_boxes(width: int, height: int) -> dict[str, tuple[float, float, float, float]]:
    """Crop windows in image coordinates as (left, top, right, bottom). The
    square_padded_crop window extends beyond the image (those pixels are black)."""
    boxes: dict[str, tuple[float, float, float, float]] = {}

    m = min(width, height)
    left = _round_half_even((width - m) / 2.0)
    top = _round_half_even((height - m) / 2.0)
    boxes[CROP_CENTRE] = (left, top, left + m, top + m)

    s = max(width, height)
    start_w = (s - width) // 2
    start_h = (s - height) // 2
    boxes[CROP_SQUARE_PADDED] = (-start_w, -start_h, s - start_w, s - start_h)

    sizes = [int(math.sqrt(width * height * f)) for f in SUBCROP_AREA_FRACTIONS]
    if width >= height:  # wide / square image
        centers = [(width // 4, height // 2), (width // 4 * 3, height // 2)]
    else:  # tall image
        centers = [(width // 2, height // 4), (width // 2, height // 4 * 3)]
    for name, size, (cx, cy) in zip((CROP_SUB1, CROP_SUB2), sizes, centers):
        l = max(0, cx - size // 2)
        t = max(0, cy - size // 2)
        r = min(width, l + size)
        b = min(height, t + size)
        # tiny images can yield 0-area subcrops; clamp to ≥1 px so every image
        # embeds uniformly
        if r <= l:
            l = min(l, width - 1)
            r = l + 1
        if b <= t:
            t = min(t, height - 1)
            b = t + 1
        boxes[name] = (l, t, r, b)
    return boxes


def _resize_axis_params(crop_w: float, crop_h: float, out_size: int):
    """Per-axis (new_size, center_crop_offset, scale) for Resize(short→R)+CenterCrop(R)."""
    if crop_w <= crop_h:  # width is the shorter edge
        new_w = out_size
        new_h = int(out_size * crop_h / crop_w)
    else:
        new_h = out_size
        new_w = int(out_size * crop_w / crop_h)
    cc_x = _round_half_even((new_w - out_size) / 2.0)
    cc_y = _round_half_even((new_h - out_size) / 2.0)
    return (new_w, cc_x, crop_w / new_w), (new_h, cc_y, crop_h / new_h)


def make_crop_params(
    width: int,
    height: int,
    canvas_size: int,
    out_size: int,
    crop_names: Sequence[str] = ALL_CROPS,
) -> np.ndarray:
    """Host-side geometry for one image: float32 [n_crops, 2(axis: x,y), 4].
    The image sits centered on a ``canvas_size``² zero canvas."""
    if max(width, height) > canvas_size:
        raise ValueError(
            f"image {width}x{height} exceeds canvas {canvas_size}; "
            "the loader must pre-downscale"
        )
    ox = (canvas_size - width) // 2
    oy = (canvas_size - height) // 2
    boxes = crop_boxes(width, height)
    params = np.zeros((len(crop_names), 2, N_AXIS_PARAMS), dtype=np.float32)
    for i, name in enumerate(crop_names):
        l, t, r, b = boxes[name]
        lo_x, hi_x = l + ox, r + ox
        lo_y, hi_y = t + oy, b + oy
        (_, cc_x, ss_x), (_, cc_y, ss_y) = _resize_axis_params(r - l, b - t, out_size)
        off_x = lo_x + (cc_x + 0.5) * ss_x
        off_y = lo_y + (cc_y + 0.5) * ss_y
        params[i, 0] = (off_x, ss_x, lo_x, hi_x)
        params[i, 1] = (off_y, ss_y, lo_y, hi_y)
    return params


def _cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """PIL BICUBIC kernel: Catmull-Rom cubic, a = -0.5, support 2."""
    ax = torch.abs(x)
    inner = (1.5 * ax - 2.5) * ax * ax + 1.0
    outer = ((-0.5 * ax + 2.5) * ax - 4.0) * ax + 2.0
    zero = torch.zeros_like(ax)
    return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, zero))


def _axis_weights(axis_params: torch.Tensor, canvas_size: int, out_size: int) -> torch.Tensor:
    """[..., out_size, canvas_size] resample weights for one axis from
    [..., 4] = (offset, scale, lo, hi)."""
    off, ss, lo, hi = (axis_params[..., k, None, None] for k in range(4))
    dev = axis_params.device
    fs = torch.clamp(ss, min=1.0)  # antialias kernel stretch when downscaling
    u = torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(canvas_size, dtype=torch.float32, device=dev)[None, :]
    center = off + u * ss
    w = _cubic_kernel((j + 0.5 - center) / fs)
    w = torch.where((j >= lo) & (j < hi), w, torch.zeros_like(w))
    return w / w.sum(-1, keepdim=True)


def _clip8(x: torch.Tensor) -> torch.Tensor:
    # PIL rounds each resample pass back to the uint8 grid (round half away
    # from zero on non-negative values == floor(x + 0.5); not torch.round,
    # which rounds half to even)
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def fused_crop_resize_normalize(
    canvas_u8: torch.Tensor,  # [B, C, C, 3] uint8, image centered, zeros elsewhere
    params: torch.Tensor,  # [B, n_crops, 2, 4] float32
    out_size: int,
    parity: bool = True,
    dtype: torch.dtype = torch.float32,
    mean: tuple = CLIP_MEAN,
    std: tuple = CLIP_STD,
) -> torch.Tensor:
    """All crops of all images → normalized [B, n_crops, R, R, 3] in ``dtype``.

    Parity mode resamples in float32 with uint8 rounding between the passes;
    fast mode uses bfloat16 weights and canvas with float32 accumulation."""
    work = torch.float32 if parity else torch.bfloat16
    img = canvas_u8.to(work).permute(0, 3, 1, 2)  # [B, 3, Cy, Cx]
    params = params.to(device=canvas_u8.device, dtype=torch.float32)
    csize = canvas_u8.shape[1]
    wx = _axis_weights(params[:, :, 0], csize, out_size).to(work)  # [B, n, R, Cx]
    wy = _axis_weights(params[:, :, 1], csize, out_size).to(work)  # [B, n, R, Cy]
    crops = []
    for ci in range(params.shape[1]):
        # horizontal pass first (PIL order), then vertical
        t = img @ wx[:, ci, None].transpose(-1, -2)  # [B, 3, Cy, R]
        if parity:
            t = _clip8(t)
        out = wy[:, ci, None] @ t  # [B, 3, R, R]
        if parity:
            out = _clip8(out)
        crops.append(out)
    out = torch.stack(crops, 1).permute(0, 1, 3, 4, 2)  # [B, n, R, R, 3], 0..255
    mean_t = torch.tensor(mean, dtype=torch.float32, device=out.device) * 255.0
    std_t = torch.tensor(std, dtype=torch.float32, device=out.device) * 255.0
    return ((out - mean_t) / std_t).to(dtype)
