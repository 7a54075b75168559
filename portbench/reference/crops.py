"""The four crops of stage 1, plainly: each image on its own (no canvas), its
crop windows, torchvision's Resize(short side) + CenterCrop, PIL's bicubic
with antialias (a horizontal then a vertical pass, each rounded to the uint8
grid) and the tower's normalization. The geometry is a frozen copy of the
reference embedder's as the port states it (``ops/crops.py``); the image sits
centered on a zero square, so the padded crop reads black pixels."""
from __future__ import annotations

import math

import torch

from portbench.reference.stats import area_axis

CROPS = ("centre_crop", "square_padded_crop", "subcrop1_0.15", "subcrop2_0.1")
SUBCROP_AREAS = (0.15, 0.1)


def crop_boxes(width: int, height: int) -> list[tuple[int, int, int, int]]:
    """(left, top, right, bottom) of each crop in ``CROPS`` order, in image
    coordinates."""
    m = min(width, height)
    left, top = int(round((width - m) / 2.0)), int(round((height - m) / 2.0))
    boxes = [(left, top, left + m, top + m)]
    s = max(width, height)
    sw, sh = (s - width) // 2, (s - height) // 2
    boxes.append((-sw, -sh, s - sw, s - sh))
    sizes = [int(math.sqrt(width * height * f)) for f in SUBCROP_AREAS]
    if width >= height:
        centers = [(width // 4, height // 2), (width // 4 * 3, height // 2)]
    else:
        centers = [(width // 2, height // 4), (width // 2, height // 4 * 3)]
    for size, (cx, cy) in zip(sizes, centers):
        l, t = max(0, cx - size // 2), max(0, cy - size // 2)
        r, b = min(width, l + size), min(height, t + size)
        if r <= l:
            l = min(l, width - 1)
            r = l + 1
        if b <= t:
            t = min(t, height - 1)
            b = t + 1
        boxes.append((l, t, r, b))
    return boxes


def shrink_to_canvas(img: torch.Tensor, canvas: int) -> torch.Tensor:
    """The loader's pre-downscale: an [H, W, 3] uint8 image whose longer edge
    exceeds ``canvas`` shrunk to fit it (each edge ``int(edge · canvas /
    longer)``) by box-overlap averaging (cv2's INTER_AREA) in float64, rounded
    to uint8; any other image as it is."""
    h, w = img.shape[:2]
    if max(h, w) <= canvas:
        return img
    scale = canvas / max(h, w)
    new_w, new_h = max(1, int(w * scale)), max(1, int(h * scale))
    wy = area_axis(h, new_h, True, torch.float64, img.device)
    wx = area_axis(w, new_w, True, torch.float64, img.device)
    out = wy @ img.to(torch.float64).permute(2, 0, 1) @ wx.t()
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).permute(1, 2, 0)


def _cubic(x: torch.Tensor) -> torch.Tensor:
    """PIL's bicubic kernel (a = -0.5, support 2)."""
    ax = x.abs()
    inner = (1.5 * ax - 2.5) * ax * ax + 1.0
    outer = ((-0.5 * ax + 2.5) * ax - 4.0) * ax + 2.0
    return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, torch.zeros_like(ax)))


def _weights(lo: int, hi: int, new: int, offset: int, out_size: int, n_in: int,
             dtype, device) -> torch.Tensor:
    """[out_size, n_in] weights of one axis: the window [lo, hi) resized to
    ``new`` (torchvision's Resize of the shorter side, the longer truncated),
    then centre-cropped from ``offset``, sampled by the antialiased bicubic
    kernel, each row normalized over the window."""
    scale = (hi - lo) / new
    support = max(scale, 1.0)
    u = torch.arange(out_size, dtype=torch.float64, device=device)[:, None]
    j = torch.arange(n_in, dtype=torch.float64, device=device)[None, :]
    centre = lo + (offset + 0.5) * scale + u * scale
    w = _cubic((j + 0.5 - centre) / support)
    w = torch.where((j >= lo) & (j < hi), w, torch.zeros_like(w))
    return (w / w.sum(-1, keepdim=True)).to(dtype)


def _round8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def image_crops(img: torch.Tensor, out_size: int, mean, std,
                control: bool = False) -> torch.Tensor:
    """[H, W, 3] uint8 → [4, R, R, 3] normalized crops in float32 (bfloat16
    for the control)."""
    dtype = torch.bfloat16 if control else torch.float32
    h, w = img.shape[:2]
    s = max(w, h)
    sw, sh = (s - w) // 2, (s - h) // 2
    square = torch.zeros((3, s, s), dtype=dtype, device=img.device)
    square[:, sh:sh + h, sw:sw + w] = img.permute(2, 0, 1).to(dtype)
    out = []
    for l, t, r, b in crop_boxes(w, h):
        cw, ch = r - l, b - t
        if cw <= ch:
            new_w, new_h = out_size, int(out_size * ch / cw)
        else:
            new_w, new_h = int(out_size * cw / ch), out_size
        off_x, off_y = int(round((new_w - out_size) / 2.0)), int(round((new_h - out_size) / 2.0))
        wx = _weights(l + sw, r + sw, new_w, off_x, out_size, s, dtype, img.device)
        wy = _weights(t + sh, b + sh, new_h, off_y, out_size, s, dtype, img.device)
        rows = _round8(square @ wx.t())  # [3, s, R]: the horizontal pass
        out.append(_round8(wy @ rows))  # [3, R, R]
    crops = torch.stack(out).permute(0, 2, 3, 1).float()
    m = torch.tensor(mean, dtype=torch.float32, device=img.device) * 255.0
    sd = torch.tensor(std, dtype=torch.float32, device=img.device) * 255.0
    return ((crops - m) / sd).to(dtype)
