"""The 22 image stats of stage 1, plainly, on one image in float64: the
reference embedder's cv2 computation (``utils/image_features.py``) written
out with its quirks, as the port states them (``ops/image_stats.py``): the
resize to about 768² pixels with the aspect transposed, by cv2's INTER_AREA
(box averaging where both axes shrink, its two-tap weights otherwise);
BGR2GRAY and BGR2HSV applied to an RGB array; colorfulness on the literal
channel indices; the grey histogram's entropy; the variance of the 3×3
Laplacian with a reflect-101 border, squashed by tanh(v·1e-4).
``control=True`` computes it in bfloat16."""
from __future__ import annotations

import math

import torch

STAT_SIZE = 768
EPS = 2.220446049250313e-16  # numpy's float eps, as the reference uses


def area_axis(n_in: int, n_out: int, shrink: bool, dtype, device) -> torch.Tensor:
    """[n_out, n_in] INTER_AREA weights of one axis."""
    u = torch.arange(n_out, dtype=torch.float64, device=device)[:, None]
    j = torch.arange(n_in, dtype=torch.float64, device=device)[None, :]
    ss = n_in / n_out
    if shrink:
        w = torch.clamp(torch.minimum((u + 1.0) * ss, j + 1.0) - torch.maximum(u * ss, j), min=0.0)
        return (w / w.sum(-1, keepdim=True)).to(dtype)
    sx = torch.floor(u * ss)
    fx = (u + 1.0) - (sx + 1.0) * (n_out / n_in)
    fx = torch.where(fx <= 0.0, torch.zeros_like(fx), fx - torch.floor(fx))
    x0 = torch.clamp(sx, 0.0, n_in - 1.0)
    x1 = torch.clamp(sx + 1.0, 0.0, n_in - 1.0)
    return ((1.0 - fx) * (j == x0) + fx * (j == x1)).to(dtype)


def image_stats(img: torch.Tensor, control: bool = False) -> torch.Tensor:
    """[H, W, 3] uint8 RGB → [22] float64 stats in the port's key order."""
    dt = torch.bfloat16 if control else torch.float64
    h, w = img.shape[:2]
    new_w = int(math.sqrt(STAT_SIZE * STAT_SIZE * h / w))
    new_h = int(math.sqrt(STAT_SIZE * STAT_SIZE * w / h))
    shrink = new_w <= w and new_h <= h
    wy = area_axis(h, new_h, shrink, dt, img.device)
    wx = area_axis(w, new_w, shrink, dt, img.device)
    x = img.to(dt).permute(2, 0, 1)  # [3, H, W]
    x = torch.clamp(torch.round(wy @ x @ wx.t()), 0.0, 255.0).permute(1, 2, 0)  # [h', w', 3]
    c0, c1, c2 = x[..., 0], x[..., 1], x[..., 2]  # cv2 reads them as B, G, R

    gray = torch.clamp(torch.round(0.299 * c2 + 0.587 * c1 + 0.114 * c0), 0.0, 255.0)
    v = torch.maximum(torch.maximum(c0, c1), c2)
    d = v - torch.minimum(torch.minimum(c0, c1), c2)
    safe = torch.where(d == 0, torch.ones_like(d), d)
    hue = torch.where(v == c2, 60.0 * (c1 - c0) / safe,
                      torch.where(v == c1, 120.0 + 60.0 * (c0 - c2) / safe,
                                  240.0 + 60.0 * (c2 - c1) / safe))
    hue = torch.where(d == 0, torch.zeros_like(hue), torch.where(hue < 0, hue + 360.0, hue))
    hue = torch.round(hue / 2.0)
    sat = torch.where(v == 0, torch.zeros_like(v),
                      torch.round(255.0 * d / torch.where(v == 0, torch.ones_like(v), v)))

    def std(t):
        return torch.sqrt(((t - t.mean()) ** 2).mean())

    rg = (c2 - c1).abs()
    yb = (0.5 * (c2 + c1) - c0).abs()
    colorfulness = (torch.sqrt(std(rg) ** 2 + std(yb) ** 2)
                    + 0.3 * torch.sqrt(rg.mean() ** 2 + yb.mean() ** 2)) / 100.0
    hist = torch.bincount(gray.to(torch.int64).reshape(-1), minlength=256).to(dt)
    p = hist / hist.sum()
    entropy = -(p * torch.log2(p + EPS)).sum() / 8.0
    padded = torch.nn.functional.pad(gray[None, None].float(), (1, 1, 1, 1), mode="reflect")[0, 0].to(dt)
    lap = (padded[:-2, 1:-1] + padded[2:, 1:-1] + padded[1:-1, :-2] + padded[1:-1, 2:]
           - 4.0 * padded[1:-1, 1:-1])
    lap_var = torch.tanh(((lap - lap.mean()) ** 2).mean() * 1e-4)

    vals = [
        torch.tensor(new_w / 768.0), torch.tensor(new_h / 768.0), torch.tensor(new_w / new_h),
        x.mean() / 255.0, std(x) / 255.0,
        c0.mean() / 255.0, c1.mean() / 255.0, c2.mean() / 255.0,
        std(c0) / 255.0, std(c1) / 255.0, std(c2) / 255.0,
        gray.mean() / 255.0, std(gray) / 255.0,
        hue.mean() / 255.0, sat.mean() / 255.0, v.mean() / 255.0,
        std(hue) / 255.0, std(sat) / 255.0, std(v) / 255.0,
        colorfulness, entropy, lap_var,
    ]
    return torch.stack([t.to(torch.float64).to(img.device) for t in vals])
