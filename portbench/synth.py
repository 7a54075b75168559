"""Inputs made from ``--seed`` on the device, in a few large calls: the
synthetic image pool of the embed mixes and the embedding rows of the dedup
mixes. The same seed gives the same tensors, so a check after the window can
make them again instead of holding them."""
from __future__ import annotations

import hashlib
import math

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one stream, from the run's seed and the stream's tags
    (the run's seed may be larger than 32 bits)."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def image_group(seed: int, group: int, count: int, width: int, height: int,
                shapes: int, device) -> torch.Tensor:
    """``count`` synthetic [height, width, 3] uint8 images: a horizontal
    gradient between two colors, then ``shapes`` flat-colored rectangles and
    ellipses painted over it. Rows repeat between shape edges, so a PNG of one
    is a fraction of its raw size."""
    g = generator(seed, device, "images", group)
    ends = torch.randint(0, 256, (count, 2, 3), generator=g, device=device).float()
    ramp = torch.linspace(0.0, 1.0, width, device=device)[None, None, :, None]
    img = (ends[:, None, None, 0] + (ends[:, None, None, 1] - ends[:, None, None, 0]) * ramp)
    img = img.expand(count, height, width, 3).contiguous()
    yy = torch.arange(height, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, None, :]
    for _ in range(shapes):
        p = torch.rand((count, 5), generator=g, device=device)
        color = torch.randint(0, 256, (count, 3), generator=g, device=device).float()
        cx, cy = (p[:, 0] * width)[:, None, None], (p[:, 1] * height)[:, None, None]
        rx = (0.05 + 0.3 * p[:, 2] * width)[:, None, None]
        ry = (0.05 + 0.3 * p[:, 3] * height)[:, None, None]
        dx, dy = (xx - cx) / rx, (yy - cy) / ry
        ellipse = dx * dx + dy * dy <= 1.0
        rect = (dx.abs() <= 1.0) & (dy.abs() <= 1.0)
        mask = torch.where((p[:, 4] < 0.5)[:, None, None], ellipse, rect)
        img = torch.where(mask[..., None], color[:, None, None, :], img)
    return img.round_().clamp_(0, 255).to(torch.uint8)


def dedup_rows(seed: int, n: int, d: int, p: dict, device) -> torch.Tensor:
    """[n, d] float32 embeddings: a shared mean direction plus one of
    ``p['centres']`` cluster centres plus noise (weights of squared norm
    ``p['mean_share']``, ``p['centre_share']``, the rest noise), so pairwise
    cosines spread far below a dedup threshold without being orthogonal. Over
    them, each on rows of its own: ``p['pairs']`` near-duplicate pairs at
    cosines drawn uniformly from ``p['pair_cos']``; ``p['groups']`` groups of
    ``p['group_size']`` rows each at a cosine in ``p['group_cos']`` to the
    group's first row (one image saved at several sizes); and
    ``p['variants']`` groups of ``p['variant_size']`` rows, each later row at a
    cosine in ``p['variant_cos']`` to the group's first (renders of one
    prompt: the band just under the threshold that the scan's slack takes in
    and the host's recheck turns away). Every planted row has its own norm in
    [0.8, 1.2]; every seed plants the same counts."""
    g = generator(seed, device, "rows")

    def unit(t: torch.Tensor) -> torch.Tensor:
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)

    mean = unit(torch.randn(d, generator=g, device=device))
    centres = unit(torch.randn((p["centres"], d), generator=g, device=device))
    assign = torch.randint(0, p["centres"], (n,), generator=g, device=device)
    x = torch.randn((n, d), generator=g, device=device)
    x.mul_(math.sqrt((1.0 - p["mean_share"] - p["centre_share"]) / d))
    x.add_(centres[assign], alpha=math.sqrt(p["centre_share"]))
    x.add_(mean, alpha=math.sqrt(p["mean_share"]))
    del centres, assign

    n_pairs = p["pairs"]
    planted = [(p["groups"], p["group_size"], p["group_cos"]),
               (p["variants"], p["variant_size"], p["variant_cos"])]
    slots = torch.randperm(n, generator=g, device=device)[
        : 2 * n_pairs + sum(count * size for count, size, _c in planted)]

    def near(base_rows: torch.Tensor, lo_hi) -> torch.Tensor:
        """Rows at a cosine drawn from ``lo_hi`` to ``base_rows``."""
        b = unit(base_rows)
        u = torch.randn(b.shape, generator=g, device=device)
        u = unit(u - (u * b).sum(-1, keepdim=True) * b)
        lo, hi = lo_hi
        c = lo + (hi - lo) * torch.rand((len(b), 1), generator=g, device=device)
        norm = 0.8 + 0.4 * torch.rand((len(b), 1), generator=g, device=device)
        return (c * b + torch.sqrt(1.0 - c * c) * u) * norm

    first, second = slots[0: 2 * n_pairs: 2], slots[1: 2 * n_pairs: 2]
    x[second] = near(x[first], p["pair_cos"])
    at = 2 * n_pairs
    for count, size, cos in planted:
        groups = slots[at: at + count * size].reshape(count, size)
        at += count * size
        heads = x[groups[:, 0]].repeat_interleave(size - 1, dim=0)
        x[groups[:, 1:].reshape(-1)] = near(heads, cos)
    return x
