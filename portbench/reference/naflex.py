"""SigLIP 2's NaFlex forward plainly (Tschannen et al. 2025, arXiv:2502.14786;
HF transformers' ``Siglip2ImageProcessor`` and ``Siglip2VisionModel``), in
float32 with TF32 off (the caller's ``reference.tf32(False)``), one image at
a time at its own length, so no padding and no mask:

  * the grid: HF's ``get_image_size_for_max_num_patches`` binary search over
    a scale (each side scaled, rounded up to a whole patch, one patch at
    least) for the largest aspect-preserving grid of at most ``max_patches``
    patches;
  * the resize: PIL's BILINEAR on uint8 (HF's processor resizes a PIL image
    with ``resample=BILINEAR``), written out from PIL's published filter
    (``libImaging/Resample.c``): a triangle widened by the downscale ratio,
    each tap's weight normalized in float64 and held in 22-bit fixed point,
    the horizontal pass first into uint8, then the vertical; an axis whose
    size does not change is not resampled;
  * ``(x / 255 − mean) / std``, then row-major patches of (row, column,
    channel), as HF's ``convert_image_to_patches``;
  * the learned 16 × 16 position table resized to the image's grid by
    ``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``,
    as ``Siglip2VisionEmbeddings.resize_positional_embeddings``;
  * the blocks and the MAP head of ``reference/vit`` over the image's real
    tokens alone.

Departures from HF: the weights are the benchmark's random ones in the
port's layout (the patch embedding a product over flattened patches, as
``reference/vit``); the image is the loader's canvas copy after its
pre-downscale (``reference/crops.shrink_to_canvas``), not the file.
``control=True`` computes in bfloat16 with every block's four linear
layers on int8 (weights per output channel, inputs per token): one step
below the configuration's bfloat16 (``reference/vit``'s own control runs
int4, a step further, for the int8_static cells). The four square crops go
through ``reference/vit.encode`` (:func:`encode`; the control through this
module's blocks, on int8).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from portbench.reference import vit

PIL_BITS = 22  # PIL's fixed-point precision for 8-bit images (32 - 8 - 2)


def target_grid(height: int, width: int, patch: int, max_patches: int) -> tuple[int, int]:
    """(grid_h, grid_w): the largest scale whose sides, rounded up to whole
    patches, hold at most ``max_patches`` patches (a bisection to 1e-5)."""
    def side(scale: float, size: int) -> int:
        return max(1, math.ceil(size * scale / patch))

    lo, hi = 1e-6, 100.0
    while hi - lo >= 1e-5:
        mid = (lo + hi) / 2
        if side(mid, height) * side(mid, width) <= max_patches:
            lo = mid
        else:
            hi = mid
    return side(lo, height), side(lo, width)


@functools.lru_cache(maxsize=64)
def _pil_axis_cpu(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] PIL BILINEAR fixed-point weights (float64 holding
    integers): output x's centre (x + 0.5)·scale, taps from int(centre −
    support + 0.5) to int(centre + support + 0.5), weight 1 − |(tap − centre
    + 0.5) / filterscale|, normalized, times 2^22 rounded half up."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    out = torch.zeros((n_out, n_in), dtype=torch.float64)
    for x in range(n_out):
        centre = (x + 0.5) * scale
        lo, hi = max(int(centre - support + 0.5), 0), min(int(centre + support + 0.5), n_in)
        taps = torch.arange(lo, hi, dtype=torch.float64)
        w = (1.0 - ((taps - centre + 0.5) / support).abs()).clamp(min=0.0)
        if w.sum() != 0:
            w = w / w.sum()
        out[x, lo:hi] = torch.floor(0.5 + w * (1 << PIL_BITS))
    return out


def _pil_axis(n_in: int, n_out: int, device) -> torch.Tensor:
    return _pil_axis_cpu(n_in, n_out).to(device)


def _pil_pass(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """weights [n_out, n_in] over the leading axis of x [n_in, ...] (uint8
    values in float64): integer sums plus half a unit, shifted down, clipped."""
    acc = torch.tensordot(weights, x, dims=([1], [0]))
    return torch.floor((acc + (1 << (PIL_BITS - 1))) / (1 << PIL_BITS)).clamp(0, 255)


def pil_bilinear(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[H, W, 3] uint8 → [height, width, 3] uint8 as PIL's BILINEAR resize."""
    x = img.to(torch.float64)
    if width != img.shape[1]:
        x = _pil_pass(x.transpose(0, 1), _pil_axis(img.shape[1], width, img.device))
        x = x.transpose(0, 1)
    if height != img.shape[0]:
        x = _pil_pass(x, _pil_axis(img.shape[0], height, img.device))
    return x.to(torch.uint8)


def patches_of(img: torch.Tensor, cfg: dict, max_patches: int, control: bool = False):
    """[H, W, 3] uint8 → (patches [n, p²·3] normalized, (grid_h, grid_w)),
    float32 (bfloat16 for the control)."""
    p = cfg["patch_size"]
    gh, gw = target_grid(img.shape[0], img.shape[1], p, max_patches)
    x = pil_bilinear(img, gw * p, gh * p).to(torch.float64) / 255.0
    mean = torch.tensor(cfg["norm_mean"], dtype=torch.float64, device=img.device)
    std = torch.tensor(cfg["norm_std"], dtype=torch.float64, device=img.device)
    x = ((x - mean) / std).to(torch.bfloat16 if control else torch.float32)
    x = x.reshape(gh, p, gw, p, 3).permute(0, 2, 1, 3, 4).reshape(gh * gw, p * p * 3)
    return x, (gh, gw)


def position_table(pos_emb: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """The [side², w] table resized to ``grid`` → [gh·gw, w], in float32."""
    side = math.isqrt(pos_emb.shape[0])
    table = pos_emb.float().reshape(side, side, -1).permute(2, 0, 1)[None]
    out = F.interpolate(table, size=grid, mode="bilinear", align_corners=False, antialias=True)
    return out[0].reshape(pos_emb.shape[1], -1).t()


def _int8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Symmetric int8 rounding (levels -127..127), one scale along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.clamp(torch.round(t / scale), -127, 127) * scale


def _linear(x, kernel, bias, control: bool):
    if control:
        return _int8(x, -1) @ _int8(kernel, 0) + bias
    return x @ kernel + bias


def _tower(P: dict, cfg: dict, x: torch.Tensor, control: bool) -> torch.Tensor:
    """The blocks and the MAP head over tokens [B, n, w] (every one real) →
    [B, w] float32 unit embeddings."""
    w, heads, eps = cfg["width"], cfg["heads"], cfg["ln_eps"]
    b = x.shape[0]
    for i in range(cfg["layers"]):
        def leaf(name):
            return P["blocks/" + name][i]
        h = vit._ln(x, leaf("ln1_scale"), leaf("ln1_bias"), eps)
        q, k, v = _linear(h, leaf("qkv_kernel"), leaf("qkv_bias"), control).split(w, dim=-1)
        x = x + _linear(vit._attention(q, k, v, heads), leaf("out_kernel"), leaf("out_bias"),
                        control)
        h = vit._ln(x, leaf("ln2_scale"), leaf("ln2_bias"), eps)
        h = vit._act(_linear(h, leaf("fc1_kernel"), leaf("fc1_bias"), control), cfg["act"])
        x = x + _linear(h, leaf("fc2_kernel"), leaf("fc2_bias"), control)
    x = vit._ln(x, P["ln_post_scale"], P["ln_post_bias"], eps)
    wq, wk, wv = P["pool_in_kernel"].split(w, dim=1)
    bq, bk, bv = P["pool_in_bias"].split(w)
    probe = (P["pool_probe"] @ wq + bq).expand(b, 1, w)
    h = vit._attention(probe, x @ wk + bk, x @ wv + bv, cfg["pool_heads"])[:, 0]
    h = h @ P["pool_out_kernel"] + P["pool_out_bias"]
    y = vit._ln(h, P["pool_ln_scale"], P["pool_ln_bias"], eps)
    y = vit._act(y @ P["pool_fc1_kernel"] + P["pool_fc1_bias"], cfg["act"])
    emb = (h + (y @ P["pool_fc2_kernel"] + P["pool_fc2_bias"])).float()
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def _weights(params: dict, control: bool) -> dict:
    dt = torch.bfloat16 if control else torch.float32
    return {k: v.to(dt) for k, v in params.items()}


def encode(params: dict, cfg: dict, crops: torch.Tensor, control: bool = False) -> torch.Tensor:
    """The square crops [B, R, R, 3] (each fills the 16 × 16 grid) → [B, w]:
    ``reference/vit.encode``; the control on this module's int8 blocks."""
    if not control:
        return vit.encode(params, cfg, crops)
    P, p = _weights(params, control), cfg["patch_size"]
    b, g = crops.shape[0], crops.shape[1] // p
    x = crops[:, : g * p, : g * p].to(torch.bfloat16).reshape(b, g, p, g, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3) @ P["patch_kernel"]
    return _tower(P, cfg, x + P["patch_bias"] + P["pos_emb"], control)


def encode_native(params: dict, cfg: dict, img: torch.Tensor, max_patches: int,
                  control: bool = False) -> torch.Tensor:
    """One [H, W, 3] uint8 image → its [width] float32 unit embedding on its
    own grid of at most ``max_patches`` patches."""
    P = _weights(params, control)
    patches, grid = patches_of(img, cfg, max_patches, control)
    x = patches @ P["patch_kernel"] + P["patch_bias"]
    x = x + position_table(params["pos_emb"], grid).to(x.dtype)
    return _tower(P, cfg, x[None], control)[0]
