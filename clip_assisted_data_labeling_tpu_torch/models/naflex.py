"""SigLIP2 naflex (native-aspect, variable-resolution) towers in PyTorch
(port of the JAX package's ``models/naflex.py``).

HF semantics (transformers Siglip2VisionModel): pre-patchified pixel values
``[B, N_max, p²·3]``, a per-patch attention mask and per-image spatial
shapes; the learned 16×16 positional grid is bilinearly resized
(antialiased) to each image's (gh, gw) patch grid; the encoder and the MAP
head attend only over real patches.

  * each image's positional interpolation is a ``[N_max, 256]`` resize-weight
    matrix (geometry only, made on the host and cached per (gh, gw);
    ``pos_weights_on`` assembles a batch's on the device), applied as one
    batched product against the 256-row table,
  * each block is the bfloat16 (or float32) block route that
    ``models/vit.vit_encode_image`` runs (``_block_generic``: ln, the qkv
    product, ``ops/attention.packed_attention_auto``, out, fc1 with
    gelu_tanh, fc2), the attention given the batch's per-image key lengths:
    K1 or K5 with lengths on the card (no [B, h, N, N] score tensor is
    made), their plain versions on the CPU. The MAP head's probe (one query
    row) is a masked torch product,
  * the labeling pipeline's 4 square crops fill the whole 16×16 grid, so they
    run the standard ``models/vit.vit_encode_image``; only native-aspect
    inputs (``CLIPImageEncoder.encode_variable``, the embed stage's
    ``--aspect native``) take :func:`naflex_encode`.

The host resize is PIL's bilinear where PIL is installed; where it is not,
:func:`pil_bilinear_resize` computes the same filter (a triangle, widened on
downscale) as separable integer weights with PIL's 22-bit fixed point and
rounding, which gives PIL's pixels.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models.vit import (
    VisionTransformer,
    VitConfig,
    _act,
    _block_generic,
    _check_nans,
    _layernorm,
)
from clip_assisted_data_labeling_tpu_torch.utils.timer import layer

try:  # optional: the card's machine promises no PIL
    from PIL import Image
except ImportError:
    Image = None


def target_grid(height: int, width: int, patch: int, max_patches: int) -> tuple[int, int]:
    """Aspect-preserving (grid_h, grid_w) with grid_h·grid_w ≤ max_patches,
    by HF's ``get_image_size_for_max_num_patches`` binary search (each side
    scaled, then rounded up to a patch multiple, one patch at least)."""
    def scaled(scale: float, size: int) -> int:
        return max(1, math.ceil(size * scale / patch))

    eps = 1e-5
    lo, hi = eps / 10, 100.0
    while hi - lo >= eps:
        mid = (lo + hi) / 2
        if scaled(mid, height) * scaled(mid, width) <= max_patches:
            lo = mid
        else:
            hi = mid
    return scaled(lo, height), scaled(lo, width)


def _resize_weights_1d(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bilinear resize weights with torch ``F.interpolate(mode=
    'bilinear', align_corners=False, antialias=True)`` semantics: a triangle
    kernel, its support scaled by the downscale ratio, each row normalized
    over the in-range taps."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    x = (np.arange(in_size, dtype=np.float64)[None, :] - centers[:, None]) / support
    w = np.clip(1.0 - np.abs(x), 0.0, None)
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


@functools.lru_cache(maxsize=256)
def pos_resize_weights(grid_h: int, grid_w: int, grid: int = 16) -> np.ndarray:
    """[grid_h·grid_w, grid²] weights with pos_interp = W @ pos_table: the
    separable 2-D resize as one matrix (row r·grid_w + c is the outer product
    of the vertical and horizontal 1-D weights)."""
    wy = _resize_weights_1d(grid, grid_h)
    wx = _resize_weights_1d(grid, grid_w)
    return np.einsum("ri,cj->rcij", wy, wx).reshape(grid_h * grid_w, grid * grid)


@functools.lru_cache(maxsize=256)
def _pos_rows_on(grid_h: int, grid_w: int, grid: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pos_resize_weights(grid_h, grid_w, grid)).to(device)


def pos_weights_on(shapes, max_patches: int, grid: int, device) -> torch.Tensor:
    """Per-image spatial shapes [(gh, gw), …] → [B, max_patches, grid²] on
    ``device``; padded rows are zero (their tokens are masked out of every
    attention). Each grid's weights go to the device once (cached by grid
    and device), so no host array is filled or uploaded a batch."""
    device = torch.device(device)
    out = torch.zeros((len(shapes), max_patches, grid * grid), device=device)
    for i, (gh, gw) in enumerate(shapes):
        out[i, : gh * gw] = _pos_rows_on(gh, gw, grid, device)
    return out


def build_pos_weights(shapes, max_patches: int, grid: int = 16) -> np.ndarray:
    """:func:`pos_weights_on` on the host, as an array (the JAX package's
    ``build_pos_weights``)."""
    return pos_weights_on(shapes, max_patches, grid, "cpu").numpy()


# PIL's resampling precision for 8-bit images (libImaging/Resample.c)
_PIL_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=512)
def pil_bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] int64 fixed-point weights of PIL's BILINEAR resize along one
    axis (``precompute_coeffs`` and ``normalize_coeffs_8bpc``): output pixel
    x's centre is (x + 0.5)·scale, its taps from int(centre - support + 0.5)
    to int(centre + support + 0.5) within the input, the support the triangle
    filter's 1 widened by the downscale ratio, the weights normalized in
    float64, then scaled by 2^22 and rounded half up."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    out = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = np.arange(xmin, xmax, dtype=np.float64)
        w = np.clip(1.0 - np.abs((taps - center + 0.5) / filterscale), 0.0, None)
        total = w.sum()
        if total != 0.0:
            w = w / total
        out[xx, xmin:xmax] = np.floor(0.5 + w * (1 << _PIL_PRECISION_BITS)).astype(np.int64)
    return out


def _pil_pass(img: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """One of PIL's two passes over a uint8 [H, W, C] image along ``axis``:
    integer sums of pixel × weight plus half the scale, shifted down and
    clipped to 0..255. The sums are integers below 2^53, exact in float64."""
    acc = np.tensordot(weights.astype(np.float64), img.astype(np.float64), axes=([1], [axis]))
    if axis == 1:
        acc = acc.transpose(1, 0, 2)
    acc = np.floor((acc + (1 << (_PIL_PRECISION_BITS - 1))) / (1 << _PIL_PRECISION_BITS))
    return np.clip(acc, 0, 255).astype(np.uint8)


def pil_bilinear_resize(img_u8: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), Image.BILINEAR)`` for an
    [H, W, 3] uint8 image without PIL: the horizontal pass first, into a
    uint8 image, then the vertical pass; an axis whose size does not change
    is not resampled."""
    out = img_u8
    if width != img_u8.shape[1]:
        out = _pil_pass(out, pil_bilinear_weights(img_u8.shape[1], width), axis=1)
    if height != img_u8.shape[0]:
        out = _pil_pass(out, pil_bilinear_weights(img_u8.shape[0], height), axis=0)
    return np.ascontiguousarray(out)


def _bilinear_resize(img_u8: np.ndarray, width: int, height: int) -> np.ndarray:
    if Image is not None:
        return np.asarray(Image.fromarray(img_u8).resize((width, height), Image.BILINEAR))
    return pil_bilinear_resize(img_u8, width, height)


@functools.lru_cache(maxsize=16)
def _normalize_table(mean: tuple, std: tuple) -> np.ndarray:
    """[256, 3] float32: each uint8 value of each channel normalized as
    :func:`preprocess_variable` states it (x / 255 in float32, then (x −
    mean) / std in float64, rounded to float32), so a lookup gives the
    formula's bits."""
    x = np.arange(256, dtype=np.float32)[:, None] / 255.0
    return ((x - np.asarray(mean)) / np.asarray(std)).astype(np.float32)


def preprocess_variable(img_u8: np.ndarray, cfg: VitConfig, max_patches: int = 256):
    """One [H, W, 3] uint8 image → (patches [max_patches, p²·3] float32, mask
    [max_patches] float32, (grid_h, grid_w)): the aspect-preserving bilinear
    resize (HF Siglip2ImageProcessor's default, PIL's filter), normalize
    (``(x / 255 − mean) / std``, by a table of the 256 values a channel can
    take), row-major patchify, zero padding."""
    p = cfg.patch_size
    gh, gw = target_grid(img_u8.shape[0], img_u8.shape[1], p, max_patches)
    x = _bilinear_resize(np.ascontiguousarray(img_u8), gw * p, gh * p)
    n = gh * gw
    x = x.reshape(gh, p, gw, p, 3).transpose(0, 2, 1, 3, 4).reshape(n, p * p * 3)
    out = np.zeros((max_patches, p * p * 3), dtype=np.float32)
    out[:n] = _normalize_table(tuple(cfg.norm_mean), tuple(cfg.norm_std))[
        x, np.arange(p * p * 3) % 3]
    mask = np.zeros((max_patches,), dtype=np.float32)
    mask[:n] = 1.0
    return out, mask, (gh, gw)


def _masked_map_pool(x: torch.Tensor, model: VisionTransformer,
                     key_bias: torch.Tensor) -> torch.Tensor:
    """SigLIP's MAP head with the probe attending only over real patches (HF
    Siglip2MultiheadAttentionPoolingHead with an attention mask)."""
    cfg = model.cfg
    B, S, w = x.shape
    heads, dt = cfg.attn_pooler_heads, x.dtype
    d = w // heads
    wq, wk, wv = model.pool_in_kernel.to(dt).split(w, dim=1)
    bq, bk, bv = model.pool_in_bias.to(dt).split(w)
    q = (model.pool_probe.to(dt) @ wq + bq).reshape(heads, 1, d)
    k = (x @ wk + bk).reshape(B, S, heads, d).permute(0, 2, 1, 3)
    v = (x @ wv + bv).reshape(B, S, heads, d).permute(0, 2, 1, 3)
    scores = torch.einsum("hqd,bhsd->bhqs", q.float(), k.float()) * (d ** -0.5)
    probs = torch.softmax(scores + key_bias, dim=-1).to(dt)
    pooled = torch.einsum("bhqs,bhsd->bhqd", probs, v).permute(0, 2, 1, 3)
    h = pooled.reshape(B, w) @ model.pool_out_kernel.to(dt) + model.pool_out_bias.to(dt)
    y = _layernorm(h, model.pool_ln_scale, model.pool_ln_bias, cfg.ln_eps)
    y = _act(y @ model.pool_fc1_kernel.to(dt) + model.pool_fc1_bias.to(dt), cfg.act)
    return h + (y @ model.pool_fc2_kernel.to(dt) + model.pool_fc2_bias.to(dt))


@torch.inference_mode()
def naflex_encode(model: VisionTransformer, patches: torch.Tensor, pos_weights: torch.Tensor,
                  mask: torch.Tensor, compute_dtype=torch.bfloat16, normalize: bool = True,
                  debug_nans: bool = False) -> torch.Tensor:
    """The variable-aspect SigLIP2 forward: patches [B, N_max, p²·3]
    (pre-patchified, normalized), pos_weights [B, N_max, grid²], mask
    [B, N_max] (1 = a real patch; each image's real patches come first) on
    the model's device → [B, width] float32 embeddings, L2-normalized.
    ``debug_nans`` as in ``models/vit.vit_encode_image``. The forward is
    the layer range ``native``."""
    cfg, dt = model.cfg, compute_dtype
    with layer("native"):
        x = patches.to(dt) @ model.patch_kernel.to(dt)
        if cfg.patch_bias:
            x = x + model.patch_bias.to(dt)
        pos = torch.einsum("bnm,mw->bnw", pos_weights.to(torch.float32),
                           model.pos_emb.to(torch.float32))
        x = x + pos.to(dt)
        key_bias = (1.0 - mask.to(torch.float32))[:, None, None, :] * -1e30
        lengths = mask.sum(dim=-1).to(torch.int32)
        for i, blk in enumerate(model.blocks):
            with layer("block"):
                x = _block_generic(x, blk, cfg, s_real=lengths)
            if debug_nans:
                _check_nans(x, f"the output of block {i} (of {cfg.layers})")
        x = _layernorm(x, model.ln_post_scale, model.ln_post_bias, cfg.ln_eps)
        emb = _masked_map_pool(x, model, key_bias).to(torch.float32)
    if debug_nans:
        _check_nans(emb, "the map readout")
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb
