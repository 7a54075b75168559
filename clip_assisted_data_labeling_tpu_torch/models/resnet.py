"""CLIP's modified-ResNet image towers in PyTorch (port of the JAX package's
``models/resnet.py``): RN50, RN101, RN50x4, RN50x16 and RN50x64.

open_clip's ModifiedResNet differs from a torchvision ResNet in three ways:

  * a 3-conv stem (stride-2 3x3 → 3x3 → 3x3) followed by a 2x2 average pool,
  * anti-aliased downsampling: every stride-2 site is an average pool
    followed by a stride-1 conv (in the bottleneck and in its shortcut),
  * an attention-pool readout: the final grid plus a prepended mean token,
    a learned positional embedding, one multi-head attention in which only
    the mean token queries, then the projection to the embedding dim.

Activations stay NHWC as in the JAX package: a convolution reads the NHWC
tensor as a channels-last NCHW view and its output is read back the same way
(no copies), kernels are stored OIHW in channels-last memory. BatchNorm is
folded into per-channel affines at conversion (``models/clip_weights``).
Every step is computed as the JAX code writes it, in the compute dtype: the
affine as a multiply then an add, the 2x2 average pool as a sum in window
order then ``* 1/4``, the residual ``relu(y + shortcut)``; the attention pool
runs its softmax in float32 and casts P to the compute dtype (torch products:
the JAX package runs XLA einsums there, no Pallas kernel).

int8_static (W8A8) runs on the bottleneck 1x1 convolutions: each block's
``conv1``/``conv3`` quantized per output channel (``quantize_rn_params``,
blocks narrower than ``CTPU_RN_INT8_MIN_MID`` stay float), two calibrated
per-tensor activation sites a block (``rn_act_amax``: the block input, the
post-pool ReLU output), and the int8 product over the NHWC rows with a
float32 epilogue through ``ops/quant_kernel.q_matmul_pre``. The JAX
package's ``CTPU_RN_INT8_CONV=1`` form (a 1x1 int8 convolution, there to
spare XLA a relayout) is the same int32 product with the same epilogue, so
the port has the one form.
``rn_int8_static_enabled`` says where int8_static runs (``CTPU_RN_INT8``;
auto: final width ≥ 3072); elsewhere the encoder runs bfloat16, as in the
JAX package. The stem, 3x3 convs, shortcut and attention pool stay float.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.config import CLIP_MEAN, CLIP_STD
from clip_assisted_data_labeling_tpu_torch.models.conv_tower import (
    ConvFamily,
    ConvTower,
    conv_nhwc,
)
from clip_assisted_data_labeling_tpu_torch.ops import knobs
from clip_assisted_data_labeling_tpu_torch.ops.quant import quant_static, quantize_weight
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import q_matmul_pre


@dataclasses.dataclass(frozen=True)
class RNConfig:
    """Geometry of one modified-ResNet tower (open_clip ModifiedResNet args)."""

    layers: tuple = (3, 4, 6, 3)  # bottleneck blocks per stage
    width: int = 64  # stem output channels; stage s runs at width * 2**s
    image_size: int = 224
    embed_dim: int = 1024  # attnpool output dim
    heads: int = 32  # attnpool heads (open_clip: vision_width * 32 // 64)
    bn_eps: float = 1e-5  # torch BatchNorm2d default
    expansion: int = 4  # bottleneck expansion factor
    # the attributes the encoder shares with VitConfig
    patch_size: int | None = None  # no patchify path; crops are [R, R, 3]
    use_rope2d: bool = False
    norm_mean: tuple = CLIP_MEAN
    norm_std: tuple = CLIP_STD

    @property
    def stage_widths(self) -> tuple:
        return tuple(self.width * (2 ** s) for s in range(4))

    @property
    def final_width(self) -> int:
        return self.width * 8 * self.expansion

    @property
    def grid(self) -> int:
        # the stem divides by 4 (stride-2 conv + 2x2 pool), stages 2-4 by 2 each
        return self.image_size // 32

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # +1: the prepended mean token


# open_clip's modified-ResNet geometries (model_configs/RN*.json)
_RN_ARCHS = {
    "RN50": dict(layers=(3, 4, 6, 3), width=64, image_size=224, embed_dim=1024, heads=32),
    "RN101": dict(layers=(3, 4, 23, 3), width=64, image_size=224, embed_dim=512, heads=32),
    "RN50x4": dict(layers=(4, 6, 10, 6), width=80, image_size=288, embed_dim=640, heads=40),
    "RN50x16": dict(layers=(6, 8, 18, 8), width=96, image_size=384, embed_dim=768, heads=48),
    "RN50x64": dict(layers=(3, 15, 36, 10), width=128, image_size=448, embed_dim=1024,
                    heads=64),
}

# the tests' tower: every stage at toy width
RN_TEST_TINY = RNConfig(layers=(1, 1, 1, 1), width=8, image_size=64, embed_dim=16, heads=4)


def resolve_rn_config(arch: str) -> RNConfig | None:
    """'RN50'/'RN101'/'RN50x4'… → RNConfig (None if not an RN name)."""
    if arch == "RN-Test":
        return RN_TEST_TINY
    if arch in _RN_ARCHS:
        return RNConfig(**_RN_ARCHS[arch])
    return None


def _block_widths(cfg: RNConfig):
    """Yield (stage, block, in_ch, mid_ch, stride) for every bottleneck."""
    in_ch = cfg.width
    for s, n_blocks in enumerate(cfg.layers):
        mid = cfg.width * (2 ** s)
        for b in range(n_blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            yield s, b, in_ch, mid, stride
            in_ch = mid * cfg.expansion


def init_rn_params(cfg: RNConfig, generator: torch.Generator,
                   device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Random-init flat parameter dict in the JAX package's layout (conv
    kernels HWIO, folded-BN affines at 1/0) and scales (JAX
    ``init_rn_params``); the values come from ``generator``."""
    def conv(kh, kw, cin, cout):
        fan_in = kh * kw * cin
        return torch.randn((kh, kw, cin, cout), generator=generator, device=device) * fan_in ** -0.5

    def affine(c):
        return torch.ones((c,), device=device), torch.zeros((c,), device=device)

    half = cfg.width // 2
    p = {"conv1": conv(3, 3, 3, half), "conv2": conv(3, 3, half, half),
         "conv3": conv(3, 3, half, cfg.width)}
    for i in (1, 2, 3):
        p[f"bn{i}_scale"], p[f"bn{i}_bias"] = affine(half if i < 3 else cfg.width)
    for s, b, cin, mid, stride in _block_widths(cfg):
        pre = f"s{s}b{b}_"
        out_ch = mid * cfg.expansion
        p[pre + "conv1"] = conv(1, 1, cin, mid)
        p[pre + "conv2"] = conv(3, 3, mid, mid)
        p[pre + "conv3"] = conv(1, 1, mid, out_ch)
        for i, c in ((1, mid), (2, mid), (3, out_ch)):
            p[pre + f"bn{i}_scale"], p[pre + f"bn{i}_bias"] = affine(c)
        if stride > 1 or cin != out_ch:
            p[pre + "down_conv"] = conv(1, 1, cin, out_ch)
            p[pre + "down_scale"], p[pre + "down_bias"] = affine(out_ch)
    w_final = cfg.final_width
    scale = w_final ** -0.5
    p["pool_pos_emb"] = torch.randn((cfg.seq_len, w_final), generator=generator,
                                    device=device) * scale
    for name, cout in (("q", w_final), ("k", w_final), ("v", w_final), ("c", cfg.embed_dim)):
        p[f"pool_{name}_kernel"] = torch.randn((w_final, cout), generator=generator,
                                               device=device) * scale
        p[f"pool_{name}_bias"] = torch.zeros((cout,), device=device)
    return p


def quantize_rn_params(params: dict, min_mid: int | None = None) -> dict:
    """W8A8 weights for the bottleneck 1x1 convolutions (JAX
    ``quantize_rn_params``, models/resnet.py:171-201): a block's ``conv1``/
    ``conv3`` ([1, 1, Cin, Cout] HWIO) becomes a 2-D [Cin, Cout] int8 kernel
    beside a per-output-channel ``_scale``; blocks whose bottleneck width is
    below ``min_mid`` (default ``CTPU_RN_INT8_MIN_MID``) stay float, and
    every other leaf passes through."""
    if min_mid is None:
        min_mid = knobs.RN_INT8_MIN_MID
    out: dict = {}
    for name, leaf in params.items():
        if name.endswith(("conv1", "conv3")) and name.startswith("s") and "_" in name:
            shape = tuple(leaf.shape)
            mid = shape[-1] if name.endswith("conv1") else shape[-2]
            if mid < min_mid:
                out[name] = leaf
                continue
            k = leaf if torch.is_tensor(leaf) else torch.from_numpy(np.array(leaf))
            q, s = quantize_weight(k.reshape(shape[-2:]))
            out[name] = q
            out[name + "_scale"] = s
        else:
            out[name] = leaf
    return out


def is_rn_quantized(params: dict) -> bool:
    return any(k.endswith("conv1_scale") for k in params)


def rn_int8_static_enabled(cfg: RNConfig) -> bool:
    """Whether int8_static runs W8A8 on this tower (JAX
    ``rn_int8_static_enabled``): ``CTPU_RN_INT8=1`` on, ``=0`` off, auto
    where the final width is at least 3072 (RN50x16, RN50x64)."""
    if knobs.RN_INT8 == "on":
        return True
    if knobs.RN_INT8 == "off":
        return False
    return cfg.final_width >= 3072


class ResNetTower(ConvTower):
    """Float conv kernels OIHW in channels-last memory, quantized 1x1
    kernels int8 ``[out, in']``, and after calibration ``s{s}b{b}_act_amax``
    [2]."""

    @property
    def quantized(self) -> bool:
        return any(k.endswith("conv1_scale") for k in self._buffers)

    @property
    def calibrated(self) -> bool:
        return self.has("s0b0_act_amax")

    def forward(self, images: torch.Tensor, compute_dtype=torch.bfloat16,
                normalize: bool = True) -> torch.Tensor:
        return rn_encode_image(self, images, compute_dtype, normalize)


def rn_required_keys(cfg: RNConfig) -> list[str]:
    """The leaves a float tower of this config needs."""
    keys = [f"conv{i}" for i in (1, 2, 3)]
    keys += [f"bn{i}_{p}" for i in (1, 2, 3) for p in ("scale", "bias")]
    for s, b, cin, mid, stride in _block_widths(cfg):
        pre = f"s{s}b{b}_"
        keys += [pre + f"conv{i}" for i in (1, 2, 3)]
        keys += [pre + f"bn{i}_{p}" for i in (1, 2, 3) for p in ("scale", "bias")]
        if stride > 1 or cin != mid * cfg.expansion:
            keys += [pre + "down_conv", pre + "down_scale", pre + "down_bias"]
    keys.append("pool_pos_emb")
    keys += [f"pool_{n}_{p}" for n in "qkvc" for p in ("kernel", "bias")]
    return keys


def _affine_relu(x, m: ResNetTower, name: str, relu: bool = True):
    """The folded BatchNorm, a multiply then an add in x's dtype."""
    y = x * getattr(m, name + "_scale").to(x.dtype) + getattr(m, name + "_bias").to(x.dtype)
    return torch.relu(y) if relu else y


def _avgpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool with stride k on NHWC x, as the JAX ``_avgpool``
    computes it: the window summed in x's dtype in row-major window order
    (XLA's ``reduce_window``: ((x00 + x01) + x10) + x11 for k = 2), then
    ``* (1/(k·k))``."""
    if k == 1:
        return x
    b, h, w, c = x.shape
    v = x.reshape(b, h // k, k, w // k, k, c)
    s = v[:, :, 0, :, 0]
    for i in range(k):
        for j in range(k):
            if i or j:
                s = s + v[:, :, i, :, j]
    return s * (1.0 / (k * k))


def _dequant(m: ResNetTower, key: str, dtype) -> torch.Tensor:
    """A quantized 1x1 kernel as a float OIHW kernel: (int8 · scale) in
    float32, cast to ``dtype`` (the JAX ``_pointwise`` on a quantized
    pytree)."""
    wq_t = getattr(m, key)[:, : m.k_in[key]]
    w = (wq_t.to(torch.float32) * getattr(m, key + "_scale")[:, None]).to(dtype)
    return w[:, :, None, None]


def _pointwise(x, m: ResNetTower, key: str):
    """A 1x1 conv with a float kernel, or a quantized one dequantized (the
    bf16 route and the calibration forward on quantized weights)."""
    w = _dequant(m, key, x.dtype) if m.has(key + "_scale") else getattr(m, key)
    return conv_nhwc(x, w)


def _pointwise_static(x, m: ResNetTower, key: str, amax: torch.Tensor):
    """A statically quantized 1x1 conv over the NHWC rows (JAX
    ``resnet.py:289-313``): the activation quantized with its calibrated
    amax, the int8 × int8 → int32 product and the float32 epilogue
    ``acc·(amax/127)·w_scale`` cast to x's dtype, as ``q_matmul_pre``."""
    xq = quant_static(x, amax)
    b, hh, ww, cin = x.shape
    y = q_matmul_pre(xq.reshape(b * hh * ww, cin), amax * (1.0 / 127.0), getattr(m, key),
                     getattr(m, key + "_scale"), out_dtype=x.dtype)
    return y.reshape(b, hh, ww, y.shape[-1])


def _bottleneck(x, m: ResNetTower, pre: str, stride: int, capture_amax: bool = False):
    """open_clip's Bottleneck: 1x1 → 3x3 → [avgpool if stride > 1] → 1x1, with
    an avgpool + 1x1 shortcut where the shape changes (JAX ``_bottleneck``,
    models/resnet.py:316-351). Three variants: float (or quantized weights
    dequantized, before calibration), int8_static (quantized 1x1 kernels
    and the block's ``act_amax``), and the calibration capture, which also
    returns the block's two site amaxes [2]."""
    static = not capture_amax and m.has(pre + "conv1_scale") and m.has(pre + "act_amax")
    a = getattr(m, pre + "act_amax") if static else None
    a0 = x.to(torch.float32).abs().amax() if capture_amax else None
    if static:
        y = _pointwise_static(x, m, pre + "conv1", a[0])
    else:
        y = _pointwise(x, m, pre + "conv1")
    y = _affine_relu(y, m, pre + "bn1")
    y = _affine_relu(conv_nhwc(y, getattr(m, pre + "conv2"), pad=1), m, pre + "bn2")
    y = _avgpool(y, stride)
    a1 = y.to(torch.float32).abs().amax() if capture_amax else None
    if static:
        y = _pointwise_static(y, m, pre + "conv3", a[1])
    else:
        y = _pointwise(y, m, pre + "conv3")
    y = _affine_relu(y, m, pre + "bn3", relu=False)
    if m.has(pre + "down_conv"):
        shortcut = _affine_relu(_pointwise(_avgpool(x, stride), m, pre + "down_conv"), m,
                                pre + "down", relu=False)
    else:
        shortcut = x
    out = torch.relu(y + shortcut)
    return (out, torch.stack([a0, a1])) if capture_amax else out


def _attention_pool_2d(x: torch.Tensor, m: ResNetTower, cfg: RNConfig) -> torch.Tensor:
    """CLIP's AttentionPool2d: [B, g, g, C] → [B, embed_dim]. Tokens = the
    float32 mean token ‖ the grid, plus the positional embedding; separate
    q/k/v projections, only the mean token queries; softmax in float32, P
    cast to x's dtype; then c_proj (JAX ``_attention_pool_2d``)."""
    B, gh, gw, C = x.shape
    dt = x.dtype
    tokens = x.reshape(B, gh * gw, C)
    mean_tok = tokens.to(torch.float32).mean(dim=1, keepdim=True).to(dt)
    tokens = torch.cat([mean_tok, tokens], dim=1) + m.pool_pos_emb.to(dt)
    h = cfg.heads
    d = C // h
    q = tokens[:, :1] @ m.pool_q_kernel.to(dt) + m.pool_q_bias.to(dt)
    k = tokens @ m.pool_k_kernel.to(dt) + m.pool_k_bias.to(dt)
    v = tokens @ m.pool_v_kernel.to(dt) + m.pool_v_bias.to(dt)
    q = q.reshape(B, 1, h, d).permute(0, 2, 1, 3)
    k = k.reshape(B, -1, h, d).permute(0, 2, 1, 3)
    v = v.reshape(B, -1, h, d).permute(0, 2, 1, 3)
    scores = torch.einsum("bhqd,bhsd->bhqs", q, k) * torch.tensor(d ** -0.5, dtype=dt)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(dt)
    pooled = torch.einsum("bhqs,bhsd->bhqd", probs, v).permute(0, 2, 1, 3).reshape(B, C)
    return pooled @ m.pool_c_kernel.to(dt) + m.pool_c_bias.to(dt)


def _stem(m: ResNetTower, images: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = images.to(compute_dtype)
    x = _affine_relu(conv_nhwc(x, m.conv1, stride=2, pad=1), m, "bn1")
    x = _affine_relu(conv_nhwc(x, m.conv2, pad=1), m, "bn2")
    x = _affine_relu(conv_nhwc(x, m.conv3, pad=1), m, "bn3")
    return _avgpool(x, 2)


@torch.inference_mode()
def rn_encode_image(model: ResNetTower, images: torch.Tensor, compute_dtype=torch.bfloat16,
                    normalize: bool = True, debug_nans: bool = False) -> torch.Tensor:
    """[B, R, R, 3] preprocessed NHWC images → [B, embed_dim] float32,
    L2-normalized (JAX ``rn_encode_image``). ``debug_nans``: each block's
    output and the readout are checked, and the first NaN raises
    ``FloatingPointError`` naming the block."""
    from clip_assisted_data_labeling_tpu_torch.models.vit import _check_nans

    cfg = model.cfg
    x = _stem(model, images, compute_dtype)
    for s, b, _cin, _mid, stride in _block_widths(cfg):
        x = _bottleneck(x, model, f"s{s}b{b}_", stride)
        if debug_nans:
            _check_nans(x, f"the output of block s{s}b{b}")
    emb = _attention_pool_2d(x, model, cfg).to(torch.float32)
    if debug_nans:
        _check_nans(emb, "the attention-pool readout")
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb


@torch.inference_mode()
def rn_act_amax(model: ResNetTower, images: torch.Tensor,
                compute_dtype=torch.bfloat16) -> dict[str, np.ndarray]:
    """Calibration forward → ``{"s{s}b{b}_act_amax": [2]}`` float32: each
    block's two quantized-activation sites (the block input, the post-pool
    ReLU output), quantized kernels dequantized (JAX ``rn_act_amax``). One
    block's activations are held at a time."""
    x = _stem(model, images, compute_dtype)
    amaxes = {}
    for s, b, _cin, _mid, stride in _block_widths(model.cfg):
        pre = f"s{s}b{b}_"
        x, a = _bottleneck(x, model, pre, stride, capture_amax=True)
        amaxes[pre + "act_amax"] = a
    return {k: v.cpu().numpy().astype(np.float32) for k, v in amaxes.items()}


def rn_calib_shapes(cfg: RNConfig) -> dict[str, tuple]:
    """A calibration file's keys and shapes: one [2] a block."""
    return {f"s{s}b{b}_act_amax": (2,) for s, b, *_ in _block_widths(cfg)}


FAMILY = ConvFamily(
    label="ResNet", module=ResNetTower, init=init_rn_params, encode=rn_encode_image,
    quantize=quantize_rn_params, is_quantized=is_rn_quantized,
    int8_static_enabled=rn_int8_static_enabled, act_amax=rn_act_amax,
    required_keys=rn_required_keys, calib_shapes=rn_calib_shapes, int8_sites="1x1 convs",
    no_int8="%s has no dynamic-int8 formulation — use int8_static for the W8A8 "
            "1x1-matmul path; running bfloat16")
