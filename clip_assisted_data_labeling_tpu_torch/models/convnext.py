"""open_clip's ConvNeXt image towers in PyTorch (port of the JAX package's
``models/convnext.py``): convnext_base/_w/_w_320, large/_d/_d_320, xxlarge/
_320 and the tiers open_clip publishes without weights.

A timm ConvNeXt trunk plus open_clip's projection head:

  * stem: 4x4 stride-4 conv + LayerNorm (eps 1e-6),
  * 4 stages; stages 2-4 open with a LayerNorm + 2x2 stride-2 conv; each
    block is a depthwise 7x7 conv → LN → Linear(C→4C) → exact GELU →
    Linear(4C→C) → layer-scale gamma → residual,
  * head: global average pool (float32) → LayerNorm → a Linear projection
    (``proj="linear"``) or Linear-GELU-Linear with hidden 2·embed_dim
    (``"mlp"``, the ``_d`` towers).

Activations stay NHWC, as in the JAX package (a conv reads the tensor as a
channels-last NCHW view); the depthwise 7x7 is ``F.conv2d(groups=C)``; the
pointwise Linears are matmuls over the NHWC rows. LayerNorm statistics run
in float32. The exact GELU is computed as ``jax.nn.gelu(approximate=False)``
writes it, step by step in the compute dtype (:func:`gelu_exact`); the
residual ``x + gamma·y`` is a multiply then an add. The per-stage block
leaves are stacked along a leading depth axis, the JAX package's on-disk
layout; the forward loops over a stage's blocks where the JAX package scans.

int8_static (W8A8) runs on the pointwise matmuls (``quantize_cnx_params``
per stacked layer, two calibrated per-tensor sites a block from
``cnx_act_amax``: the post-LN fc1 input and the post-GELU fc2 input), each
through ``ops/quant_kernel.q_matmul_pre``. ``cnx_int8_static_enabled`` says
where (``CTPU_CNX_INT8``; auto: final width ≥ 1536); elsewhere the encoder
runs bfloat16, as in the JAX package.
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
class CNXConfig:
    """Geometry of one open_clip ConvNeXt tower (timm trunk + proj head)."""

    depths: tuple = (3, 3, 27, 3)  # blocks per stage
    dims: tuple = (128, 256, 512, 1024)  # channels per stage
    image_size: int = 256
    embed_dim: int = 640
    proj: str = "linear"  # 'linear' | 'mlp' (open_clip TimmModel head)
    ln_eps: float = 1e-6  # block/stem/downsample LNs
    head_ln_eps: float = 1e-6  # the post-pool LN (HF ConvNextModel: layer_norm_eps)
    # the attributes the encoder shares with VitConfig
    patch_size: int | None = None  # no patchify path; crops are [R, R, 3]
    use_rope2d: bool = False
    norm_mean: tuple = CLIP_MEAN
    norm_std: tuple = CLIP_STD

    @property
    def final_width(self) -> int:
        return self.dims[-1]

    @property
    def grid(self) -> int:
        return self.image_size // 32  # stem /4, three stride-2 downsamples


# open_clip's ConvNeXt-CLIP geometries (model_configs/convnext_*.json); the
# last four are tiers open_clip publishes without pretrained tags
_CNX_ARCHS = {
    "convnext_base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024), image_size=224,
                          embed_dim=512, proj="linear"),
    "convnext_base_w": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024), image_size=256,
                            embed_dim=640, proj="linear"),
    "convnext_base_w_320": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                                image_size=320, embed_dim=640, proj="linear"),
    "convnext_large_d": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536), image_size=256,
                             embed_dim=768, proj="mlp"),
    "convnext_large_d_320": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536),
                                 image_size=320, embed_dim=768, proj="mlp"),
    "convnext_xxlarge": dict(depths=(3, 4, 30, 3), dims=(384, 768, 1536, 3072), image_size=256,
                             embed_dim=1024, proj="linear"),
    "convnext_xxlarge_320": dict(depths=(3, 4, 30, 3), dims=(384, 768, 1536, 3072),
                                 image_size=320, embed_dim=1024, proj="linear"),
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), image_size=224,
                          embed_dim=1024, proj="linear"),
    "convnext_small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768), image_size=224,
                           embed_dim=512, proj="linear"),
    "convnext_large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536), image_size=224,
                           embed_dim=768, proj="linear"),
    "convnext_xlarge": dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048), image_size=224,
                            embed_dim=1024, proj="linear"),
}

# the tests' tower: all four stages at toy width ('CNX-Test-mlp' with the mlp head)
CNX_TEST_TINY = CNXConfig(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32), image_size=64,
                          embed_dim=16, proj="linear")

_BLOCK_KEYS = ("dw_kernel", "dw_bias", "ln_scale", "ln_bias", "fc1_kernel", "fc1_bias",
               "fc2_kernel", "fc2_bias", "gamma")


def resolve_cnx_config(arch: str) -> CNXConfig | None:
    """'convnext_base_w'/'convnext_large_d_320'… → CNXConfig (None if not a
    ConvNeXt name)."""
    if arch == "CNX-Test":
        return CNX_TEST_TINY
    if arch == "CNX-Test-mlp":
        return dataclasses.replace(CNX_TEST_TINY, proj="mlp")
    if arch in _CNX_ARCHS:
        return CNXConfig(**_CNX_ARCHS[arch])
    return None


def init_cnx_params(cfg: CNXConfig, generator: torch.Generator,
                    device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Random-init flat parameter dict in the JAX package's layout (HWIO
    convs, per-stage block leaves stacked [depth, …]) and scales (JAX
    ``init_cnx_params``); the values come from ``generator``."""
    def nrm(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    def full(shape, v):
        return torch.full(shape, v, device=device)

    c0 = cfg.dims[0]
    p = {"stem_kernel": nrm((4, 4, 3, c0), (4 * 4 * 3) ** -0.5),
         "stem_bias": full((c0,), 0.0), "stem_ln_scale": full((c0,), 1.0),
         "stem_ln_bias": full((c0,), 0.0)}
    for s, (d, c) in enumerate(zip(cfg.depths, cfg.dims)):
        if s > 0:
            cin = cfg.dims[s - 1]
            p[f"s{s}_down_ln_scale"] = full((cin,), 1.0)
            p[f"s{s}_down_ln_bias"] = full((cin,), 0.0)
            p[f"s{s}_down_kernel"] = nrm((2, 2, cin, c), (2 * 2 * cin) ** -0.5)
            p[f"s{s}_down_bias"] = full((c,), 0.0)
        p[f"s{s}_dw_kernel"] = nrm((d, 7, 7, 1, c), (7 * 7) ** -0.5)
        p[f"s{s}_dw_bias"] = full((d, c), 0.0)
        p[f"s{s}_ln_scale"] = full((d, c), 1.0)
        p[f"s{s}_ln_bias"] = full((d, c), 0.0)
        p[f"s{s}_fc1_kernel"] = nrm((d, c, 4 * c), c ** -0.5)
        p[f"s{s}_fc1_bias"] = full((d, 4 * c), 0.0)
        p[f"s{s}_fc2_kernel"] = nrm((d, 4 * c, c), (4 * c) ** -0.5)
        p[f"s{s}_fc2_bias"] = full((d, c), 0.0)
        p[f"s{s}_gamma"] = full((d, c), 1e-6)
    cl = cfg.final_width
    p["head_ln_scale"] = full((cl,), 1.0)
    p["head_ln_bias"] = full((cl,), 0.0)
    if cfg.proj == "mlp":
        hidden = 2 * cfg.embed_dim  # open_clip TimmModel Mlp(prev, 2E, E)
        p["proj_fc1_kernel"] = nrm((cl, hidden), cl ** -0.5)
        p["proj_fc1_bias"] = full((hidden,), 0.0)
        p["proj_fc2_kernel"] = nrm((hidden, cfg.embed_dim), hidden ** -0.5)
        p["proj_fc2_bias"] = full((cfg.embed_dim,), 0.0)
    else:
        p["proj_kernel"] = nrm((cl, cfg.embed_dim), cl ** -0.5)
        p["proj_bias"] = full((cfg.embed_dim,), 0.0)
    return p


def cnx_required_keys(cfg: CNXConfig) -> list[str]:
    """The leaves a float tower of this config needs."""
    keys = ["stem_kernel", "stem_bias", "stem_ln_scale", "stem_ln_bias", "head_ln_scale",
            "head_ln_bias"]
    for s in range(len(cfg.depths)):
        if s > 0:
            keys += [f"s{s}_down_{k}" for k in ("ln_scale", "ln_bias", "kernel", "bias")]
        keys += [f"s{s}_{k}" for k in _BLOCK_KEYS]
    if cfg.proj == "mlp":
        keys += ["proj_fc1_kernel", "proj_fc1_bias", "proj_fc2_kernel", "proj_fc2_bias"]
    else:
        keys += ["proj_kernel", "proj_bias"]
    return keys


def quantize_cnx_params(params: dict) -> dict:
    """W8A8 weights for the pointwise block matmuls (JAX
    ``quantize_cnx_params``): each stacked ``s{s}_fc1_kernel``/
    ``s{s}_fc2_kernel`` [D, K, N] becomes int8 with a per-layer,
    per-output-channel ``_scale`` [D, N]; every other leaf passes through."""
    out: dict = {}
    for name, leaf in params.items():
        if name.endswith(("_fc1_kernel", "_fc2_kernel")) and name.startswith("s"):
            k = leaf if torch.is_tensor(leaf) else torch.from_numpy(np.array(leaf))
            # amax over axis -2 of the stack == each layer's own per-column amax
            out[name], out[name + "_scale"] = quantize_weight(k)
        else:
            out[name] = leaf
    return out


def is_cnx_quantized(params: dict) -> bool:
    return "s0_fc1_kernel_scale" in params


def cnx_int8_static_enabled(cfg: CNXConfig) -> bool:
    """Whether int8_static runs W8A8 on this tower (JAX
    ``cnx_int8_static_enabled``): ``CTPU_CNX_INT8=1`` on, ``=0`` off, auto
    where the final width is at least 1536 (the large and xxlarge towers)."""
    if knobs.CNX_INT8 == "on":
        return True
    if knobs.CNX_INT8 == "off":
        return False
    return cfg.final_width >= 1536


class ConvNeXtTower(ConvTower):
    """The stem and downsample kernels OIHW in channels-last memory, each
    stage's depthwise kernels [D, C, 1, 7, 7], float fc kernels [D, K, N] as
    stored, int8 ones ``[D, N, K']``, and after calibration ``s{s}_act_amax``
    [D, 2]."""

    @property
    def quantized(self) -> bool:
        return self.has("s0_fc1_kernel_scale")

    @property
    def calibrated(self) -> bool:
        return self.has("s0_act_amax")

    def forward(self, images: torch.Tensor, compute_dtype=torch.bfloat16,
                normalize: bool = True) -> torch.Tensor:
        return cnx_encode_image(self, images, compute_dtype, normalize)


def _ln(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """LayerNorm over the trailing channel axis, statistics in float32,
    output in x's dtype (JAX ``_ln``)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)`` as written,
    ``0.5·x·erfc(-x·√½)``, each step rounded to x's dtype: on the JAX CPU
    run in bf16 it gives the op-by-op result bit for bit, where
    ``F.gelu`` (float32 inside, one rounding) differs on about a third of
    the values."""
    sqrt_half = torch.tensor(np.sqrt(0.5), dtype=x.dtype, device=x.device)
    return (0.5 * x) * torch.special.erfc(-x * sqrt_half)


def _deq(m: ConvNeXtTower, key: str, i: int, dtype) -> torch.Tensor:
    """Layer i of a quantized stacked kernel as a dense [K, N] kernel:
    (int8 · scale) in float32, cast to ``dtype`` (JAX ``_deq``)."""
    wq_t = getattr(m, key)[i, :, : m.k_in[key]]
    return (wq_t.to(torch.float32) * getattr(m, key + "_scale")[i][:, None]).to(dtype).t()


def _stage(x: torch.Tensor, m: ConvNeXtTower, s: int, cfg: CNXConfig,
           capture_amax: bool = False, debug_nans: bool = False):
    """One ConvNeXt stage (JAX ``_stage``, models/convnext.py:269-341): the
    LN + 2x2/2 downsample after stage 0, then its blocks in order. Three
    block variants share the depthwise conv + LN front: float (or quantized
    weights dequantized, before calibration), int8_static (quantized fc
    kernels and the stage's ``act_amax``: both matmuls int8), and the
    calibration capture, which also returns the blocks' site amaxes
    [depth, 2]."""
    from clip_assisted_data_labeling_tpu_torch.models.vit import _check_nans

    dt = x.dtype

    def leaf(k, i=None):
        t = getattr(m, f"s{s}_{k}")
        return t if i is None else t[i]

    if s > 0:
        y = _ln(x, leaf("down_ln_scale"), leaf("down_ln_bias"), cfg.ln_eps)
        x = conv_nhwc(y, leaf("down_kernel"), stride=2) + leaf("down_bias").to(dt)
    c = cfg.dims[s]
    quantized = m.has(f"s{s}_fc1_kernel_scale")
    static = not capture_amax and quantized and m.has(f"s{s}_act_amax")
    inv127 = 1.0 / 127.0
    aux = []
    for i in range(cfg.depths[s]):
        y = conv_nhwc(x, leaf("dw_kernel", i), pad=3, groups=c) + leaf("dw_bias", i).to(dt)
        y = _ln(y, leaf("ln_scale", i), leaf("ln_bias", i), cfg.ln_eps)
        if static:
            a = leaf("act_amax", i)
            b, hh, ww, _ = y.shape
            yq = quant_static(y, a[0]).reshape(b * hh * ww, c)
            h = q_matmul_pre(yq, a[0] * inv127, leaf("fc1_kernel", i),
                             leaf("fc1_kernel_scale", i), leaf("fc1_bias", i))
            g = gelu_exact(h)
            y2 = q_matmul_pre(quant_static(g, a[1]), a[1] * inv127, leaf("fc2_kernel", i),
                              leaf("fc2_kernel_scale", i), leaf("fc2_bias", i),
                              out_dtype=dt).reshape(b, hh, ww, c)
            x = x + leaf("gamma", i).to(dt) * y2
        else:
            if quantized:
                w1 = _deq(m, f"s{s}_fc1_kernel", i, dt)
                w2 = _deq(m, f"s{s}_fc2_kernel", i, dt)
            else:
                w1, w2 = leaf("fc1_kernel", i).to(dt), leaf("fc2_kernel", i).to(dt)
            a0 = y.to(torch.float32).abs().amax() if capture_amax else None
            y = y @ w1 + leaf("fc1_bias", i).to(dt)
            y = gelu_exact(y)
            a1 = y.to(torch.float32).abs().amax() if capture_amax else None
            y = y @ w2 + leaf("fc2_bias", i).to(dt)
            x = x + leaf("gamma", i).to(dt) * y
            if capture_amax:
                aux.append(torch.stack([a0, a1]))
        if debug_nans:
            _check_nans(x, f"the output of stage {s} block {i}")
    return (x, torch.stack(aux)) if capture_amax else x


def _stem(m: ConvNeXtTower, images: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = images.to(compute_dtype)
    x = conv_nhwc(x, m.stem_kernel, stride=4) + m.stem_bias.to(x.dtype)
    return _ln(x, m.stem_ln_scale, m.stem_ln_bias, m.cfg.ln_eps)


@torch.inference_mode()
def cnx_encode_image(model: ConvNeXtTower, images: torch.Tensor, compute_dtype=torch.bfloat16,
                     normalize: bool = True, debug_nans: bool = False) -> torch.Tensor:
    """[B, R, R, 3] preprocessed NHWC images → [B, embed_dim] float32,
    L2-normalized (JAX ``cnx_encode_image``): stem, stages, the global mean
    in float32, head LN, then the linear or mlp projection in the compute
    dtype. ``debug_nans``: each block's output and the readout are checked,
    and the first NaN raises ``FloatingPointError`` naming the block."""
    from clip_assisted_data_labeling_tpu_torch.models.vit import _check_nans

    cfg = model.cfg
    x = _stem(model, images, compute_dtype)
    for s in range(len(cfg.depths)):
        x = _stage(x, model, s, cfg, debug_nans=debug_nans)
    pooled = x.to(torch.float32).mean(dim=(1, 2))
    pooled = _ln(pooled, model.head_ln_scale, model.head_ln_bias, cfg.head_ln_eps)
    pooled = pooled.to(compute_dtype)
    dt = pooled.dtype
    if cfg.proj == "mlp":
        h = pooled @ model.proj_fc1_kernel.to(dt) + model.proj_fc1_bias.to(dt)
        h = gelu_exact(h)
        emb = h @ model.proj_fc2_kernel.to(dt) + model.proj_fc2_bias.to(dt)
    else:
        emb = pooled @ model.proj_kernel.to(dt) + model.proj_bias.to(dt)
    emb = emb.to(torch.float32)
    if debug_nans:
        _check_nans(emb, f"the {cfg.proj} head")
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb


@torch.inference_mode()
def cnx_act_amax(model: ConvNeXtTower, images: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> dict[str, np.ndarray]:
    """Calibration forward → ``{"s{s}_act_amax": [depth, 2]}`` float32: each
    block's two quantized-activation sites (post-LN fc1 input, post-GELU fc2
    input), quantized kernels dequantized (JAX ``cnx_act_amax``)."""
    x = _stem(model, images, compute_dtype)
    amaxes = {}
    for s in range(len(model.cfg.depths)):
        x, amaxes[f"s{s}_act_amax"] = _stage(x, model, s, model.cfg, capture_amax=True)
    return {k: v.cpu().numpy().astype(np.float32) for k, v in amaxes.items()}


def cnx_calib_shapes(cfg: CNXConfig) -> dict[str, tuple]:
    """A calibration file's keys and shapes: one [depth, 2] a stage."""
    return {f"s{s}_act_amax": (d, 2) for s, d in enumerate(cfg.depths)}


FAMILY = ConvFamily(
    label="ConvNeXt", module=ConvNeXtTower, init=init_cnx_params, encode=cnx_encode_image,
    quantize=quantize_cnx_params, is_quantized=is_cnx_quantized,
    int8_static_enabled=cnx_int8_static_enabled, act_amax=cnx_act_amax,
    required_keys=cnx_required_keys, calib_shapes=cnx_calib_shapes,
    int8_sites="pointwise matmuls",
    no_int8="%s has no int8 formulation — use int8_static for the W8A8 pointwise-matmul "
            "path; running bfloat16")
