"""CLIP ViT image tower in PyTorch (port of the JAX package's ``models/vit.py``
for the plain CLIP towers).

  * patch embedding as reshape + matmul (a stride-p Conv2d is exactly a
    patchify-matmul; no cuDNN, so no TF32 enters a float32 run),
  * pre-LN blocks with layernorm and softmax statistics in float32,
  * attention through the packed kernel K1 (ops/attention.py) in every mode,
  * int8_static blocks through the layernorm+quantize kernel K2
    (ops/quant_kernel.py) and int8 matmuls with float32 epilogues.

The module holds the JAX package's parameters leaf for leaf (same names, the
same ``[in, out]`` kernels), one ``VitBlock`` per layer instead of the stacked
``[L, …]`` leaves; ``models/clip_weights.py`` carries weights across. Tokens
are not padded: the kernel takes any sequence length, and the cls readout
reads row 0 either way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_assisted_data_labeling_tpu_torch.config import CLIP_MEAN, CLIP_STD
from clip_assisted_data_labeling_tpu_torch.ops.attention import packed_attention_auto
from clip_assisted_data_labeling_tpu_torch.ops.quant import q_matmul, quant_static
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    q_matmul_pre,
    rowquant_static,
)


@dataclasses.dataclass(frozen=True)
class VitConfig:
    width: int = 1024
    layers: int = 24
    heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    embed_dim: int = 768  # output CLIP embedding dim
    mlp_ratio: int = 4
    mlp_hidden: int | None = None  # explicit MLP width (overrides mlp_ratio)
    act: str = "quick_gelu"  # OpenAI; open-data "gelu"
    ln_eps: float = 1e-5
    norm_mean: tuple = CLIP_MEAN
    norm_std: tuple = CLIP_STD

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # + the class token

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def mlp_dim(self) -> int:
        return self.mlp_hidden if self.mlp_hidden else self.mlp_ratio * self.width


# The plain CLIP towers under the reference's "Arch/pretrained" naming.
_OPENAI = dict(act="quick_gelu")
_OPEN = dict(act="gelu")
_ARCHS = {
    "ViT-B-32": dict(width=768, layers=12, heads=12, patch_size=32, image_size=224, embed_dim=512),
    "ViT-B-16": dict(width=768, layers=12, heads=12, patch_size=16, image_size=224, embed_dim=512),
    "ViT-L-14": dict(width=1024, layers=24, heads=16, patch_size=14, image_size=224, embed_dim=768),
    "ViT-L-14-336": dict(width=1024, layers=24, heads=16, patch_size=14, image_size=336, embed_dim=768),
    "ViT-H-14": dict(width=1280, layers=32, heads=16, patch_size=14, image_size=224, embed_dim=1024),
    "ViT-g-14": dict(width=1408, layers=40, heads=16, patch_size=14,
                     image_size=224, embed_dim=1024, mlp_hidden=6144),
    "ViT-bigG-14": dict(width=1664, layers=48, heads=16, patch_size=14,
                        image_size=224, embed_dim=1280, mlp_hidden=8192),
}
_OPEN_TAGS = ("laion2b_s32b_b82k", "laion2b_s34b_b79k", "laion400m_e32", "datacomp_xl_s13b_b90k")

MODEL_REGISTRY: dict[str, VitConfig] = {
    # tiny config for tests (not a real pretrained model)
    "ViT-Test/tiny": VitConfig(
        width=64, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=16
    ),
}
for _arch, _kw in _ARCHS.items():
    MODEL_REGISTRY[f"{_arch}/openai"] = VitConfig(**_kw, **_OPENAI)
    for _tag in _OPEN_TAGS:
        MODEL_REGISTRY[f"{_arch}/{_tag}"] = VitConfig(**_kw, **_OPEN)


def resolve_config(model_name: str) -> VitConfig:
    """Config of a registered plain CLIP tower; every other family the JAX
    package resolves (PE, SigLIP, EVA, CoCa, CLIPA, ResNet, ConvNeXt, …)
    raises until it is ported."""
    if model_name in MODEL_REGISTRY:
        return MODEL_REGISTRY[model_name]
    raise ValueError(
        f"{model_name}: not ported yet — the PyTorch port serves the plain CLIP "
        f"towers {sorted(MODEL_REGISTRY)}; use the JAX package for the others"
    )


def init_vit_params(cfg: VitConfig, generator: torch.Generator,
                    device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Random-init flat parameter dict (open_clip-style scaled normal init) in
    the JAX package's key layout: ``blocks/<name>`` leaves stacked ``[L, …]``."""
    w, L, e, mlp = cfg.width, cfg.layers, cfg.embed_dim, cfg.mlp_dim
    scale = w ** -0.5

    def nrm(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    def ones(shape):
        return torch.ones(shape, device=device)

    def zeros(shape):
        return torch.zeros(shape, device=device)

    return {
        "patch_kernel": nrm((cfg.patch_size * cfg.patch_size * 3, w), scale),
        "class_emb": nrm((w,), scale),
        "pos_emb": nrm((cfg.seq_len, w), scale),
        "ln_pre_scale": ones((w,)),
        "ln_pre_bias": zeros((w,)),
        "blocks/ln1_scale": ones((L, w)),
        "blocks/ln1_bias": zeros((L, w)),
        "blocks/qkv_kernel": nrm((L, w, 3 * w), scale),
        "blocks/qkv_bias": zeros((L, 3 * w)),
        "blocks/out_kernel": nrm((L, w, w), scale),
        "blocks/out_bias": zeros((L, w)),
        "blocks/ln2_scale": ones((L, w)),
        "blocks/ln2_bias": zeros((L, w)),
        "blocks/fc1_kernel": nrm((L, w, mlp), (2 * w) ** -0.5),
        "blocks/fc1_bias": zeros((L, mlp)),
        "blocks/fc2_kernel": nrm((L, mlp, w), scale),
        "blocks/fc2_bias": zeros((L, w)),
        "ln_post_scale": ones((w,)),
        "ln_post_bias": zeros((w,)),
        "proj": nrm((w, e), scale),
    }


class VitBlock(nn.Module):
    """One transformer block's leaves as buffers. Quantized kernels are int8
    stored ``[out, in]`` (the layout ``torch._int_mm`` takes) beside their
    per-output-channel ``*_scale``; ``act_amax`` [4] is attached by
    :func:`attach_act_amax` and selects the int8_static path."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t)

    @property
    def quantized(self) -> bool:
        return hasattr(self, "qkv_kernel_scale")

    @property
    def static(self) -> bool:
        return hasattr(self, "act_amax")


class VisionTransformer(nn.Module):
    """The CLIP ViT image tower: stem leaves + ``blocks`` (one VitBlock per
    layer). Build it from a flat parameter dict with
    ``models.clip_weights.module_from_params``."""

    def __init__(self, cfg: VitConfig, top: dict[str, torch.Tensor],
                 blocks: list[dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        for name, t in top.items():
            self.register_buffer(name, t)
        self.blocks = nn.ModuleList(VitBlock(b) for b in blocks)

    @property
    def quantized(self) -> bool:
        return hasattr(self, "patch_kernel_scale")

    @property
    def calibrated(self) -> bool:
        return self.blocks[0].static

    def forward(self, images: torch.Tensor, compute_dtype=torch.bfloat16,
                normalize: bool = True) -> torch.Tensor:
        return vit_encode_image(self, images, compute_dtype, normalize)


def _layernorm(x, scale, bias, eps):
    """float32 layernorm with population variance, output in x's dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def _act(x, kind: str, quantized: bool = False):
    if kind == "quick_gelu":  # OpenAI CLIP's x * sigmoid(1.702 x), in x's dtype
        return x * torch.sigmoid(torch.tensor(1.702, dtype=x.dtype, device=x.device) * x)
    if kind == "gelu_tanh" or quantized:
        # int8 paths take the tanh form of gelu: its <=1e-3 absolute error is
        # far below the int8 step the output suffers next
        return F.gelu(x, approximate="tanh")
    return F.gelu(x, approximate="none")


def _linear(x, blk: VitBlock, name: str, residual=None):
    """Block matmul: float (x @ W + b in x's dtype) or, for a quantized block
    without static scales (the calibration forward), dynamic per-row W8A8."""
    bias = getattr(blk, name.replace("_kernel", "_bias"))
    if blk.quantized:
        return q_matmul(x, getattr(blk, name), getattr(blk, name + "_scale"), bias,
                        out_dtype=x.dtype, residual=residual)
    y = x @ getattr(blk, name).to(x.dtype) + bias.to(x.dtype)
    return y if residual is None else residual + y


def _block_float(x, blk: VitBlock, cfg: VitConfig):
    """Pre-LN block in float32 or bfloat16 with the packed attention kernel."""
    y = _layernorm(x, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
    qkv = _linear(y, blk, "qkv_kernel")
    attn = packed_attention_auto(qkv, heads=cfg.heads, scale=cfg.head_dim ** -0.5)
    x = x + _linear(attn, blk, "out_kernel")
    y = _layernorm(x, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
    y = _act(_linear(y, blk, "fc1_kernel"), cfg.act)
    return x + _linear(y, blk, "fc2_kernel")


def _block_int8_static_lnk(x, blk: VitBlock, cfg: VitConfig):
    """int8_static block: layernorm + static quantize in one kernel (K2) for
    ln1 and ln2, int8 matmuls with float32 epilogues, packed attention (K1)
    on the bfloat16 qkv. Same op order and residual placement as the JAX
    package's ``_block_int8_static_lnk``."""
    B, S, w = x.shape
    a = blk.act_amax
    inv127 = 1.0 / 127.0
    x2 = x.reshape(B * S, w)
    xq = rowquant_static(x2, blk.ln1_scale, blk.ln1_bias, a[0:1], ln_eps=cfg.ln_eps)
    qkv = q_matmul_pre(xq, a[0] * inv127, blk.qkv_kernel, blk.qkv_kernel_scale,
                       blk.qkv_bias)
    attn = packed_attention_auto(qkv.reshape(B, S, 3 * w), heads=cfg.heads,
                                 scale=cfg.head_dim ** -0.5)
    attn_q = quant_static(attn, a[1]).reshape(B * S, w)
    x2 = x2 + q_matmul_pre(attn_q, a[1] * inv127, blk.out_kernel, blk.out_kernel_scale,
                           blk.out_bias, out_dtype=x.dtype)
    hq = rowquant_static(x2, blk.ln2_scale, blk.ln2_bias, a[2:3], ln_eps=cfg.ln_eps)
    h = q_matmul_pre(hq, a[2] * inv127, blk.fc1_kernel, blk.fc1_kernel_scale, blk.fc1_bias)
    g = _act(h, cfg.act, quantized=True)
    x2 = q_matmul_pre(quant_static(g, a[3]), a[3] * inv127, blk.fc2_kernel,
                      blk.fc2_kernel_scale, blk.fc2_bias, residual=x2, out_dtype=x.dtype)
    return x2.reshape(B, S, w)


def _block(x, blk: VitBlock, cfg: VitConfig):
    if blk.static:
        return _block_int8_static_lnk(x, blk, cfg)
    if blk.quantized:
        raise NotImplementedError(
            "dynamic int8 (compute_dtype 'int8') is not ported yet; use "
            "int8_static, bfloat16 or float32"
        )
    return _block_float(x, blk, cfg)


def _patch_embed(model: VisionTransformer, images: torch.Tensor, compute_dtype) -> torch.Tensor:
    """[B, R, R, 3] NHWC images → [B, N, width] as reshape + matmul (patch
    flatten order (row, col, channel), matching the converted Conv2d weight).
    int8 checkpoints dequantize the small [p·p·3, w] kernel on the fly."""
    if model.quantized:
        w_patch = (model.patch_kernel.to(torch.float32)
                   * model.patch_kernel_scale.to(torch.float32)).to(compute_dtype)
    else:
        w_patch = model.patch_kernel.to(compute_dtype)
    p = model.cfg.patch_size
    b, H, W, c = images.shape
    gh, gw = H // p, W // p
    x = images[:, : gh * p, : gw * p].to(compute_dtype)
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
    return x @ w_patch


def _stem(model: VisionTransformer, images: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Patch embed, class token, positional embedding, ln_pre — one
    implementation for inference and calibration."""
    cfg = model.cfg
    x = _patch_embed(model, images, compute_dtype)
    cls = model.class_emb.to(compute_dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + model.pos_emb.to(compute_dtype)
    return _layernorm(x, model.ln_pre_scale, model.ln_pre_bias, cfg.ln_eps)


@torch.inference_mode()
def vit_encode_image(model: VisionTransformer, images: torch.Tensor,
                     compute_dtype=torch.bfloat16, normalize: bool = True) -> torch.Tensor:
    """[B, R, R, 3] preprocessed (CLIP-normalized) NHWC images → [B, embed_dim]
    float32, L2-normalized like the reference's encode_image."""
    cfg = model.cfg
    x = _stem(model, images, compute_dtype)
    for blk in model.blocks:
        x = _block(x, blk, cfg)
    pooled = _layernorm(x[:, 0], model.ln_post_scale, model.ln_post_bias, cfg.ln_eps)
    emb = (pooled @ model.proj.to(compute_dtype)).to(torch.float32)
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb


@torch.inference_mode()
def vit_act_amax(model: VisionTransformer, images: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> dict[str, np.ndarray]:
    """Calibration forward for static W8A8 → {"act_amax": [layers, 4],
    "qkv_amax": [layers, 3·width]} float32.

    act_amax columns are the four per-tensor quantized-activation sites of a
    block (qkv input, attention output, fc1 input, gelu output); qkv_amax is
    the per-channel amax of the qkv projection output (kept in the
    calibration file for the JAX package's int8 attention wire). Quantized
    matmuls run dynamic per-row here; attention runs the packed kernel K1
    (the JAX package runs its XLA attention here — same function, other
    rounding of q·scale)."""
    cfg = model.cfg
    x = _stem(model, images, compute_dtype)
    quantized = model.quantized
    act, qkv_ch = [], []
    for blk in model.blocks:
        y = _layernorm(x, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
        s_qkv = y.to(torch.float32).abs().amax()
        qkv = _linear(y, blk, "qkv_kernel")
        qkv_ch.append(qkv.to(torch.float32).abs().amax(dim=(0, 1)))
        attn = packed_attention_auto(qkv, heads=cfg.heads, scale=cfg.head_dim ** -0.5)
        s_attn = attn.to(torch.float32).abs().amax()
        x = x + _linear(attn, blk, "out_kernel")
        y = _layernorm(x, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
        s_fc1 = y.to(torch.float32).abs().amax()
        g = _act(_linear(y, blk, "fc1_kernel"), cfg.act, quantized=quantized)
        s_act = g.to(torch.float32).abs().amax()
        x = x + _linear(g, blk, "fc2_kernel")
        act.append(torch.stack([s_qkv, s_attn, s_fc1, s_act]))
    return {
        "act_amax": torch.stack(act).cpu().numpy().astype(np.float32),
        "qkv_amax": torch.stack(qkv_ch).cpu().numpy().astype(np.float32),
    }


def attach_act_amax(model: VisionTransformer, amax, margin: float = 1.1) -> None:
    """Attach calibrated static-activation scales (× margin, which covers
    batch-to-batch drift) to every block, in place. ``amax``: the dict from
    :func:`vit_act_amax` or a bare [layers, 4] array. Only ``act_amax`` is
    attached: the port has no int8 attention wire."""
    a = amax["act_amax"] if isinstance(amax, dict) else amax
    a = np.asarray(a, np.float32) * np.float32(margin)
    for i, blk in enumerate(model.blocks):
        blk.register_buffer("act_amax", torch.from_numpy(a[i].copy()).to(blk.ln1_scale.device))
