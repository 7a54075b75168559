"""The ViT image towers in PyTorch (port of the JAX package's
``models/vit.py``): the plain CLIP towers and every name of open_clip's
ViT-trunk surface (``-quickgelu`` aliases, generic ``ViT-{S..e}-{patch}``
geometry names, the multilingual and NLLB-CLIP combos), the SigLIP/SigLIP2
towers (fixed-resolution and naflex), the Perception Encoder cores, the EVA
family (EVA01, EVA02 pre-norm, EVA02-E post-norm), CoCa and CLIPA. Its
``resolve_config`` serves the whole open_clip name surface: the modified
ResNet and ConvNeXt names resolve to the configs of ``models/resnet.py`` and
``models/convnext.py``.

  * patch embedding as reshape + matmul (a stride-p Conv2d is exactly a
    patchify-matmul; no cuDNN, so no TF32 enters a float32 run); SigLIP's
    and EVA's patch convs have a bias, and a non-patch-divisible resolution
    (SO400M-14 @384 = 27·14 + 6) drops the trailing pixels as a valid conv,
  * pre-LN blocks with layernorm and softmax statistics in float32, or
    EVA02-E's post-norm blocks (``x + ln(sublayer(x))``), EVA02's attention
    sub-LN before the out projection and its SwiGLU MLP (w1‖w2 packed into
    one fc1, silu gate, ffn sub-LN, w3),
  * float blocks' attention through ``ops/attention.packed_attention_auto``:
    K1 or K4 (the exact two-pass softmax) or K5 (flash), whichever kernel the
    JAX package runs for the shape,
  * PE's and EVA02's 2-D axial RoPE (half-split pairs, tables from
    :func:`_rope2d_tables`, the identity on a cls row) inside K1/K4, or as
    :func:`_apply_rope` on the XLA-style path the calibration forward runs,
  * int8_static blocks through the layernorm+quantize kernel K2
    (ops/quant_kernel.py; EVA02's attention sub-LN too) and int8 matmuls
    with float32 epilogues; where :func:`int8_wire_enabled` says so
    (SO400M-384, or every tower under ``CTPU_INT8_WIRE=1``) and the wire
    kernel's gate takes the shape, the int8 attention wire with K3; under
    ``CTPU_LN_KERNEL=0``, at a width that 128 does not divide, or for a
    post-norm tower, the generic block with static scales
    (:func:`block_route`),
  * dynamic-int8 blocks (compute_dtype "int8") in the three forms the JAX
    package selects with ``CTPU_INT8_BLOCK`` (:func:`block_route`): the
    generic block with dynamic ``q_matmul`` (or K9 under
    ``CTPU_FUSED_QMATMUL=1``), K1's ``quant_out`` (``xla``), or K6's
    ln/gelu + quantize passes with K1's ``quant_out`` (``hybrid``),
  * the readouts: the cls row (CLIP, EVA), SigLIP's MAP head (probe
    attention + residual MLP, no projection), PE's attention pool (probe
    attention + layernorm, then the projection), CLIPA's mean of the patch
    tokens with ln_post after the pool, and CoCa's attentional pooler (query
    0 of its learned queries; ln_post and a [e, e] projection on the pooled
    dim).

The module holds the JAX package's parameters leaf for leaf (same names, the
same ``[in, out]`` kernels), one ``VitBlock`` per layer instead of the stacked
``[L, …]`` leaves; ``models/clip_weights.py`` carries weights across. Tokens
are not padded: the kernels take any sequence length and mask the ragged
tail themselves. With ``debug_nans`` the forward checks every block's output
and the readout and raises ``FloatingPointError`` at the first NaN.
"""
from __future__ import annotations

import dataclasses
import functools
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_assisted_data_labeling_tpu_torch.config import (
    CLIP_MEAN,
    CLIP_STD,
    SIGLIP_MEAN,
    SIGLIP_STD,
)
from clip_assisted_data_labeling_tpu_torch.models.convnext import (
    _CNX_ARCHS,
    CNXConfig,
    resolve_cnx_config,
)
from clip_assisted_data_labeling_tpu_torch.models.resnet import _RN_ARCHS, RNConfig, resolve_rn_config
from clip_assisted_data_labeling_tpu_torch.ops import knobs
from clip_assisted_data_labeling_tpu_torch.ops.activations import gelu_tanh
from clip_assisted_data_labeling_tpu_torch.ops.attention import (
    _rot_half,
    attention_xla,
    fused_attention_packed,
    fused_attention_packed_q8s,
    grouped_attention_fits,
    packed_attention_auto,
    packed_attention_fits,
    packed_q8s_fits,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant import q_matmul, quant_static
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    q_matmul_pre,
    rowquant,
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
    act: str = "quick_gelu"  # OpenAI; open-data "gelu"; SigLIP "gelu_tanh"
    ln_eps: float = 1e-5
    use_cls_token: bool = True
    use_rope2d: bool = False  # PE: 2-D axial rotary embeddings on q/k in every block
    rope_theta: float = 10000.0
    # 'cls' (CLIP, EVA) | 'attn' (PE probe) | 'map' (SigLIP MAP head) |
    # 'avg' (CLIPA: mean of the patch tokens) | 'coca' (CoCa's pooler, query 0)
    pool: str = "cls"
    attn_pooler_heads: int = 8
    n_pool_queries: int = 1  # CoCa pooler query rows (readout = query 0 only)
    use_ln_pre: bool = True  # SigLIP, EVA and CLIPA towers have no ln_pre
    use_proj: bool = True  # SigLIP's embedding IS the pooled width (no proj)
    patch_bias: bool = False  # SigLIP's and EVA's patch convs have a bias term
    norm_mean: tuple = CLIP_MEAN
    norm_std: tuple = CLIP_STD
    # EVA02: 'swiglu' = silu(w1·x) ⊙ (w2·x) → ffn sub-LN → w3, with w1‖w2
    # packed into one [w, 2·mlp_hidden] fc1
    mlp_type: str = "mlp"
    attn_inner_ln: bool = False  # EVA02's sub-LN on the attention heads' output
    block_norm: str = "pre"  # 'post' (EVA02-E): x + ln(sublayer(x))
    # SigLIP2 naflex: image_size = 16·patch, so the square crops fill the
    # whole 16×16 positional grid; native-aspect inputs take models/naflex.py
    naflex: bool = False

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + (1 if self.use_cls_token else 0)

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
    # tiny configs for tests (not real pretrained models)
    "ViT-Test/tiny": VitConfig(
        width=64, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=16
    ),
    "ViT-Test2/tiny": VitConfig(
        width=48, layers=2, heads=4, patch_size=8, image_size=24, embed_dim=24
    ),
    "ViT-Test-HF/tiny": VitConfig(
        width=64, layers=3, heads=4, patch_size=8, image_size=32, embed_dim=16
    ),
}
for _arch, _kw in _ARCHS.items():
    MODEL_REGISTRY[f"{_arch}/openai"] = VitConfig(**_kw, **_OPENAI)
    for _tag in _OPEN_TAGS:
        MODEL_REGISTRY[f"{_arch}/{_tag}"] = VitConfig(**_kw, **_OPEN)

# Meta's Perception Encoder cores, named without a pretrained tag: 2-D axial
# RoPE on q/k in every block, GELU MLPs, and a probe attention pool (probe
# MHA + layernorm, then the projection) instead of the cls readout; G14 also
# drops the class token and widens the MLP to 8960.
_PE = dict(act="gelu", use_rope2d=True, pool="attn", attn_pooler_heads=8)
_PE_ARCHS = {
    "PE-Core-B16-224": dict(width=768, layers=12, heads=12, patch_size=16,
                            image_size=224, embed_dim=1024, **_PE),
    "PE-Core-L14-336": dict(width=1024, layers=24, heads=16, patch_size=14,
                            image_size=336, embed_dim=1024, **_PE),
    "PE-Core-G14-448": dict(width=1536, layers=50, heads=16, patch_size=14,
                            image_size=448, embed_dim=1280, mlp_hidden=8960,
                            use_cls_token=False, **_PE),
}
for _arch, _kw in _PE_ARCHS.items():
    MODEL_REGISTRY[_arch] = VitConfig(**_kw)
# tiny PE config for tests (RoPE + attention pool, no cls token)
MODEL_REGISTRY["PE-Test/tiny"] = VitConfig(
    width=64, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=16,
    act="gelu", use_rope2d=True, pool="attn", attn_pooler_heads=2,
    use_cls_token=False)

# SigLIP vision towers (open_clip '*-SigLIP*' archs / HF SiglipVisionModel):
# no class token, no pre-transformer layernorm, a patch conv with bias,
# tanh-approximate GELU, the MAP head instead of the cls readout, no output
# projection (embedding dim == width), 0.5/0.5 normalization.
_SIGLIP = dict(act="gelu_tanh", use_cls_token=False, use_ln_pre=False,
               use_proj=False, patch_bias=True, pool="map", ln_eps=1e-6,
               norm_mean=SIGLIP_MEAN, norm_std=SIGLIP_STD)
_SIGLIP_ARCHS = {
    "ViT-B-16-SigLIP": dict(width=768, layers=12, heads=12, patch_size=16,
                            image_size=224, embed_dim=768,
                            attn_pooler_heads=12, **_SIGLIP),
    "ViT-B-16-SigLIP-384": dict(width=768, layers=12, heads=12, patch_size=16,
                                image_size=384, embed_dim=768,
                                attn_pooler_heads=12, **_SIGLIP),
    "ViT-L-16-SigLIP-256": dict(width=1024, layers=24, heads=16, patch_size=16,
                                image_size=256, embed_dim=1024,
                                attn_pooler_heads=16, **_SIGLIP),
    "ViT-L-16-SigLIP-384": dict(width=1024, layers=24, heads=16, patch_size=16,
                                image_size=384, embed_dim=1024,
                                attn_pooler_heads=16, **_SIGLIP),
    # the shape-optimized SoViT-400M tower: mlp 4304 (not 4x), head_dim 72
    "ViT-SO400M-14-SigLIP-384": dict(width=1152, layers=27, heads=16,
                                     patch_size=14, image_size=384,
                                     embed_dim=1152, mlp_hidden=4304,
                                     attn_pooler_heads=16, **_SIGLIP),
}
for _arch, _kw in _SIGLIP_ARCHS.items():
    MODEL_REGISTRY[f"{_arch}/webli"] = VitConfig(**_kw)
# tiny SigLIP configs for tests; the ragged one (36 = 4·8 + 4) has the
# SO400M-14 @384 geometry class, where the trailing pixels go unread
MODEL_REGISTRY["SigLIP-Test/tiny"] = VitConfig(
    width=64, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=64,
    attn_pooler_heads=4, mlp_hidden=224, **_SIGLIP)
MODEL_REGISTRY["SigLIP-Test-Ragged/tiny"] = VitConfig(
    width=64, layers=2, heads=4, patch_size=8, image_size=36, embed_dim=64,
    attn_pooler_heads=4, mlp_hidden=224, **_SIGLIP)

# tiny naflex config for tests (4×4 positional grid)
MODEL_REGISTRY["SigLIP2-Naflex-Test/tiny"] = VitConfig(
    width=64, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=64,
    attn_pooler_heads=4, mlp_hidden=224, naflex=True, **_SIGLIP)

# EVA family (open_clip 'EVA01-g-14' / 'EVA02-{B,L}-…' / 'EVA02-E-14', BAAI
# EVA-CLIP). EVA02's trunk: 2-D RoPE on q/k on top of the learned position
# embedding (identity on the cls row), a SwiGLU MLP with an ffn sub-LN, a
# sub-LN on the attention output, q/k/v with no k bias, no ln_pre, a biased
# patch conv, LN eps 1e-6. EVA01-g: the same checkpoint dialect with plain
# MLP blocks and no RoPE or sub-LN. EVA02-E: EVA01-style blocks in post-norm
# form. The '-plus' tiers widen only the text tower.
_EVA02 = dict(act="gelu", use_ln_pre=False, patch_bias=True, mlp_type="swiglu",
              attn_inner_ln=True, use_rope2d=True, ln_eps=1e-6)
_EVA_ARCHS = {
    "EVA01-g-14": dict(width=1408, layers=40, heads=16, patch_size=14, image_size=224,
                       embed_dim=1024, mlp_hidden=6144, act="gelu", use_ln_pre=False,
                       patch_bias=True, ln_eps=1e-6),
    "EVA02-B-16": dict(width=768, layers=12, heads=12, patch_size=16, image_size=224,
                       embed_dim=512, mlp_hidden=2048, **_EVA02),
    "EVA02-L-14": dict(width=1024, layers=24, heads=16, patch_size=14, image_size=224,
                       embed_dim=768, mlp_hidden=2730, **_EVA02),
    "EVA02-L-14-336": dict(width=1024, layers=24, heads=16, patch_size=14, image_size=336,
                           embed_dim=768, mlp_hidden=2730, **_EVA02),
    "EVA02-E-14": dict(width=1792, layers=64, heads=16, patch_size=14, image_size=224,
                       embed_dim=1024, mlp_hidden=15360, act="gelu", use_ln_pre=False,
                       patch_bias=True, ln_eps=1e-6, block_norm="post"),
}
_EVA_ARCHS["EVA01-g-14-plus"] = _EVA_ARCHS["EVA01-g-14"]
_EVA_ARCHS["EVA02-E-14-plus"] = _EVA_ARCHS["EVA02-E-14"]
# tiny EVA configs for tests: EVA02 (swiglu, sub-LNs, RoPE with a cls token);
# width 128, which the int8_static lnk route takes; post-norm (EVA02-E's block)
MODEL_REGISTRY["EVA-Test/tiny"] = VitConfig(
    width=64, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=16,
    mlp_hidden=112, **_EVA02)
MODEL_REGISTRY["EVA-Test-Wide/tiny"] = VitConfig(
    width=128, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=16,
    mlp_hidden=224, **_EVA02)
MODEL_REGISTRY["EVA-Test-Post/tiny"] = VitConfig(
    width=64, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=16,
    mlp_hidden=112, act="gelu", use_ln_pre=False, patch_bias=True, ln_eps=1e-6,
    block_norm="post")

# open_clip CoCa vision towers: a pre-LN CLIP trunk read out by the legacy
# AttentionalPooler (n_pool_queries learned queries in embed_dim attending
# over the ln_k'd tokens with separate q/k/v projections), then ln_post over
# the pooled dim and an [e, e] projection. The contrastive embedding is
# query 0's row; softmax rows are independent, so computing it alone is exact.
_COCA = dict(act="gelu", pool="coca", attn_pooler_heads=8, n_pool_queries=256)
_COCA_ARCHS = {
    "coca_ViT-B-32": dict(width=768, layers=12, heads=12, patch_size=32, image_size=224,
                          embed_dim=512, **_COCA),
    "coca_ViT-L-14": dict(width=1024, layers=24, heads=16, patch_size=14, image_size=224,
                          embed_dim=768, **_COCA),
    "coca_base": dict(width=768, layers=12, heads=12, patch_size=18, image_size=288,
                      embed_dim=512, **_COCA),
}
_COCA_ARCHS["coca_roberta-ViT-B-32"] = _COCA_ARCHS["coca_ViT-B-32"]
# tiny CoCa config for tests (an odd query count catches row-0 selection bugs)
MODEL_REGISTRY["CoCa-Test/tiny"] = VitConfig(
    width=64, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=16,
    mlp_hidden=128, act="gelu", pool="coca", attn_pooler_heads=4, n_pool_queries=7)

# CLIPA vision towers: no ln_pre, and the readout is the mean of the patch
# tokens (the cls row computed but left out) with ln_post after the pool
_CLIPA = dict(act="gelu", use_ln_pre=False, pool="avg")
_CLIPA_ARCHS = {
    "ViT-L-14-CLIPA": dict(width=1024, layers=24, heads=16, patch_size=14, image_size=224,
                           embed_dim=768, **_CLIPA),
    "ViT-L-14-CLIPA-336": dict(width=1024, layers=24, heads=16, patch_size=14,
                               image_size=336, embed_dim=768, **_CLIPA),
    "ViT-H-14-CLIPA": dict(width=1280, layers=32, heads=16, patch_size=14, image_size=224,
                           embed_dim=1024, **_CLIPA),
    "ViT-H-14-CLIPA-336": dict(width=1280, layers=32, heads=16, patch_size=14,
                               image_size=336, embed_dim=1024, **_CLIPA),
    "ViT-bigG-14-CLIPA": dict(width=1664, layers=48, heads=16, patch_size=14,
                              image_size=224, embed_dim=1280, mlp_hidden=8192, **_CLIPA),
    "ViT-bigG-14-CLIPA-336": dict(width=1664, layers=48, heads=16, patch_size=14,
                                  image_size=336, embed_dim=1280, mlp_hidden=8192, **_CLIPA),
}
MODEL_REGISTRY["CLIPA-Test/tiny"] = VitConfig(
    width=64, layers=2, heads=4, patch_size=8, image_size=32, embed_dim=16, **_CLIPA)

# open_clip's NLLB-CLIP combos: NLLB text encoder + a stock vision trunk
_NLLB_VISION = {
    "nllb-clip-base": "ViT-B-32",
    "nllb-clip-large": "ViT-H-14",
    "nllb-clip-base-siglip": "ViT-B-16-SigLIP-384",
    "nllb-clip-large-siglip": "ViT-SO400M-14-SigLIP-384",
}

# trunk dims shared by every SigLIP/SigLIP2 tower of a size family
_SIGLIP_FAMS = {
    "B": dict(width=768, layers=12, heads=12, mlp_hidden=3072, attn_pooler_heads=12),
    "L": dict(width=1024, layers=24, heads=16, mlp_hidden=4096, attn_pooler_heads=16),
    "SO400M": dict(width=1152, layers=27, heads=16, mlp_hidden=4304, attn_pooler_heads=16),
    "gopt": dict(width=1536, layers=40, heads=16, mlp_hidden=6144, attn_pooler_heads=16),
}


def _parse_siglip_name(arch: str) -> VitConfig | None:
    """'ViT-{fam}-{patch}-SigLIP[2][-i18n][-{res}|-naflex]' → config (default
    res 224), as the JAX package parses it. A naflex tower's image_size is
    16·patch, so the square crops fill its whole 16×16 positional grid."""
    m = re.fullmatch(
        r"ViT-(B|L|SO400M|gopt)-(\d+)-SigLIP2?(?:-i18n)?(?:-(\d+|naflex))?", arch)
    if m is None:
        return None
    fam = _SIGLIP_FAMS[m.group(1)]
    patch = int(m.group(2))
    if m.group(3) == "naflex":
        return VitConfig(patch_size=patch, image_size=16 * patch, naflex=True,
                         embed_dim=fam["width"], **fam, **_SIGLIP)
    res = int(m.group(3)) if m.group(3) else 224
    return VitConfig(patch_size=patch, image_size=res, embed_dim=fam["width"], **fam,
                     **_SIGLIP)


# trunk dims shared by every plain-ViT tower of a size family (open_clip
# model_configs): 'B-plus' is the wide-B tier, '-alt' the narrow-joint-space
# S/M tier, 'e' ViT-e-14 (head width 112, mlp 15360)
_VIT_FAMS = {
    "S": dict(width=384, layers=12, heads=6, embed_dim=384),
    "S-alt": dict(width=384, layers=12, heads=6, embed_dim=256),
    "M": dict(width=512, layers=12, heads=8, embed_dim=512),
    "M-alt": dict(width=512, layers=12, heads=8, embed_dim=384),
    "B": dict(width=768, layers=12, heads=12, embed_dim=512),
    "B-plus": dict(width=896, layers=12, heads=14, embed_dim=640),
    "L": dict(width=1024, layers=24, heads=16, embed_dim=768),
    "H": dict(width=1280, layers=32, heads=16, embed_dim=1024),
    "g": dict(width=1408, layers=40, heads=16, embed_dim=1024, mlp_hidden=6144),
    "bigG": dict(width=1664, layers=48, heads=16, embed_dim=1280, mlp_hidden=8192),
    "e": dict(width=1792, layers=56, heads=16, embed_dim=1280, mlp_hidden=15360),
}


def _parse_vit_name(arch: str) -> VitConfig | None:
    """'ViT-{fam}[-plus|-alt]-{patch}[-{res}]' → config (default res 224):
    the plain-ViT geometry names no table lists ('ViT-B-16-plus-240',
    'ViT-H-14-378', 'ViT-S-16-alt', 'ViT-e-14', …), as the JAX
    ``_parse_vit_name`` (models/vit.py:443) reads them."""
    m = re.fullmatch(r"ViT-(S|M|B|L|H|g|bigG|e)-(\d+)(-plus|-alt)?(?:-(\d+))?", arch)
    if m is None:
        return None
    famkey = m.group(1) + (m.group(3) or "")
    if famkey not in _VIT_FAMS:
        return None
    res = int(m.group(4)) if m.group(4) else 224
    return VitConfig(patch_size=int(m.group(2)), image_size=res, **_VIT_FAMS[famkey])


def resolve_config(model_name: str) -> VitConfig | RNConfig | CNXConfig:
    """The tower of an 'Arch/pretrained' or 'PE-…' name, as the JAX
    ``resolve_config`` (models/vit.py:468-571) resolves it: the registry,
    then (after the NLLB-CLIP alias, a '-quickgelu' suffix, which pins the
    OpenAI activation, and a multilingual text-tower prefix) the SigLIP
    families, the modified-ResNet and ConvNeXt towers (``models/resnet``,
    ``models/convnext``: an RNConfig or CNXConfig, which '-quickgelu' leaves
    as it is — the suffix only changes open_clip's text side there), then
    the EVA, CoCa, CLIPA and plain-ViT families. 'hf-hub:' names, the
    MobileCLIP/ViTamin families and unknown names raise the JAX package's
    errors."""
    if model_name in MODEL_REGISTRY:
        return MODEL_REGISTRY[model_name]
    if model_name.startswith("hf-hub:"):
        # open_clip downloads such checkpoints; this framework never does
        raise ValueError(
            f"{model_name}: hf-hub references download weights, which this framework "
            "never does. Use the architecture name (e.g. 'ViT-L-14/openai') plus "
            "--model_path <dir-with-local-checkpoint> — the converter accepts HF and "
            "open_clip layouts."
        )
    arch = model_name.split("/", 1)[0]
    arch = _NLLB_VISION.get(arch, arch)
    force_quick_gelu = arch.endswith("-quickgelu")
    if force_quick_gelu:
        arch = arch[: -len("-quickgelu")]
    # a multilingual combo's vision tower is the plain ViT after the text
    # prefix ('xlm-roberta-base-ViT-B-32'); CoCa keeps its own dispatch
    if "-ViT-" in arch and not arch.startswith("coca"):
        arch = arch[arch.index("ViT-"):]

    def finish(cfg: VitConfig) -> VitConfig:
        return dataclasses.replace(cfg, act="quick_gelu") if force_quick_gelu else cfg

    if arch in _SIGLIP_ARCHS:
        return finish(VitConfig(**_SIGLIP_ARCHS[arch]))
    sig = _parse_siglip_name(arch)
    if sig is not None:
        return finish(sig)
    conv = resolve_rn_config(arch) or resolve_cnx_config(arch)
    if conv is not None:
        return conv
    for table in (_EVA_ARCHS, _COCA_ARCHS, _CLIPA_ARCHS):
        if arch in table:
            return finish(VitConfig(**table[arch]))
    base = VitConfig(**_ARCHS[arch]) if arch in _ARCHS else _parse_vit_name(arch)
    if base is not None:
        quick = force_quick_gelu or model_name.endswith("/openai")
        return dataclasses.replace(base, act="quick_gelu" if quick else "gelu")
    if arch.startswith(("MobileCLIP", "ViTamin")):
        raise ValueError(
            f"{model_name}: recognized open_clip family '{arch.split('-')[0]}' is not "
            "implemented (timm-wrapped hybrid conv tower; see ROADMAP.md). Every other "
            "published open_clip vision tower resolves."
        )
    known = [a for table in (_ARCHS, _SIGLIP_ARCHS, _PE_ARCHS, _EVA_ARCHS, _COCA_ARCHS,
                             _CLIPA_ARCHS, _NLLB_VISION, _RN_ARCHS, _CNX_ARCHS)
             for a in sorted(table)]
    raise ValueError(
        f"Unknown model format: {model_name}. Expected 'PE-…' or 'Arch/pretrained' (any "
        "'-quickgelu'-suffixed alias or 'ViT-{S,M,B[-plus|-alt],L,H,g,bigG,e}-{patch}"
        f"[-{{res}}]' geometry name also resolves) with Arch in {known}."
    )


def int8_wire_enabled(cfg: VitConfig, wire: bool | None = None) -> bool:
    """Whether int8_static calibrates and attaches the int8 attention wire's
    per-channel ``qkv_amax`` for this tower. ``wire`` forces it; None follows
    ``CTPU_INT8_WIRE`` (``ops/knobs.INT8_WIRE``) as the JAX package's
    ``int8_wire_enabled`` (models/vit.py:574-601) does: ``on`` for every
    tower, RoPE towers too; ``off`` for none; ``auto`` exactly where the
    non-wire route would fall to the flash kernel (neither the whole-block
    nor the grouped gate takes the shape) while the wire kernel's gate does —
    SO400M-384 — and never for a RoPE tower (K3 has no rotation).
    :func:`block_route` then takes the wire only without RoPE and where the
    wire kernel's gate holds."""
    if wire is not None:
        return bool(wire)
    if knobs.INT8_WIRE == "on":
        return True
    if knobs.INT8_WIRE == "off" or cfg.use_rope2d:
        return False
    s, w, h = cfg.seq_len, cfg.width, cfg.heads
    if packed_attention_fits(s, w, 2) or grouped_attention_fits(s, w, h, 2):
        return False
    return packed_q8s_fits(s, w, h)


def init_vit_params(cfg: VitConfig, generator: torch.Generator,
                    device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Random-init flat parameter dict (open_clip-style scaled normal init) in
    the JAX package's key layout: ``blocks/<name>`` leaves stacked ``[L, …]``;
    the sub-LNs, cls token, ln_pre, proj, patch bias, RoPE marker and pool
    leaves as the config asks (JAX ``init_vit_params``)."""
    w, L, e, mlp = cfg.width, cfg.layers, cfg.embed_dim, cfg.mlp_dim
    fc1 = 2 * mlp if cfg.mlp_type == "swiglu" else mlp
    scale = w ** -0.5

    def nrm(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    def ones(shape):
        return torch.ones(shape, device=device)

    def zeros(shape):
        return torch.zeros(shape, device=device)

    params = {
        "patch_kernel": nrm((cfg.patch_size * cfg.patch_size * 3, w), scale),
        "pos_emb": nrm((cfg.seq_len, w), scale),
        "blocks/ln1_scale": ones((L, w)),
        "blocks/ln1_bias": zeros((L, w)),
        "blocks/qkv_kernel": nrm((L, w, 3 * w), scale),
        "blocks/qkv_bias": zeros((L, 3 * w)),
        "blocks/out_kernel": nrm((L, w, w), scale),
        "blocks/out_bias": zeros((L, w)),
        "blocks/ln2_scale": ones((L, w)),
        "blocks/ln2_bias": zeros((L, w)),
        # swiglu packs w1‖w2 into one [w, 2·mlp] fc1
        "blocks/fc1_kernel": nrm((L, w, fc1), (2 * w) ** -0.5),
        "blocks/fc1_bias": zeros((L, fc1)),
        "blocks/fc2_kernel": nrm((L, mlp, w), scale),
        "blocks/fc2_bias": zeros((L, w)),
        "ln_post_scale": ones((w,)),
        "ln_post_bias": zeros((w,)),
    }
    if cfg.attn_inner_ln:
        params["blocks/attn_ln_scale"] = ones((L, w))
        params["blocks/attn_ln_bias"] = zeros((L, w))
    if cfg.mlp_type == "swiglu":
        params["blocks/ffn_ln_scale"] = ones((L, mlp))
        params["blocks/ffn_ln_bias"] = zeros((L, mlp))
    if cfg.use_cls_token:
        params["class_emb"] = nrm((w,), scale)
    if cfg.use_ln_pre:
        params["ln_pre_scale"] = ones((w,))
        params["ln_pre_bias"] = zeros((w,))
    if cfg.use_proj:  # CoCa's acts on the pooled dim: [e, e]
        params["proj"] = nrm((e if cfg.pool == "coca" else w, e), scale)
    if cfg.patch_bias:
        params["patch_bias"] = zeros((w,))
    if cfg.use_rope2d:
        # random weights have no pairing convention: mark them half-split so
        # a save/load round trip skips the legacy-checkpoint upgrade
        params["rope_half"] = torch.ones((), dtype=torch.int8, device=device)
    if cfg.pool in ("attn", "map"):
        # the probe MHA + layernorm shared by PE's pool and SigLIP's MAP head
        params.update({
            "pool_probe": nrm((w,), 0.02),
            "pool_in_kernel": nrm((w, 3 * w), scale),
            "pool_in_bias": zeros((3 * w,)),
            "pool_out_kernel": nrm((w, w), scale),
            "pool_out_bias": zeros((w,)),
            "pool_ln_scale": ones((w,)),
            "pool_ln_bias": zeros((w,)),
        })
    if cfg.pool == "map":
        params.update({
            "pool_fc1_kernel": nrm((w, mlp), (2 * w) ** -0.5),
            "pool_fc1_bias": zeros((mlp,)),
            "pool_fc2_kernel": nrm((mlp, w), scale),
            "pool_fc2_bias": zeros((w,)),
        })
    if cfg.pool == "coca":
        # the AttentionalPooler: queries in e, keys and values projected
        # w → e; ln_post acts on the pooled dim
        params.update({
            "pool_query": nrm((cfg.n_pool_queries, e), 0.02),
            "pool_q_kernel": nrm((e, e), e ** -0.5),
            "pool_k_kernel": nrm((w, e), scale),
            "pool_v_kernel": nrm((w, e), scale),
            "pool_in_bias": zeros((3 * e,)),
            "pool_out_kernel": nrm((e, e), e ** -0.5),
            "pool_out_bias": zeros((e,)),
            "pool_lnq_scale": ones((e,)),
            "pool_lnq_bias": zeros((e,)),
            "pool_lnk_scale": ones((w,)),
            "pool_lnk_bias": zeros((w,)),
            "ln_post_scale": ones((e,)),
            "ln_post_bias": zeros((e,)),
        })
    return params


class VitBlock(nn.Module):
    """One transformer block's leaves as buffers. Quantized kernels are int8
    stored ``[out, in]`` (the layout ``torch._int_mm`` takes) beside their
    per-output-channel ``*_scale``; ``act_amax`` [4] is attached by
    :func:`attach_act_amax` and selects the int8_static path, and a
    per-channel ``qkv_amax`` [3w] beside it selects the int8 attention wire."""

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

    @property
    def wire(self) -> bool:
        return hasattr(self, "qkv_amax")


class VisionTransformer(nn.Module):
    """The ViT image tower: stem and readout leaves + ``blocks`` (one VitBlock
    per layer). Build it from a flat parameter dict with
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


def _sigmoid_xla(z):
    """The sigmoid as XLA expands it: 1 / (1 + exp(-z)), each step rounded
    to z's dtype (in bf16 torch.sigmoid's single rounding differs on ~1/3 of
    elements)."""
    return 1.0 / (1.0 + torch.exp(-z))


def _silu(x):
    """EVA02's swiglu gate x·sigmoid(x) (``jax.nn.silu``)."""
    return x * _sigmoid_xla(x)


def _act(x, kind: str, quantized: bool = False):
    if kind == "quick_gelu":
        # OpenAI CLIP's x * sigmoid(1.702 x) in x's dtype
        z = torch.tensor(1.702, dtype=x.dtype, device=x.device) * x
        return x * _sigmoid_xla(z)
    if kind == "gelu_tanh" or quantized:
        # int8 paths take the tanh form of gelu: its <=1e-3 absolute error is
        # far below the int8 step the output suffers next
        return gelu_tanh(x)
    return F.gelu(x, approximate="none")


def _linear(x, blk: VitBlock, name: str, residual=None, act_amax=None):
    """Block matmul: float (x @ W + b in x's dtype) or, for a quantized block,
    W8A8 — with a calibrated per-tensor ``act_amax`` the static quantize,
    then the int8 product over it with ``act_amax·(1/127)`` as the row scale
    and the residual inside the float32 epilogue (JAX ``_linear``,
    models/vit.py:841-861); without it dynamic per-row (dynamic int8, and the
    calibration forward)."""
    bias = getattr(blk, name.replace("_kernel", "_bias"))
    if blk.quantized and act_amax is not None:
        wq_t = getattr(blk, name)
        lead, n = x.shape[:-1], wq_t.shape[0]
        xq = quant_static(x, act_amax).reshape(-1, x.shape[-1])
        res = None if residual is None else residual.reshape(-1, n)
        y = q_matmul_pre(xq, act_amax * (1.0 / 127.0), wq_t, getattr(blk, name + "_scale"),
                         bias, residual=res, out_dtype=x.dtype)
        return y.reshape(lead + (n,))
    if blk.quantized:
        return q_matmul(x, getattr(blk, name), getattr(blk, name + "_scale"), bias,
                        out_dtype=x.dtype, residual=residual)
    y = x @ getattr(blk, name).to(x.dtype) + bias.to(x.dtype)
    return y if residual is None else residual + y


def _swiglu_hidden(h, blk: VitBlock, cfg: VitConfig):
    """EVA02's gate on the packed fc1 output: silu(h1) ⊙ h2, then the ffn
    sub-LN (JAX models/vit.py:1179-1185)."""
    h1, h2 = h.chunk(2, dim=-1)
    return _layernorm(_silu(h1) * h2, blk.ffn_ln_scale, blk.ffn_ln_bias, cfg.ln_eps)


def _block_generic(x, blk: VitBlock, cfg: VitConfig, rope=None):
    """One block in float32 or bfloat16, in dynamic int8 (quantized weights,
    bf16 compute, every matmul a dynamic ``q_matmul``) or in int8_static with
    static scales (each matmul's input quantized with its calibrated
    ``act_amax``, the fc2 residual inside its epilogue), with the packed
    attention kernel the JAX package's routing picks (K1, K4 or K5), RoPE
    inside it, as the JAX package's generic block (models/vit.py:1124-1196):
    pre-LN, or EVA02-E's post-norm (ln1 and ln2 on the sublayer outputs
    before the residual adds; no fc2 residual epilogue); EVA02's attention
    sub-LN and its SwiGLU MLP, whose two matmuls quantize dynamically even in
    int8_static, as in the JAX package. The other residual adds run outside
    the matmuls, in x's dtype, and int8 blocks take the tanh gelu."""
    a = blk.act_amax if blk.static else None
    post = cfg.block_norm == "post"
    y = x if post else _layernorm(x, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
    qkv = _linear(y, blk, "qkv_kernel", act_amax=None if a is None else a[0])
    attn = packed_attention_auto(qkv, heads=cfg.heads, scale=cfg.head_dim ** -0.5, rope=rope)
    if cfg.attn_inner_ln:
        attn = _layernorm(attn, blk.attn_ln_scale, blk.attn_ln_bias, cfg.ln_eps)
    attn_out = _linear(attn, blk, "out_kernel", act_amax=None if a is None else a[1])
    if post:
        attn_out = _layernorm(attn_out, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
    x = x + attn_out
    y = x if post else _layernorm(x, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
    if cfg.mlp_type == "swiglu":
        return x + _linear(_swiglu_hidden(_linear(y, blk, "fc1_kernel"), blk, cfg), blk,
                           "fc2_kernel")
    y = _act(_linear(y, blk, "fc1_kernel", act_amax=None if a is None else a[2]), cfg.act,
             quantized=blk.quantized)
    if post:
        mlp_out = _linear(y, blk, "fc2_kernel", act_amax=None if a is None else a[3])
        return x + _layernorm(mlp_out, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
    if a is not None:
        return _linear(y, blk, "fc2_kernel", residual=x, act_amax=a[3])
    return x + _linear(y, blk, "fc2_kernel")


def _block_int8_xla(x, blk: VitBlock, cfg: VitConfig):
    """Dynamic-int8 block with K1's ``quant_out`` (JAX ``_block_int8_xla``,
    models/vit.py:1048): dynamic ``q_matmul`` for qkv, fc1 and fc2; the out
    projection over K1's int8 output and per-token scales with the residual
    in its float32 epilogue; ln1 and ln2 as plain layernorms; tanh gelu."""
    B, S, w = x.shape
    y = _layernorm(x, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
    qkv = q_matmul(y, blk.qkv_kernel, blk.qkv_kernel_scale, blk.qkv_bias, out_dtype=x.dtype)
    attn_q, attn_s = fused_attention_packed(qkv, cfg.heads, cfg.head_dim ** -0.5,
                                            quant_out=True)
    x = q_matmul_pre(attn_q.reshape(B * S, w), attn_s.reshape(B * S, 1), blk.out_kernel,
                     blk.out_kernel_scale, blk.out_bias,
                     residual=x.reshape(B * S, w)).reshape(B, S, w)
    y = _layernorm(x, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
    y = _act(q_matmul(y, blk.fc1_kernel, blk.fc1_kernel_scale, blk.fc1_bias, out_dtype=x.dtype),
             cfg.act, quantized=True)
    return x + q_matmul(y, blk.fc2_kernel, blk.fc2_kernel_scale, blk.fc2_bias,
                        out_dtype=x.dtype)


def _block_int8_fused(x, blk: VitBlock, cfg: VitConfig):
    """Dynamic-int8 "hybrid" block (JAX ``_block_int8_fused``,
    models/vit.py:870): K6 for ln1 + quantize, ln2 + quantize and gelu +
    quantize (the activation in float32, erf for the gelu towers); int8
    matmuls over pre-quantized rows with bf16 outputs and the residuals in
    the out-projection and fc2 epilogues; K1 with ``quant_out``."""
    B, S, w = x.shape
    x2 = x.reshape(B * S, w)
    xq, xs = rowquant(x2, blk.ln1_scale, blk.ln1_bias, ln_eps=cfg.ln_eps)
    qkv = q_matmul_pre(xq, xs, blk.qkv_kernel, blk.qkv_kernel_scale, blk.qkv_bias)
    attn_q, attn_s = fused_attention_packed(qkv.reshape(B, S, 3 * w), cfg.heads,
                                            cfg.head_dim ** -0.5, quant_out=True)
    x2 = q_matmul_pre(attn_q.reshape(B * S, w), attn_s.reshape(B * S, 1), blk.out_kernel,
                      blk.out_kernel_scale, blk.out_bias, residual=x2)
    hq, hs = rowquant(x2, blk.ln2_scale, blk.ln2_bias, ln_eps=cfg.ln_eps)
    h = q_matmul_pre(hq, hs, blk.fc1_kernel, blk.fc1_kernel_scale, blk.fc1_bias)
    gq, gs = rowquant(h, act=cfg.act)
    x2 = q_matmul_pre(gq, gs, blk.fc2_kernel, blk.fc2_kernel_scale, blk.fc2_bias, residual=x2)
    return x2.reshape(B, S, w)


def _block_int8_static_lnk(x, blk: VitBlock, cfg: VitConfig, rope=None):
    """int8_static block: layernorm + static quantize in one kernel (K2) for
    ln1 and ln2, int8 matmuls with float32 epilogues, packed attention (K1, K4
    or K5, RoPE inside it) on the bfloat16 qkv, tanh-gelu. EVA02's attention
    sub-LN is K2 too, with a[1] (calibrated after the LN); its swiglu hidden
    (ragged: 2730 for EVA02-L) takes the plain layernorm, then the static
    quantize inside fc2. Same op order and residual placement as the JAX
    package's ``_block_int8_static_lnk`` (models/vit.py:968-1023)."""
    B, S, w = x.shape
    a = blk.act_amax
    inv127 = 1.0 / 127.0
    x2 = x.reshape(B * S, w)
    xq = rowquant_static(x2, blk.ln1_scale, blk.ln1_bias, a[0:1], ln_eps=cfg.ln_eps)
    qkv = q_matmul_pre(xq, a[0] * inv127, blk.qkv_kernel, blk.qkv_kernel_scale,
                       blk.qkv_bias)
    attn = packed_attention_auto(qkv.reshape(B, S, 3 * w), heads=cfg.heads,
                                 scale=cfg.head_dim ** -0.5, rope=rope).reshape(B * S, w)
    if cfg.attn_inner_ln:
        attn_q = rowquant_static(attn, blk.attn_ln_scale, blk.attn_ln_bias, a[1:2],
                                 ln_eps=cfg.ln_eps)
        x2 = x2 + q_matmul_pre(attn_q, a[1] * inv127, blk.out_kernel, blk.out_kernel_scale,
                               blk.out_bias, out_dtype=x.dtype)
    else:
        x2 = x2 + _linear(attn, blk, "out_kernel", act_amax=a[1])
    hq = rowquant_static(x2, blk.ln2_scale, blk.ln2_bias, a[2:3], ln_eps=cfg.ln_eps)
    h = q_matmul_pre(hq, a[2] * inv127, blk.fc1_kernel, blk.fc1_kernel_scale, blk.fc1_bias)
    if cfg.mlp_type == "swiglu":
        g = _swiglu_hidden(h, blk, cfg)
    else:
        g = _act(h, cfg.act, quantized=True)
    return _linear(g, blk, "fc2_kernel", residual=x2, act_amax=a[3]).reshape(B, S, w)


def _block_int8_static_wire(x, blk: VitBlock, cfg: VitConfig):
    """int8_static block with the int8 attention wire (JAX
    ``_block_int8_static_wire``, models/vit.py:920): ln1 and ln2 as the plain
    layernorm in x's dtype then the static quantize; the qkv projection's
    float32 output quantized per channel with ``qkv_amax``; K3 on the int8
    qkv, every scale folded into its channel scales (q: × the attention
    scale, v: × 127/attn_out_amax, so K3's output is int8 under a[1]);
    fc1 → tanh-gelu → fc2 with the residual in fc2's epilogue."""
    B, S, w = x.shape
    a, qa = blk.act_amax, blk.qkv_amax
    inv127 = 1.0 / 127.0
    y = _layernorm(x, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
    yq = quant_static(y, a[0]).reshape(B * S, w)
    qkv_f = q_matmul_pre(yq, a[0] * inv127, blk.qkv_kernel, blk.qkv_kernel_scale,
                         blk.qkv_bias, out_dtype=torch.float32)
    qkv_q = quant_static(qkv_f, qa).reshape(B, S, 3 * w)
    # in float32 as in the JAX package; qa[2w:] / a[1] is one tensor division
    cs = torch.cat([qa[:w] * (inv127 * cfg.head_dim ** -0.5), qa[w:2 * w] * inv127,
                    qa[2 * w:] / a[1]])
    attn_q = fused_attention_packed_q8s(qkv_q, cs, heads=cfg.heads)
    x = x + q_matmul_pre(attn_q.reshape(B * S, w), a[1] * inv127, blk.out_kernel,
                         blk.out_kernel_scale, blk.out_bias, out_dtype=x.dtype).reshape(B, S, w)
    y = _layernorm(x, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
    g = _act(_linear(y, blk, "fc1_kernel", act_amax=a[2]), cfg.act, quantized=True)
    return _linear(g, blk, "fc2_kernel", residual=x, act_amax=a[3])


def _int8_block_mode() -> str:
    """How a dynamic-int8 block runs (``CTPU_INT8_BLOCK``, read at import
    into ``ops/knobs``): 'xla-plain' (the default) the generic block, 'xla'
    :func:`_block_int8_xla`, 'hybrid' :func:`_block_int8_fused`."""
    return knobs.INT8_BLOCK


def block_route(blk: VitBlock, cfg: VitConfig, rope=None) -> str:
    """Which block implementation runs, in the order of the JAX package's
    ``_block`` (models/vit.py:1087-1123):
      * 'wire': int8_static with the wire's ``qkv_amax`` attached, no RoPE
        (K3 has no rotation), no EVA02 block (swiglu or attention sub-LN),
        and S tokens the wire kernel's gate takes (``packed_q8s_fits``; the
        JAX package asks it at its padded length, which gives the same
        answer),
      * 'lnk': int8_static under ``CTPU_LN_KERNEL`` (default on) at a width
        that 128 divides,
      * 'static': every other int8_static block, and every post-norm one
        (EVA02-E) — the generic block with static scales,
      * 'hybrid': dynamic int8 under ``CTPU_INT8_BLOCK=hybrid``, only where
        the width is a multiple of 128 (else generic),
      * 'xla': dynamic int8 under ``CTPU_INT8_BLOCK=xla``, any width,
      * 'generic': float, dynamic int8 by default, and the dynamic-int8
        blocks of every RoPE, EVA02 or post-norm tower."""
    eva = cfg.mlp_type == "swiglu" or cfg.attn_inner_ln
    post = cfg.block_norm == "post"
    if blk.static:
        if post:
            return "static"
        if (blk.wire and rope is None and not eva
                and packed_q8s_fits(cfg.seq_len, cfg.width, cfg.heads)):
            return "wire"
        if knobs.LN_KERNEL and cfg.width % 128 == 0:
            return "lnk"
        return "static"
    if blk.quantized and rope is None and not eva and not post:
        mode = _int8_block_mode()
        if mode == "hybrid" and cfg.width % 128 == 0:
            return "hybrid"
        if mode == "xla":
            return "xla"
    return "generic"


def _block(x, blk: VitBlock, cfg: VitConfig, rope=None):
    """One block, by :func:`block_route`. ``rope``: the (cos, sin) tables of
    a RoPE tower, or None."""
    route = block_route(blk, cfg, rope)
    if route == "wire":
        return _block_int8_static_wire(x, blk, cfg)
    if route == "lnk":
        return _block_int8_static_lnk(x, blk, cfg, rope)
    if route == "hybrid":
        return _block_int8_fused(x, blk, cfg)
    if route == "xla":
        return _block_int8_xla(x, blk, cfg)
    return _block_generic(x, blk, cfg, rope)


@functools.lru_cache(maxsize=8)
def _rope2d_tables(grid: int, head_dim: int, theta: float,
                   cls_token: bool) -> tuple[np.ndarray, np.ndarray]:
    """2-D axial RoPE cos/sin tables [S, head_dim/2] (JAX ``_rope2d_tables``,
    models/vit.py:733): the first head_dim/4 complex lanes rotate by the
    patch's column, the next head_dim/4 by its row; a leading cls token gets
    the identity rotation. Lane i pairs features (i, i + d/2), the half-split
    convention (``models/clip_weights.rope_interleaved_to_half`` brings PE
    checkpoints' interleaved pairs to it). The angles reach ~31 rad, so they
    are computed in float64 and cast to float32, as the JAX package does."""
    quarter = head_dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 4)[:quarter] / head_dim))
    idx = np.arange(grid * grid)
    t_x, t_y = (idx % grid).astype(np.float64), (idx // grid).astype(np.float64)
    ang = np.concatenate([np.outer(t_x, freqs), np.outer(t_y, freqs)], axis=-1)
    if cls_token:
        ang = np.concatenate([np.zeros((1, ang.shape[1])), ang], axis=0)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _rope_on(cfg: VitConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The tower's float32 RoPE tables on ``device``, made once."""
    return tuple(torch.from_numpy(t).to(device) for t in _rope2d_tables(
        cfg.grid, cfg.head_dim, cfg.rope_theta, cfg.use_cls_token))


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The XLA-form rotation (JAX ``_apply_rope``, models/vit.py:756) of
    unscaled q or k [B, h, S, d], with the tables cast to x's dtype."""
    return _rot_half(x, cos.to(x.dtype), sin.to(x.dtype))


def _patch_embed(model: VisionTransformer, images: torch.Tensor, compute_dtype) -> torch.Tensor:
    """[B, R, R, 3] NHWC images → [B, N, width] as reshape + matmul (patch
    flatten order (row, col, channel), matching the converted Conv2d weight),
    plus SigLIP's patch bias. A resolution that p does not divide drops the
    trailing pixels, as a stride-p valid conv. int8 checkpoints dequantize
    the small [p·p·3, w] kernel on the fly."""
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
    x = x @ w_patch
    return x + model.patch_bias.to(compute_dtype) if model.cfg.patch_bias else x


def _stem(model: VisionTransformer, images: torch.Tensor, compute_dtype):
    """Patch embed, class token, positional embedding, ln_pre (each as the
    config asks), and the RoPE tables (or None) — one implementation for
    inference and calibration. Returns (x, rope)."""
    cfg = model.cfg
    x = _patch_embed(model, images, compute_dtype)
    if cfg.use_cls_token:
        cls = model.class_emb.to(compute_dtype).expand(x.shape[0], 1, cfg.width)
        x = torch.cat([cls, x], dim=1)
    x = x + model.pos_emb.to(compute_dtype)
    if cfg.use_ln_pre:
        x = _layernorm(x, model.ln_pre_scale, model.ln_pre_bias, cfg.ln_eps)
    return x, (_rope_on(cfg, x.device) if cfg.use_rope2d else None)


def _probe_mha(x: torch.Tensor, model: VisionTransformer, heads: int) -> torch.Tensor:
    """The probe multi-head attention of SigLIP's and PE's pools (JAX
    ``_probe_mha``): one learned
    query attends over all tokens through an nn.MultiheadAttention-equivalent
    in_proj + softmax + out_proj, in x's dtype with a float32 softmax.
    x: [B, S, w] → [B, w]."""
    B, S, w = x.shape
    d = w // heads
    dt = x.dtype
    wq, wk, wv = model.pool_in_kernel.to(dt).split(w, dim=1)
    bq, bk, bv = model.pool_in_bias.to(dt).split(w)
    q = (model.pool_probe.to(dt) @ wq + bq).reshape(heads, 1, d)
    k = (x @ wk + bk).reshape(B, S, heads, d).permute(0, 2, 1, 3)
    v = (x @ wv + bv).reshape(B, S, heads, d).permute(0, 2, 1, 3)
    # the scale rounds to x's dtype first, as a weakly typed constant in JAX
    scores = torch.einsum("hqd,bhsd->bhqs", q, k) * torch.tensor(d ** -0.5, dtype=dt)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(dt)
    pooled = torch.einsum("bhqs,bhsd->bhqd", probs, v).permute(0, 2, 1, 3)
    pooled = pooled.reshape(B, w) @ model.pool_out_kernel.to(dt)
    return pooled + model.pool_out_bias.to(dt)


def _map_pool(x: torch.Tensor, model: VisionTransformer) -> torch.Tensor:
    """SigLIP's MAP head (HF SiglipMultiheadAttentionPoolingHead, JAX
    ``_map_pool``): ``h + mlp(ln(h))`` where h is the probe attention's
    output."""
    cfg = model.cfg
    h = _probe_mha(x, model, cfg.attn_pooler_heads)
    dt = h.dtype
    y = _layernorm(h, model.pool_ln_scale, model.pool_ln_bias, cfg.ln_eps)
    y = _act(y @ model.pool_fc1_kernel.to(dt) + model.pool_fc1_bias.to(dt), cfg.act)
    return h + (y @ model.pool_fc2_kernel.to(dt) + model.pool_fc2_bias.to(dt))


def _attention_pool(x: torch.Tensor, model: VisionTransformer) -> torch.Tensor:
    """PE's attention pool (JAX ``_attention_pool``, models/vit.py:791): the
    probe attention, then the pool layernorm."""
    cfg = model.cfg
    return _layernorm(_probe_mha(x, model, cfg.attn_pooler_heads), model.pool_ln_scale,
                      model.pool_ln_bias, cfg.ln_eps)


def _coca_pool(x: torch.Tensor, model: VisionTransformer) -> torch.Tensor:
    """CoCa's contrastive readout (JAX ``_coca_pool``, models/vit.py:798):
    open_clip's AttentionalPooler in its legacy single-pooler mode, query 0
    only — an nn.MultiheadAttention with embed dim e and kdim = vdim = w
    (separate q/k/v projections), the query ln_q'd and the tokens ln_k'd
    first; the products in x's dtype in the JAX package's order, the softmax
    in float32. x: [B, S, w] → [B, e]."""
    cfg = model.cfg
    B, S, _ = x.shape
    heads, dt = cfg.attn_pooler_heads, x.dtype
    e = model.pool_q_kernel.shape[0]
    d = e // heads
    bq, bk, bv = model.pool_in_bias.to(dt).split(e)
    q0 = _layernorm(model.pool_query[:1].to(dt), model.pool_lnq_scale, model.pool_lnq_bias,
                    cfg.ln_eps)[0]
    kx = _layernorm(x, model.pool_lnk_scale, model.pool_lnk_bias, cfg.ln_eps)
    q = (q0 @ model.pool_q_kernel.to(dt) + bq).reshape(heads, 1, d)
    k = (kx @ model.pool_k_kernel.to(dt) + bk).reshape(B, S, heads, d).permute(0, 2, 1, 3)
    v = (kx @ model.pool_v_kernel.to(dt) + bv).reshape(B, S, heads, d).permute(0, 2, 1, 3)
    scores = torch.einsum("hqd,bhsd->bhqs", q, k) * torch.tensor(d ** -0.5, dtype=dt)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(dt)
    pooled = torch.einsum("bhqs,bhsd->bhqd", probs, v).permute(0, 2, 1, 3)
    pooled = pooled.reshape(B, e) @ model.pool_out_kernel.to(dt)
    return pooled + model.pool_out_bias.to(dt)


def _check_nans(t: torch.Tensor, where: str) -> None:
    """``debug_nans``: raise at the first NaN, naming where it appeared (the
    port's counterpart of ``jax_debug_nans``, one host sync a check)."""
    if torch.isnan(t).any():
        raise FloatingPointError(f"debug_nans: NaN in {where}")


def _readout(x: torch.Tensor, model: VisionTransformer, compute_dtype,
            normalize: bool = True, debug_nans: bool = False) -> torch.Tensor:
    """The trunk's output [B, S, w] → [B, embed_dim] float32: ln_post of the
    cls row then proj (CLIP, EVA); ln_post over all tokens then the MAP head,
    no projection (SigLIP), or the attention pool then proj (PE); the mean of
    the patch tokens (float32 sum, as ``jnp.mean``), ln_post, proj (CLIPA);
    the CoCa pooler on the raw tokens, ln_post on the pooled dim, proj."""
    cfg = model.cfg
    if cfg.pool in ("attn", "map"):
        x = _layernorm(x, model.ln_post_scale, model.ln_post_bias, cfg.ln_eps)
        pooled = _map_pool(x, model) if cfg.pool == "map" else _attention_pool(x, model)
    elif cfg.pool == "coca":
        pooled = _layernorm(_coca_pool(x, model), model.ln_post_scale, model.ln_post_bias,
                            cfg.ln_eps)
    elif cfg.pool == "avg":
        tokens = x[:, 1 if cfg.use_cls_token else 0:]
        pooled = _layernorm(tokens.to(torch.float32).mean(dim=1).to(x.dtype),
                            model.ln_post_scale, model.ln_post_bias, cfg.ln_eps)
    else:
        pooled = _layernorm(x[:, 0], model.ln_post_scale, model.ln_post_bias, cfg.ln_eps)
    if cfg.use_proj:
        emb = (pooled @ model.proj.to(compute_dtype)).to(torch.float32)
    else:
        emb = pooled.to(torch.float32)
    if debug_nans:
        _check_nans(emb, f"the {cfg.pool} readout")
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb


@torch.inference_mode()
def vit_encode_image(model: VisionTransformer, images: torch.Tensor,
                     compute_dtype=torch.bfloat16, normalize: bool = True,
                     debug_nans: bool = False) -> torch.Tensor:
    """[B, R, R, 3] preprocessed (normalized) NHWC images → [B, embed_dim]
    float32, L2-normalized like the reference's encode_image (the readout:
    :func:`_readout`). ``debug_nans``: every block's output and the readout
    are checked, and the first NaN raises ``FloatingPointError`` naming the
    block (0-based) — off, it costs nothing."""
    cfg = model.cfg
    x, rope = _stem(model, images, compute_dtype)
    for i, blk in enumerate(model.blocks):
        x = _block(x, blk, cfg, rope)
        if debug_nans:
            _check_nans(x, f"the output of block {i} (of {cfg.layers})")
    return _readout(x, model, compute_dtype, normalize, debug_nans)


@torch.inference_mode()
def vit_act_amax(model: VisionTransformer, images: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> dict[str, np.ndarray]:
    """Calibration forward for static W8A8 → {"act_amax": [layers, 4],
    "qkv_amax": [layers, 3·width]} float32.

    act_amax columns are the four per-tensor quantized-activation sites of a
    block (qkv input, attention output, fc1 input, gelu output); qkv_amax is
    the per-channel amax of the qkv projection output (the int8 attention
    wire's grid). Quantized matmuls run dynamic per-row here, and attention
    runs :func:`attention_xla` after :func:`_apply_rope` on the unscaled q
    and k, as in the JAX package (models/vit.py:1393-1471). EVA02's sites
    sit after its sub-LNs (a[1] after the attention sub-LN, a[3] after the
    ffn sub-LN); a post-norm tower's a[0] and a[2] read the raw residual
    stream."""
    cfg = model.cfg
    x, rope = _stem(model, images, compute_dtype)
    B, S = x.shape[:2]
    quantized = model.quantized
    post = cfg.block_norm == "post"
    act, qkv_ch = [], []
    for blk in model.blocks:
        y = x if post else _layernorm(x, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
        s_qkv = y.to(torch.float32).abs().amax()
        qkv = _linear(y, blk, "qkv_kernel")
        qkv_ch.append(qkv.to(torch.float32).abs().amax(dim=(0, 1)))
        q, k, v = (t.reshape(B, S, cfg.heads, cfg.head_dim).permute(0, 2, 1, 3)
                   for t in qkv.split(cfg.width, dim=-1))
        if rope is not None:
            q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        attn = attention_xla(q, k, v, scale=cfg.head_dim ** -0.5)
        attn = attn.permute(0, 2, 1, 3).reshape(B, S, cfg.width)
        if cfg.attn_inner_ln:
            attn = _layernorm(attn, blk.attn_ln_scale, blk.attn_ln_bias, cfg.ln_eps)
        s_attn = attn.to(torch.float32).abs().amax()
        attn_out = _linear(attn, blk, "out_kernel")
        if post:
            attn_out = _layernorm(attn_out, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
        x = x + attn_out
        y = x if post else _layernorm(x, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
        s_fc1 = y.to(torch.float32).abs().amax()
        if cfg.mlp_type == "swiglu":
            g = _swiglu_hidden(_linear(y, blk, "fc1_kernel"), blk, cfg)
        else:
            g = _act(_linear(y, blk, "fc1_kernel"), cfg.act, quantized=quantized)
        s_act = g.to(torch.float32).abs().amax()
        mlp_out = _linear(g, blk, "fc2_kernel")
        if post:
            mlp_out = _layernorm(mlp_out, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
        x = x + mlp_out
        act.append(torch.stack([s_qkv, s_attn, s_fc1, s_act]))
    return {
        "act_amax": torch.stack(act).cpu().numpy().astype(np.float32),
        "qkv_amax": torch.stack(qkv_ch).cpu().numpy().astype(np.float32),
    }


def attach_act_amax(model: VisionTransformer, amax, margin: float = 1.1,
                    wire: bool = False) -> None:
    """Attach calibrated static-activation scales (× margin, which covers
    batch-to-batch drift) to every block, in place. ``amax``: the dict from
    :func:`vit_act_amax` or a bare [layers, 4] array. With ``wire`` the
    per-channel ``qkv_amax`` is attached too, and the blocks take the int8
    attention wire (see :func:`int8_wire_enabled`)."""
    sites = {"act_amax": amax["act_amax"] if isinstance(amax, dict) else amax}
    if wire:
        if not isinstance(amax, dict) or "qkv_amax" not in amax:
            raise ValueError("the int8 attention wire needs the per-channel qkv_amax")
        sites["qkv_amax"] = amax["qkv_amax"]
    for name, v in sites.items():
        v = np.asarray(v, np.float32) * np.float32(margin)
        for i, blk in enumerate(model.blocks):
            blk.register_buffer(name, torch.from_numpy(v[i].copy()).to(blk.ln1_scale.device))
