"""What the two conv-tower families share — the modified ResNet
(``models/resnet.py``) and ConvNeXt (``models/convnext.py``): the module
that holds a tower's leaves, the NHWC convolution, and the family
descriptor that the encoder and ``models/clip_weights`` look up from a
config's type (:func:`conv_family`) instead of testing for each family.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class ConvTower(nn.Module):
    """A conv tower's leaves as buffers under their flat names; ``k_in``
    keeps each int8 kernel's unpadded in-width (``ops/quant.pad_k`` pads
    it). Build one with ``models.clip_weights.module_from_params``."""

    def __init__(self, cfg, tensors: dict[str, torch.Tensor], k_in: dict[str, int] | None = None):
        super().__init__()
        self.cfg = cfg
        self.k_in = dict(k_in or {})
        for name, t in tensors.items():
            self.register_buffer(name, t)

    def has(self, name: str) -> bool:
        return name in self._buffers

    def attach_act_amax(self, amax: dict, margin: float = 1.1) -> None:
        """Attach calibrated static activation scales (the family's
        ``*_act_amax`` from its calibration forward, × margin as the ViT
        path), in place."""
        dev = next(iter(self._buffers.values())).device
        for key, v in amax.items():
            v = np.asarray(v, np.float32) * np.float32(margin)
            self.register_buffer(key, torch.from_numpy(v.copy()).to(dev))


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0,
              groups: int = 1) -> torch.Tensor:
    """NHWC x with an OIHW kernel → NHWC, as ``lax.conv_general_dilated``
    with ("NHWC", "HWIO", "NHWC"): the conv reads x as a channels-last NCHW
    view, and its channels-last output is read back as NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=stride, padding=pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class ConvFamily:
    """One conv family's entry points and the words of its JAX log lines."""

    label: str  # "ResNet" | "ConvNeXt", as the JAX package's log lines name it
    module: type  # the family's ConvTower
    init: Callable  # (cfg, generator, device) → flat float params
    encode: Callable  # (model, images, compute_dtype, normalize, debug_nans) → [B, D]
    quantize: Callable  # flat params → W8A8 params
    is_quantized: Callable  # flat params → bool
    int8_static_enabled: Callable  # cfg → whether int8_static runs W8A8 (else bf16)
    act_amax: Callable  # (model, images, compute_dtype) → {key: raw amax}
    required_keys: Callable  # cfg → the leaves a float tower needs
    calib_shapes: Callable  # cfg → {key: shape} of a calibration file
    int8_sites: str  # what int8_static quantizes, for the "Quantizing" log line
    no_int8: str  # the JAX warning when dynamic int8 is asked for (%s: the name)


def conv_family(cfg) -> ConvFamily | None:
    """The conv family of a tower's config; None for a ViT's."""
    from clip_assisted_data_labeling_tpu_torch.models import convnext, resnet

    return {resnet.RNConfig: resnet.FAMILY, convnext.CNXConfig: convnext.FAMILY}.get(type(cfg))
