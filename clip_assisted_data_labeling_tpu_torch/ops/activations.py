"""Activations with the JAX package's roundings, shared by the ViT blocks
(``models/vit._act``), the plain version of the row-quantize kernel K6
(``ops/quant_kernel.rowquant_plain``) and that of int8_static's fc1 with its
int8 hidden (``ops/quant_kernel.q_matmul_pre_act_q8``)."""
from __future__ import annotations

import numpy as np
import torch

SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi).astype(np.float32))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True) as XLA computes it, jitted or not:
    x · (0.5 · (1 + tanh(√(2/π) · (x + 0.044715 · x³)))) with every step
    rounded to x's dtype and the constants cast to it. In bf16 this equals
    the JAX function bit for bit; torch's fused F.gelu rounds once and
    differed on 39% of bf16 outputs."""
    def c(v):  # a constant in x's dtype, as a 0-d CPU tensor (no device copy)
        return torch.tensor(v, dtype=x.dtype)

    inner = c(SQRT_2_OVER_PI) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def sigmoid_xla(z: torch.Tensor) -> torch.Tensor:
    """The sigmoid as XLA expands it: 1 / (1 + exp(-z)), each step rounded
    to z's dtype (in bf16 torch.sigmoid's single rounding differs on ~1/3 of
    elements)."""
    return 1.0 / (1.0 + torch.exp(-z))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's x · sigmoid(1.702 x) in x's dtype, the constant cast to
    it, each step rounded."""
    return x * sigmoid_xla(torch.tensor(1.702, dtype=x.dtype, device=x.device) * x)
