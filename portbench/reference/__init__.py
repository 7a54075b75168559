"""Plain versions of what the port computes, that its outputs are judged
against: the crops, the ViT towers and the image stats of stage 1, and the
all-pairs scan of stage 2. Plain PyTorch, float32 (float64 where the stats'
reference computes so) with TF32 off; each takes ``control=True`` to compute
one precision step lower, the control that has to come out as not correct.
Nothing here imports JAX or the port."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 in float32 matrix products and convolutions on or off, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away), as the tensor cores read them with TF32 on; the same on any device."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
