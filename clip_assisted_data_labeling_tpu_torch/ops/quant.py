"""W8A8 quantization for the ViT's large matmuls (port of the JAX package's
``ops/quant.py``).

  * weights: symmetric per-output-channel int8, quantized once at load,
  * activations: symmetric int8 — per row from the running amax (``q_matmul``,
    used by the calibration forward) or with a FIXED calibrated scale
    (``quant_static``, the int8_static path),
  * int32 accumulation, dequantized with row·col scales in one epilogue.

Weight layout: the JAX package keeps every kernel as ``[in, out]``; the
quantized int8 kernels here are the same numbers. ``quantize_vit_params``
keeps ``[in, out]`` so its output matches the JAX package's leaf for leaf;
the model module stores them transposed (``[out, in]`` contiguous), the
layout ``torch._int_mm`` takes on the card (models/clip_weights.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from clip_assisted_data_labeling_tpu_torch.ops import knobs


# Divisions by or of a constant are written tensor / tensor: PyTorch
# evaluates ``c / t`` as ``t.reciprocal() * c`` and, on the card, ``t / c`` as
# ``t * (1/c)`` — two roundings where the JAX package (and IEEE) take one. A
# CPU 0-d numerator and a ``full_like`` divisor keep one rounding without a
# host-device copy.
def _num(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def quantize_weight(kernel) -> tuple[torch.Tensor, torch.Tensor]:
    """[in, out] float kernel → (int8 kernel, float32 per-out-channel scale).
    Bit-identical to the JAX package's numpy version (float32 divide, round
    half to even)."""
    k = (kernel if torch.is_tensor(kernel) else torch.from_numpy(np.array(kernel))).to(torch.float32)
    amax = torch.clamp(k.abs().amax(dim=-2, keepdim=True), min=1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-2)


def quantize_vit_params(params: dict) -> dict:
    """Quantize the stacked block matmul kernels and the patch embedding of a
    flat parameter dict (``blocks/<name>`` keys hold ``[L, …]`` stacks, as the
    JAX package's ``.npz`` does). Each quantized kernel K becomes int8 and
    gains a sibling ``K_scale``; every other leaf passes through."""
    out: dict = {}
    for name, leaf in params.items():
        if name.startswith("blocks/") and name.endswith("_kernel"):
            q, s = quantize_weight(leaf)  # amax over axis -2 == per layer, per column
            out[name] = q
            out[name + "_scale"] = s
        elif name == "patch_kernel":
            q, s = quantize_weight(leaf)
            out[name] = q
            out[name + "_scale"] = s
        else:
            out[name] = leaf
    return out


def is_quantized(params: dict) -> bool:
    return "patch_kernel_scale" in params or "blocks/qkv_kernel_scale" in params


# the stored int8 weights' K (their [N, K] rows) is padded to a multiple of
# this once, where the module takes them (models/clip_weights.py):
# ``torch._int_mm`` needs K % 8 == 0 on the card, the GEMM of K8/K9 K % 16
K_ALIGN = 16


def pad_k(wq_t: torch.Tensor) -> torch.Tensor:
    """int8 weights stored [N, K] → [N, K'] with K' the next multiple of
    :data:`K_ALIGN`, the new columns zero (exact in the int32 sums)."""
    extra = -wq_t.shape[1] % K_ALIGN
    return F.pad(wq_t, (0, extra)) if extra else wq_t


def match_k(x: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """x [M, K] with zero columns up to the K' of weights that :func:`pad_k`
    padded ([N, K'], K' = K rounded up to :data:`K_ALIGN`); x as it is for
    any other weight, so a weight of the wrong width still fails its
    product's checks."""
    k, kw = x.shape[1], wq_t.shape[1]
    return F.pad(x, (0, kw - k)) if kw > k and kw == k + (-k % K_ALIGN) else x


def int_matmul(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] × int8 weights stored [N, K'] → int32 [M, N], K' ≥ K the
    weights' padded K (:func:`pad_k`): the activations get K' - K zero
    columns to match (EVA02-L's fc2 has K = 2730).

    ``torch._int_mm`` takes the second operand column-major on the card
    (``wq_t.t()`` of the contiguous [N, K] layout) and needs M > 16 and
    N % 8 == 0 there; smaller M is padded with zero rows, other N with zero
    weight rows."""
    xq = match_k(xq, wq_t)
    m, n = xq.shape[0], wq_t.shape[0]
    if xq.is_cuda and (m <= 16 or n % 8):
        xq = torch.cat([xq, xq.new_zeros((max(17 - m, 0), xq.shape[1]))])
        wq_t = torch.cat([wq_t, wq_t.new_zeros((-n % 8, wq_t.shape[1]))])
        return torch._int_mm(xq, wq_t.t())[:m, :n]
    return torch._int_mm(xq, wq_t.t())


def _dequant_epilogue(acc, x_scale, w_scale, bias, residual, out_dtype):
    """float32 ``acc·x_scale·w_scale (+bias)(+residual)`` → out_dtype. Type
    promotion does each int32/bf16 → float32 conversion inside the op that
    reads the operand (the same exact conversion, one pass fewer each); the
    in-place ops reuse the one float32 temporary."""
    y = acc * torch.as_tensor(x_scale, dtype=torch.float32, device=acc.device)
    y.mul_(w_scale)
    if bias is not None:
        y.add_(bias)
    if residual is not None:
        y.add_(residual)
    return y.to(out_dtype)


def q_matmul(x: torch.Tensor, wq_t: torch.Tensor, w_scale: torch.Tensor,
             bias: torch.Tensor | None = None, out_dtype=torch.bfloat16,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """Dynamic per-row int8 × per-channel int8 → dequantized matmul.
    x: [..., K] float; wq_t: [N, K] int8; w_scale: [N] f32.

    Under ``CTPU_FUSED_QMATMUL=1`` (``ops/knobs.FUSED_QMATMUL``) it runs K9,
    ``ops/quant_kernel.q_linear_fused``, and adds the residual after the cast,
    in ``out_dtype``, as the JAX package's route does. The JAX package takes
    that route only on a TPU backend, where its Pallas kernel runs; here K9's
    wrapper serves every device (its plain version on the CPU), so the knob
    alone decides."""
    lead = x.shape[:-1]
    n = wq_t.shape[0]
    if knobs.FUSED_QMATMUL:
        from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import q_linear_fused

        out = q_linear_fused(x.reshape(-1, x.shape[-1]), wq_t, w_scale, bias,
                             out_dtype=out_dtype).reshape(lead + (n,))
        return out if residual is None else residual + out
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    x_scale = amax / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    acc = int_matmul(xq, wq_t)
    res = None if residual is None else residual.reshape(-1, n)
    y = _dequant_epilogue(acc, x_scale, w_scale, bias, res, out_dtype)
    return y.reshape(lead + (n,))


def quant_static(x: torch.Tensor, amax) -> torch.Tensor:
    """Symmetric int8 quantization with a FIXED (calibrated) scale: one
    per-tensor amax, or one per channel of x's last axis (the int8 attention
    wire's qkv). The amax is floored at 1e-8 so a dead site quantizes to
    zeros, not NaN."""
    amax = torch.as_tensor(amax, dtype=torch.float32, device=x.device)
    inv = _num(127.0) / torch.clamp(amax, min=1e-8)
    # a 1-element (not 0-d) factor makes x * inv promote to float32 inside
    # the multiply, so bf16 x needs no separate conversion pass
    inv = inv.reshape(1) if inv.dim() == 0 else inv
    return (x * inv).round_().clamp_(-127, 127).to(torch.int8)
