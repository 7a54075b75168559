"""LayerNorm + static int8 quantize — kernel K2 — and the int8 matmul over
pre-quantized activations (port of the JAX package's ``ops/quant_kernel.py``
static path).

``rowquant_static`` replaces the TPU kernel ``_rowquant_static_kernel`` /
``rowquant_static`` (clip_assisted_data_labeling_tpu/ops/quant_kernel.py,
``pallas_call`` at :457) with the hand-written CUDA kernel in
``csrc/rowquant_static.cu``; its header says what bounds the kernel on the
H100 and how the design answers that. Unlike the TPU kernel it takes any row
width whose float32 row fits shared memory (no K % 128 rule).

``q_matmul_pre`` was plain XLA in the JAX package and is plain PyTorch here:
``torch._int_mm`` plus the float32 dequant epilogue.

Dispatch: a CPU tensor goes to the plain PyTorch version beside the kernel;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from clip_assisted_data_labeling_tpu_torch.ops import _cuda_build
from clip_assisted_data_labeling_tpu_torch.ops.quant import _dequant_epilogue, _num, int_matmul

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rowquant_static_plain(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          amax, ln_eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per row in float32, two-pass
    population variance, affine, ×127/amax (no floor), round half to even,
    clip to ±127."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * (_num(1.0) / torch.sqrt(var + ln_eps))
    y = y * ln_scale.to(torch.float32) + ln_bias.to(torch.float32)
    inv = _num(127.0) / torch.as_tensor(amax, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)


def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("rowquant_static")
    if lib.rowquant_static.argtypes is None:
        lib.rowquant_static.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.rowquant_static.restype = ctypes.c_int
    return lib


def rowquant_static(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    amax: torch.Tensor, ln_eps: float = 1e-5) -> torch.Tensor:
    """layernorm + STATIC-scale int8 quantization of x [M, K] in one pass →
    int8 [M, K] (dequant scale amax/127, held by the caller). ``amax`` is a
    one-element float32 tensor on x's device (read by the kernel, so the
    caller never waits for the card)."""
    if x.device.type == "cpu":
        return rowquant_static_plain(x, ln_scale, ln_bias, amax, ln_eps)
    if not x.is_cuda:
        raise ValueError(f"rowquant_static: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(
            "rowquant_static wants a contiguous [M, K] float32 or bfloat16 "
            f"tensor, got {tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}"
        )
    m, k = x.shape
    if 4 * k > _cuda_build.SMEM_LIMIT:  # the kernel holds one float32 row in shared memory
        raise ValueError(f"rowquant_static: K={k} row does not fit shared memory")
    for name, t, n in (("ln_scale", ln_scale, k), ("ln_bias", ln_bias, k), ("amax", amax, 1)):
        if (t.device != x.device or t.dtype != torch.float32 or t.numel() != n
                or not t.is_contiguous()):
            raise ValueError(
                f"rowquant_static: {name} must be a contiguous float32 tensor of "
                f"{n} elements on {x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    out = torch.empty((m, k), dtype=torch.int8, device=x.device)
    err = _lib().rowquant_static(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), amax.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[x.dtype], m, k, float(ln_eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _cuda_build.check(err, "rowquant_static")
    rowquant_static.launches += 1
    return out


rowquant_static.launches = 0


def q_matmul_pre(
    xq: torch.Tensor,  # [M, K] int8
    x_scale: torch.Tensor,  # [M, 1] or scalar f32
    wq_t: torch.Tensor,  # [N, K] int8 (the [K, N] kernel, stored transposed)
    w_scale: torch.Tensor,  # [N] f32
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """int8 × int8 → int32 product over pre-quantized activations, then the
    float32 epilogue ``acc·x_scale·w_scale (+bias)(+residual)`` and the cast
    to ``out_dtype``. Pairs with :func:`rowquant_static`."""
    acc = int_matmul(xq, wq_t)
    return _dequant_epilogue(acc, x_scale, w_scale, bias, residual, out_dtype)
