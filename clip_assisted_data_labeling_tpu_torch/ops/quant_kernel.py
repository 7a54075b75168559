"""The row-quantize kernels K2 and K6, the fused W8A8 linear K9, the fused
block linear K8, and the int8 matmul over pre-quantized activations (port of
the JAX package's ``ops/quant_kernel.py``).

  * ``rowquant_static`` (K2) replaces the TPU kernel
    ``_rowquant_static_kernel`` / ``rowquant_static``
    (clip_assisted_data_labeling_tpu/ops/quant_kernel.py, ``pallas_call`` at
    :457) with ``csrc/rowquant_static.cu``: layernorm + static int8 quantize.
  * ``rowquant`` (K6) replaces ``_rowquant_kernel`` / ``rowquant``
    (``pallas_call`` at :390) with ``csrc/rowquant.cu``: optional layernorm,
    optional activation (quick_gelu, gelu_tanh or erf-gelu, in float32),
    then the dynamic per-row int8 quantize with float32 row scales.
  * ``q_linear_fused`` (K9) replaces ``_kernel`` / ``q_linear_fused``
    (``pallas_call`` at :102) with K6's quantize pass (no layernorm, no
    activation) and the hand-written int8 GEMM of ``csrc/q_linear_fused.cu``
    (``wgmma`` on a TMA ring) with the dequant + bias epilogue: one K9
    launch per call. ``ops/quant.q_matmul`` runs it under
    ``CTPU_FUSED_QMATMUL=1``.
  * ``q_block_linear`` (K8) replaces ``_block_kernel`` / ``q_block_linear``
    (``pallas_call`` at :299): K6's row pass as the prologue (layernorm +
    dynamic quantize, or an int8 input with its row scales), K9's GEMM with
    its epilogue extended by the activation and the residual, and for
    ``quant_out`` K6's row pass over the float32 output rows — one K8
    launch per call. No entry point of the JAX package calls it; it is
    ported as a kernel in its own right.

Each kernel's header says what bounds it on the H100 and how the design
answers that. Unlike the TPU kernels, K2 and K6 take any row width whose
float32 row fits shared memory (no K % 128 rule; K6 holds rows of up to
10240 bf16 values in registers and stages longer ones there); the GEMM of
K9 and K8 needs K % 16 == 0 and 16-byte aligned int8 operands on the card
(TMA reads their rows). K8 keeps the TPU kernel's two refusals
(K % 128 with the layernorm, N % 128 with ``quant_out``) on every device.

``q_matmul_pre`` (the int8 product over rows quantized before it: every
int8_static block product, and the dynamic routes' products over K6's or
K1's int8 rows) was plain XLA in the JAX package. Here it is ``torch._int_mm``
plus the float32 dequant epilogue (``ops/quant._dequant_epilogue``) on the
CPU, and on the card K9's GEMM alone with that epilogue fused: one launch,
the per-tensor ``x_scale`` read from the card where it is one value, equal
bit for bit to the CPU's arithmetic (the int32 sums are exact, and each
float32 step is rounded once on both).

``q_matmul_pre_act_q8`` (int8_static's fc1, whose output fc2 alone reads)
was plain XLA too: ``q_matmul_pre``'s bf16 output, the activation in bf16 and
fc2's static quantize. On the CPU it is that chain; on the card one launch
of K9's GEMM whose epilogue rounds each value to the bf16 fc1 wrote before
and reads the chain's int8 for it from a table of all 65,536 bf16 values,
which the chain's own torch operations fill on the card: the same bits.

Dispatch: a CPU tensor goes to the plain PyTorch version beside the kernel;
a CUDA tensor launches the kernel on its own card or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from clip_assisted_data_labeling_tpu_torch.ops import _cuda_build
from clip_assisted_data_labeling_tpu_torch.ops.activations import gelu_tanh, quick_gelu
from clip_assisted_data_labeling_tpu_torch.ops.quant import (
    _dequant_epilogue,
    _num,
    int_matmul,
    match_k,
    quant_static,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {None: 0, "quick_gelu": 1, "gelu_tanh": 2, "gelu": 3}
# amax * (1/127) with the constant as float32 of the double, as the JAX
# package's weakly typed 1.0 / 127.0
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def _layernorm_f32(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                   ln_eps: float) -> torch.Tensor:
    """The row kernels' layernorm in float32: two-pass population variance,
    ×1/sqrt(var + eps), then the affine."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * (_num(1.0) / torch.sqrt(var + ln_eps))
    return y * ln_scale.to(torch.float32) + ln_bias.to(torch.float32)


def rowquant_static_plain(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          amax, ln_eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per row in float32, two-pass
    population variance, affine, ×127/amax (no floor), round half to even,
    clip to ±127."""
    y = _layernorm_f32(x, ln_scale, ln_bias, ln_eps)
    inv = _num(127.0) / torch.as_tensor(amax, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)


def _check_rows(what: str, x: torch.Tensor) -> None:
    """x must be a contiguous [M, K] float32 or bfloat16 tensor whose float32
    row fits shared memory (K2 holds one there, and so does K6 for rows
    longer than its registers hold)."""
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(
            f"{what} wants a contiguous [M, K] float32 or bfloat16 tensor, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}"
        )
    if 4 * x.shape[1] > _cuda_build.SMEM_LIMIT:
        raise ValueError(f"{what}: K={x.shape[1]} row does not fit shared memory")


def _check_vec(what: str, name: str, t: torch.Tensor, n: int, device) -> None:
    if t.device != device or t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous float32 tensor of {n} elements on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def _static_lib() -> ctypes.CDLL:
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
    _check_rows("rowquant_static", x)
    m, k = x.shape
    for name, t, n in (("ln_scale", ln_scale, k), ("ln_bias", ln_bias, k), ("amax", amax, 1)):
        _check_vec("rowquant_static", name, t, n, x.device)
    out = torch.empty((m, k), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = _static_lib().rowquant_static(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), amax.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[x.dtype], m, k, float(ln_eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _cuda_build.check(err, "rowquant_static")
    rowquant_static.launches += 1
    return out


rowquant_static.launches = 0


# ---- K6: (layernorm | activation) + dynamic per-row int8 quantize ------------

def _row_act(y: torch.Tensor, act: str | None) -> torch.Tensor:
    """K6's activations in float32, as the TPU kernel writes them:
    quick_gelu ``y · (1 / (1 + exp(-1.702·y)))``, gelu_tanh
    ``jax.nn.gelu(approximate=True)`` step by step, gelu with erf
    ``y · 0.5 · (1 + erf(y / √2))`` (the exact form, where the port's other
    int8 paths take tanh)."""
    if act not in _ACT_CODE:
        raise ValueError(f"rowquant: unknown activation {act!r}")
    if act == "quick_gelu":
        return y * (_num(1.0) / (1.0 + torch.exp(-(1.702 * y))))
    if act == "gelu_tanh":
        return gelu_tanh(y)
    if act == "gelu":
        return y * 0.5 * (1.0 + torch.erf(y * 2.0 ** -0.5))
    return y


def rowquant_plain(x: torch.Tensor, ln_scale: torch.Tensor | None = None,
                   ln_bias: torch.Tensor | None = None, act: str | None = None,
                   ln_eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's arithmetic in plain PyTorch, per row in float32: the optional
    layernorm, the optional activation, ``amax = max(max|y|, 1e-8)``,
    ``clip(round(y · (127/amax)))`` (one division, round half to even) and
    the scale ``amax · (1/127)``. Returns (int8 [M, K], float32 [M, 1])."""
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("rowquant: pass both ln_scale and ln_bias, or neither")
    y = (x.to(torch.float32) if ln_scale is None
         else _layernorm_f32(x, ln_scale, ln_bias, ln_eps))
    y = _row_act(y, act)
    amax = torch.clamp(y.abs().amax(dim=-1, keepdim=True), min=1e-8)
    q = torch.clamp(torch.round(y * (_num(127.0) / amax)), -127, 127).to(torch.int8)
    return q, amax * _INV127


def _row_lib() -> ctypes.CDLL:
    lib = _cuda_build.load("rowquant")
    if lib.rowquant.argtypes is None:
        lib.rowquant.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.rowquant.restype = ctypes.c_int
    return lib


def _rowquant_launch(what: str, x: torch.Tensor, ln_scale, ln_bias, act: str | None,
                     ln_eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Check x [M, K] on the card and launch K6's C entry on the current
    stream; returns (int8 [M, K], float32 [M, 1]). Counts nothing: K1's
    quant_out and K9 run this pass inside their own launch."""
    _check_rows(what, x)
    if act not in _ACT_CODE:
        raise ValueError(f"{what}: unknown activation {act!r}")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError(f"{what}: pass both ln_scale and ln_bias, or neither")
    m, k = x.shape
    if ln_scale is not None:
        _check_vec(what, "ln_scale", ln_scale, k, x.device)
        _check_vec(what, "ln_bias", ln_bias, k, x.device)
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _row_lib().rowquant(
            x.data_ptr(), None if ln_scale is None else ln_scale.data_ptr(),
            None if ln_bias is None else ln_bias.data_ptr(), q.data_ptr(), scale.data_ptr(),
            _DTYPE_CODE[x.dtype], _ACT_CODE[act], m, k, float(ln_eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _cuda_build.check(err, what)
    return q, scale


def rowquant(x: torch.Tensor, ln_scale: torch.Tensor | None = None,
             ln_bias: torch.Tensor | None = None, act: str | None = None,
             ln_eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(layernorm | activation) + per-row symmetric int8 quantization of x
    [M, K] in one pass → (int8 [M, K], float32 [M, 1] row scales)."""
    if x.device.type == "cpu":
        return rowquant_plain(x, ln_scale, ln_bias, act, ln_eps)
    if not x.is_cuda:
        raise ValueError(f"rowquant: unsupported device {x.device}")
    out = _rowquant_launch("rowquant", x, ln_scale, ln_bias, act, ln_eps)
    rowquant.launches += 1
    return out


rowquant.launches = 0


# ---- K9: dynamic quantize → int8 GEMM → dequant + bias ------------------------

def q_linear_fused_plain(x: torch.Tensor, wq_t: torch.Tensor, w_scale: torch.Tensor,
                         bias: torch.Tensor | None = None,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """K9's arithmetic in plain PyTorch (the TPU ``_kernel``, quant_kernel.py
    :34-43): per row ``amax = max(max|x|, 1e-8)``, ``xq = clip(round(x ·
    (127/amax)))``, int32 product with the weight stored [N, K], then
    ``((acc · amax·(1/127)) · w_scale) + bias`` in float32, cast to
    ``out_dtype``. It rounds the quantize differently from
    :func:`ops.quant.q_matmul` (which divides by amax/127)."""
    xq, xs = rowquant_plain(x)
    return _dequant_epilogue(int_matmul(xq, wq_t), xs, w_scale, bias, None, out_dtype)


def _gemm_lib() -> ctypes.CDLL:
    lib = _cuda_build.load("q_linear_fused")
    if lib.q_block_linear_gemm.argtypes is None:
        lib.q_block_linear_gemm.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.q_block_linear_gemm.restype = ctypes.c_int
    if lib.q_gemm_hidden_q8.argtypes is None:
        lib.q_gemm_hidden_q8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.q_gemm_hidden_q8.restype = ctypes.c_int
    return lib


def _check_gemm(what: str, x: torch.Tensor, wq_t: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None, out_dtype, act: str | None = None,
                residual: torch.Tensor | None = None) -> None:
    """The GEMM's own conditions (K9's and K8's), checked before any launch:
    x [M, K] on the card, wq_t a contiguous 16-byte aligned int8 [N, K] there,
    K % 16 == 0, w_scale and bias float32 [N], residual [M, N]."""
    m, k = x.shape
    n = wq_t.shape[0]
    if (wq_t.dim() != 2 or wq_t.dtype != torch.int8 or wq_t.shape[1] != k
            or not wq_t.is_contiguous() or wq_t.device != x.device):
        raise ValueError(
            f"{what}: wq_t must be a contiguous int8 [N, {k}] tensor on {x.device}, got "
            f"{tuple(wq_t.shape)} {wq_t.dtype} on {wq_t.device}"
        )
    if (k % 16 or wq_t.data_ptr() % 16 or out_dtype not in _DTYPE_CODE
            or act not in _ACT_CODE):
        raise ValueError(
            f"{what}: the GEMM reads 16-byte vectors — K={k} must be a multiple of 16 and the "
            f"weight 16-byte aligned; out_dtype float32 or bfloat16 (got {out_dtype}); act one "
            f"of {sorted(map(str, _ACT_CODE))} (got {act!r})"
        )
    _check_vec(what, "w_scale", w_scale, n, x.device)
    if bias is not None:
        _check_vec(what, "bias", bias, n, x.device)
    if residual is not None and (residual.shape != (m, n) or residual.dtype not in _DTYPE_CODE
                                 or not residual.is_contiguous()
                                 or residual.device != x.device):
        raise ValueError(
            f"{what}: residual must be a contiguous float32 or bfloat16 [{m}, {n}] tensor on "
            f"{x.device}, got {tuple(residual.shape)} {residual.dtype} on {residual.device}"
        )


def _gemm_launch(what: str, xq: torch.Tensor, xs: torch.Tensor, wq_t: torch.Tensor,
                 w_scale: torch.Tensor, bias: torch.Tensor | None, out_dtype,
                 act: str | None = None, residual: torch.Tensor | None = None,
                 xs_stride: int = 1) -> torch.Tensor:
    """The int8 GEMM of K9, K8 and ``q_matmul_pre``, on xq's card, on
    arguments :func:`_check_gemm` (and :func:`_check_pre`) passed:
    ``act(((acc·xs)·w_scale) + bias) + residual`` in float32, cast to
    ``out_dtype`` → [M, N]; row m's scale is ``xs``'s element m ·
    ``xs_stride`` (1: one a row; 0: one for every row)."""
    m, n, k = xq.shape[0], wq_t.shape[0], xq.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        err = _gemm_lib().q_block_linear_gemm(
            xq.data_ptr(), wq_t.data_ptr(), xs.data_ptr(), xs_stride, w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            0 if residual is None else _DTYPE_CODE[residual.dtype], out.data_ptr(),
            _DTYPE_CODE[out_dtype], _ACT_CODE[act], m, n, k,
            torch.cuda.current_stream(xq.device).cuda_stream,
        )
    _cuda_build.check(err, what)
    return out


def q_linear_fused(x: torch.Tensor, wq_t: torch.Tensor, w_scale: torch.Tensor,
                   bias: torch.Tensor | None = None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused W8A8 linear: x [M, K] float32 or bfloat16, wq_t [N, K] int8 (the
    [K, N] kernel stored transposed), w_scale [N] and bias [N] (or None)
    float32 → [M, N] of ``out_dtype`` (float32 or bfloat16). Weights whose K
    was padded (``ops/quant.pad_k``) get x padded with zero columns to match:
    they change neither a row's amax nor its products."""
    x = match_k(x, wq_t)
    if x.device.type == "cpu":
        return q_linear_fused_plain(x, wq_t, w_scale, bias, out_dtype)
    if not x.is_cuda:
        raise ValueError(f"q_linear_fused: unsupported device {x.device}")
    _check_rows("q_linear_fused", x)
    _check_gemm("q_linear_fused", x, wq_t, w_scale, bias, out_dtype)
    xq, xs = _rowquant_launch("q_linear_fused", x, None, None, None, 1e-5)
    out = _gemm_launch("q_linear_fused", xq, xs, wq_t, w_scale, bias, out_dtype)
    q_linear_fused.launches += 1
    return out


q_linear_fused.launches = 0


# ---- K8: the fused block linear ----------------------------------------------

def _check_block_linear(k: int, n: int, has_ln: bool, quant_out: bool) -> None:
    """The JAX ``q_block_linear``'s refusals (quant_kernel.py:238-241)."""
    if has_ln and k % 128 != 0:
        raise ValueError("fused layernorm requires K % 128 == 0 (no K padding)")
    if quant_out and n % 128 != 0:
        raise ValueError("quant_out requires N % 128 == 0 (exact row scales)")


def q_block_linear_plain(x: torch.Tensor, wq_t: torch.Tensor, w_scale: torch.Tensor,
                         bias: torch.Tensor | None = None, x_scale: torch.Tensor | None = None,
                         ln_scale: torch.Tensor | None = None,
                         ln_bias: torch.Tensor | None = None,
                         residual: torch.Tensor | None = None, act: str | None = None,
                         quant_out: bool = False, out_dtype=torch.bfloat16,
                         ln_eps: float = 1e-5):
    """K8's arithmetic in plain PyTorch (the TPU ``_block_kernel``,
    quant_kernel.py:138-192): the input either int8 with its [M, 1] scales or
    float, then K6's pass (the optional float32 layernorm, ``amax = max(max|x|,
    1e-8)``, ``clip(round(x·(127/amax)))``, scale ``amax·(1/127)``); the int32
    product with the weight stored [N, K]; ``(acc·row_scale)·w_scale + bias``
    in float32; the optional activation in float32 (K6's forms); the optional
    ``+ residual`` in float32; then the cast to ``out_dtype``, or with
    ``quant_out`` K6's quantize of each [N] output row → (int8 [M, N],
    float32 [M, 1])."""
    _check_block_linear(wq_t.shape[1], wq_t.shape[0], ln_scale is not None, quant_out)
    if x_scale is not None:
        xq, xs = x, x_scale.float()
    else:
        xq, xs = rowquant_plain(x, ln_scale, ln_bias, None, ln_eps)
    y = _row_act(_dequant_epilogue(int_matmul(xq, wq_t), xs, w_scale, bias, None, torch.float32),
                 act)
    if residual is not None:
        y = y + residual.float()
    return rowquant_plain(y) if quant_out else y.to(out_dtype)


def q_block_linear(x: torch.Tensor, wq_t: torch.Tensor, w_scale: torch.Tensor,
                   bias: torch.Tensor | None = None, x_scale: torch.Tensor | None = None,
                   ln_scale: torch.Tensor | None = None, ln_bias: torch.Tensor | None = None,
                   residual: torch.Tensor | None = None, act: str | None = None,
                   quant_out: bool = False, out_dtype=torch.bfloat16, ln_eps: float = 1e-5):
    """One transformer-block linear: x [M, K] (float32 or bfloat16, or int8
    with ``x_scale`` float32 [M, 1]), an optional fused pre-layernorm
    (``ln_scale``, ``ln_bias`` [K], K % 128 == 0), wq_t [N, K] int8 (the
    [K, N] kernel stored transposed), w_scale and bias [N] float32, an
    optional activation and ``residual`` [M, N] (float32 or bfloat16) →
    [M, N] of ``out_dtype`` (float32 or bfloat16), or with ``quant_out``
    (N % 128 == 0) → (int8 [M, N], float32 [M, 1])."""
    m, k = x.shape
    n = wq_t.shape[0]
    _check_block_linear(k, n, ln_scale is not None, quant_out)
    if x.device.type == "cpu":
        return q_block_linear_plain(x, wq_t, w_scale, bias, x_scale, ln_scale, ln_bias, residual,
                                    act, quant_out, out_dtype, ln_eps)
    if not x.is_cuda:
        raise ValueError(f"q_block_linear: unsupported device {x.device}")
    what = "q_block_linear"
    _check_gemm(what, x, wq_t, w_scale, bias, out_dtype, act, residual)
    if x_scale is not None:
        if x.dtype != torch.int8 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: with x_scale, x must be a contiguous 16-byte aligned "
                             f"int8 [M, K] tensor, got {x.dtype}")
        _check_vec(what, "x_scale", x_scale, m, x.device)
        xq, xs = x, x_scale
    else:
        xq, xs = _rowquant_launch(what, x, ln_scale, ln_bias, None, ln_eps)
    out = _gemm_launch(what, xq, xs, wq_t, w_scale, bias,
                       torch.float32 if quant_out else out_dtype, act, residual)
    if quant_out:
        out = _rowquant_launch(what, out, None, None, None, 1e-5)
    q_block_linear.launches += 1
    return out


q_block_linear.launches = 0


def _check_pre(xq: torch.Tensor, x_scale: torch.Tensor, wq_t: torch.Tensor,
               w_scale: torch.Tensor, bias: torch.Tensor | None,
               residual: torch.Tensor | None, out_dtype, what: str = "q_matmul_pre") -> int:
    """The GEMM's conditions on a ``q_matmul_pre`` call whose ``xq`` is
    already padded to the weight's K (``match_k``), checked before the
    launch: ``xq`` a contiguous 16-byte aligned int8 [M, K] with M ≥ 1,
    ``x_scale`` a float32 tensor on xq's device holding one per-tensor
    value (0-d or one element) or contiguous [M, 1] row scales, the rest as
    :func:`_check_gemm` wants them. Returns the stride of the row scales
    (0: one for every row; 1: one a row)."""
    if (xq.dim() != 2 or xq.dtype != torch.int8 or not xq.is_contiguous()
            or xq.data_ptr() % 16 or xq.shape[0] < 1):
        raise ValueError(f"{what}: xq must be a contiguous 16-byte aligned int8 [M, K] tensor "
                         f"with M >= 1, got {tuple(xq.shape)} {xq.dtype}")
    _check_gemm(what, xq, wq_t, w_scale, bias, out_dtype, residual=residual)
    if (not torch.is_tensor(x_scale) or x_scale.device != xq.device
            or x_scale.dtype != torch.float32
            or not (x_scale.numel() == 1 and x_scale.dim() <= 2
                    or x_scale.shape == (xq.shape[0], 1) and x_scale.is_contiguous())):
        got = (f"{tuple(x_scale.shape)} {x_scale.dtype} on {x_scale.device}"
               if torch.is_tensor(x_scale) else type(x_scale).__name__)
        raise ValueError(f"{what}: x_scale must be a float32 tensor on {xq.device} holding one "
                         f"value or contiguous [{xq.shape[0]}, 1] row scales, got {got}")
    return 0 if x_scale.numel() == 1 else 1


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
    to ``out_dtype``. Pairs with :func:`rowquant_static`. On the CPU
    ``torch._int_mm`` and ``_dequant_epilogue``; on the card one launch of
    K9's GEMM with that epilogue fused (counted in ``launches``), the same
    bits, on inputs :func:`_check_pre` passes (it raises on others)."""
    if xq.device.type == "cpu":
        return _dequant_epilogue(int_matmul(xq, wq_t), x_scale, w_scale, bias, residual,
                                 out_dtype)
    if not xq.is_cuda:
        raise ValueError(f"q_matmul_pre: unsupported device {xq.device}")
    xq = match_k(xq, wq_t)
    stride = _check_pre(xq, x_scale, wq_t, w_scale, bias, residual, out_dtype)
    out = _gemm_launch("q_matmul_pre", xq, x_scale, wq_t, w_scale, bias, out_dtype,
                       residual=residual, xs_stride=stride)
    q_matmul_pre.launches += 1
    return out


q_matmul_pre.launches = 0


# ---- int8_static's fc1 with its int8 hidden -----------------------------------

_HIDDEN_ACTS = {"quick_gelu": quick_gelu, "gelu_tanh": gelu_tanh}


def q_matmul_pre_act_q8_plain(xq: torch.Tensor, x_scale: torch.Tensor, wq_t: torch.Tensor,
                              w_scale: torch.Tensor, bias: torch.Tensor | None, act: str,
                              out_amax: torch.Tensor) -> torch.Tensor:
    """The chain the kernel replaces, on any device: ``q_matmul_pre``'s
    torch route to bf16, the activation in bf16 (each step rounded:
    ``ops/activations``), then ``quant_static`` under ``out_amax``."""
    h = _dequant_epilogue(int_matmul(xq, wq_t), x_scale, w_scale, bias, None, torch.bfloat16)
    return quant_static(_HIDDEN_ACTS[act](h), out_amax)


@functools.lru_cache(maxsize=None)
def _act_table(act: str, device: torch.device) -> torch.Tensor:
    """bf16 [65536] on ``device``: entry i is the activation of the bf16
    value whose bits are i (it depends on ``act`` and the device alone, so
    a process computes it once)."""
    every = torch.arange(2 ** 16, dtype=torch.int32, device=device)
    return _HIDDEN_ACTS[act](every.to(torch.int16).view(torch.bfloat16))


def _hidden_table(act: str, out_amax: torch.Tensor) -> torch.Tensor:
    """int8 [65536] on out_amax's device: entry i is the chain's int8 for the
    bf16 value whose bits are i, ``quant_static(act(v), out_amax)``, computed
    by those torch operations (elementwise, so each entry is the chain's
    value for v wherever it stands); the quantize runs each call (fc2's amax
    is the block's)."""
    return quant_static(_act_table(act, out_amax.device), out_amax)


def _check_hidden_q8(xq: torch.Tensor, x_scale: torch.Tensor, wq_t: torch.Tensor,
                     w_scale: torch.Tensor, bias: torch.Tensor | None, act: str,
                     out_amax: torch.Tensor) -> int:
    """The kernel's conditions on a call whose ``xq`` is padded to the
    weight's K: :func:`_check_pre`'s for a bf16 product with no residual,
    N % 16 == 0 (fc2 then reads the rows without ``match_k``'s pad), ``act``
    quick_gelu or gelu_tanh, ``out_amax`` one float32 value on xq's device.
    Returns the stride of the row scales."""
    what = "q_matmul_pre_act_q8"
    stride = _check_pre(xq, x_scale, wq_t, w_scale, bias, None, torch.bfloat16, what)
    if wq_t.shape[0] % 16 or act not in _HIDDEN_ACTS:
        raise ValueError(f"{what}: N={wq_t.shape[0]} must be a multiple of 16 and act one of "
                         f"{sorted(_HIDDEN_ACTS)} (got {act!r})")
    if (not torch.is_tensor(out_amax) or out_amax.device != xq.device
            or out_amax.dtype != torch.float32 or out_amax.numel() != 1):
        raise ValueError(f"{what}: out_amax must be one float32 value on {xq.device}")
    return stride


def q_matmul_pre_act_q8(xq: torch.Tensor, x_scale: torch.Tensor, wq_t: torch.Tensor,
                        w_scale: torch.Tensor, bias: torch.Tensor | None, act: str,
                        out_amax: torch.Tensor) -> torch.Tensor:
    """int8_static's fc1 with its int8 hidden: int8 [M, K] rows with their
    per-tensor (or [M, 1]) ``x_scale``, wq_t [N, K] int8, w_scale and bias
    [N] float32, ``act`` quick_gelu or gelu_tanh, ``out_amax`` fc2's
    calibrated input amax (one float32 value) → the int8 [M, N] fc2 takes
    under ``out_amax · (1/127)``. On the CPU :func:`q_matmul_pre_act_q8_plain`;
    on the card :func:`_hidden_table`'s few 65,536-entry passes and one
    launch of K9's GEMM that reads it in its epilogue (counted in
    ``launches``), the same bits, on inputs :func:`_check_hidden_q8` passes
    (it raises on others)."""
    if xq.device.type == "cpu":
        return q_matmul_pre_act_q8_plain(xq, x_scale, wq_t, w_scale, bias, act, out_amax)
    if not xq.is_cuda:
        raise ValueError(f"q_matmul_pre_act_q8: unsupported device {xq.device}")
    xq = match_k(xq, wq_t)
    stride = _check_hidden_q8(xq, x_scale, wq_t, w_scale, bias, act, out_amax)
    table = _hidden_table(act, out_amax)
    m, n, k = xq.shape[0], wq_t.shape[0], xq.shape[1]
    out = torch.empty((m, n), dtype=torch.int8, device=xq.device)
    with torch.cuda.device(xq.device):
        err = _gemm_lib().q_gemm_hidden_q8(
            xq.data_ptr(), wq_t.data_ptr(), x_scale.data_ptr(), stride, w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), table.data_ptr(), out.data_ptr(), m, n, k,
            torch.cuda.current_stream(xq.device).cuda_stream,
        )
    _cuda_build.check(err, "q_matmul_pre_act_q8")
    q_matmul_pre_act_q8.launches += 1
    return out


q_matmul_pre_act_q8.launches = 0
