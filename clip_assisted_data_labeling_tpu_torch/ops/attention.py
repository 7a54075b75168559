"""Packed multi-head attention — kernel K1 (port of the JAX package's
``ops/attention.py`` packed path).

``fused_attention_packed`` replaces the TPU kernel ``_packed_kernel`` /
``fused_attention_packed`` (clip_assisted_data_labeling_tpu/ops/attention.py,
``pallas_call`` at :1124) with the hand-written CUDA kernel in
``csrc/packed_attention.cu``; its header says what bounds the kernel on the
H100 and how the design answers that. The TPU's VMEM routing (whole-block /
head-grouped / flash fallbacks, query-row tiles, token padding) does not
carry over: bfloat16 (tensor cores) takes any sequence length; float32 (CUDA
cores) any whose [16, S] float32 score tile fits a block's 227 KB of shared
memory (S up to ~3000 at head dim 64).

Dispatch: a CPU tensor goes to the plain PyTorch version beside the kernel;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from clip_assisted_data_labeling_tpu_torch.ops import _cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_packed_plain(qkv: torch.Tensor, heads: int, scale: float,
                                 s_real: int | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: q·scale in the input dtype,
    float32 scores with an exact -inf mask on keys ≥ s_real, float32 softmax
    statistics, P cast to v's dtype before P·V, 1/sum applied after."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    d = w // heads
    s_real = s if s_real is None else s_real

    def split(t):
        return t.reshape(b, s, heads, d).permute(0, 2, 1, 3)

    q, k, v = (split(t) for t in qkv.split(w, dim=-1))
    q = q * torch.tensor(scale, dtype=qkv.dtype, device=qkv.device)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if s_real < s:
        scores[..., s_real:] = float("-inf")
    m = scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores - m)
    inv_norm = 1.0 / probs.sum(dim=-1, keepdim=True)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()) * inv_norm
    return out.to(qkv.dtype).permute(0, 2, 1, 3).reshape(b, s, w)


def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("packed_attention")
    if lib.packed_attention.argtypes is None:
        lib.packed_attention.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.packed_attention.restype = ctypes.c_int
        lib.packed_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.packed_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def fused_attention_packed(qkv: torch.Tensor, heads: int, scale: float,
                           s_real: int | None = None) -> torch.Tensor:
    """Multi-head attention on the packed qkv tensor [B, S, 3w] → [B, S, w].

    ``s_real``: keys at or beyond it are masked out of the softmax (rows
    there compute values nothing should read)."""
    if qkv.device.type == "cpu":
        return fused_attention_packed_plain(qkv, heads, scale, s_real)
    if not qkv.is_cuda:
        raise ValueError(f"fused_attention_packed: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.dtype not in _DTYPE_CODE or not qkv.is_contiguous():
        raise ValueError(
            "fused_attention_packed wants a contiguous [B, S, 3w] float32 or "
            f"bfloat16 tensor, got {tuple(qkv.shape)} {qkv.dtype} "
            f"contiguous={qkv.is_contiguous()}"
        )
    b, s, w3 = qkv.shape
    w = w3 // 3
    s_real = s if s_real is None else s_real
    if w3 % 3 or w % heads or w // heads > 128 or not 1 <= s_real <= s:
        raise ValueError(
            f"fused_attention_packed: bad shape {tuple(qkv.shape)} for {heads} "
            f"heads, s_real={s_real} (head dim must be <= 128)"
        )
    lib = _lib()
    if qkv.dtype == torch.float32:
        smem = lib.packed_attention_smem_bytes(s, w // heads)
        if smem > _cuda_build.SMEM_LIMIT:
            raise ValueError(
                f"fused_attention_packed: float32 S={s} needs {smem} B of shared memory "
                f"for its score tile, over the {_cuda_build.SMEM_LIMIT} B a block may use"
            )
    elif (w // heads) % 8 or qkv.data_ptr() % 16:
        raise ValueError(
            "fused_attention_packed: the bfloat16 kernel reads 16-byte vectors — "
            f"head dim {w // heads} must be a multiple of 8 and the data 16-byte aligned"
        )
    out = torch.empty((b, s, w), dtype=qkv.dtype, device=qkv.device)
    err = lib.packed_attention(
        qkv.data_ptr(), out.data_ptr(), _DTYPE_CODE[qkv.dtype], b, s, s_real, w,
        heads, float(scale), torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _cuda_build.check(err, "packed_attention")
    fused_attention_packed.launches += 1
    return out


fused_attention_packed.launches = 0


def packed_attention_auto(qkv: torch.Tensor, heads: int, scale: float,
                          s_real: int | None = None) -> torch.Tensor:
    """The JAX package routes by VMEM budget between three kernels; on the
    H100 the packed kernel serves every sequence of the CLIP ViT family."""
    return fused_attention_packed(qkv, heads, scale, s_real)
