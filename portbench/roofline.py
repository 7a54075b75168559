"""Peaks and the least work of each measured piece, from shapes alone.

Peaks are the NVIDIA H100 SXM data sheet's dense rates (no sparsity) at its
700 W limit; :func:`power_limit` reads the card's own limit, which the
harness prints beside them. The operation counts follow ``chip_smoke.py``'s
bound arithmetic: a kernel's minimal FLOPs and bytes from its shapes, each
input byte read once and each output byte written once; the least time is
the larger of operations over the peak of their type and bytes over the
memory rate.
"""
from __future__ import annotations

import subprocess

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 494.7e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, peak: float, nbytes: float) -> float:
    """The least seconds: operations over ``peak`` or bytes over the memory
    rate, whichever is larger."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def vit_image_work(cfg: dict, n_crops: int) -> dict:
    """The least work of one image through a ViT tower (``n_crops`` forwards):
    ``int8_ops``, the linear layers' 2·M·N·K (qkv, out, fc1, fc2: the sites
    int8_static quantizes), and ``bf16_flops``, attention's 4·S²·W a layer
    (Q·Kᵀ and P·V) plus the patch embedding's 2·patches·(p²·3)·W. The readout
    is left out (one row of the S)."""
    w, s, layers, mlp = cfg["width"], cfg["seq_len"], cfg["layers"], cfg["mlp_dim"]
    patches = (cfg["image_size"] // cfg["patch_size"]) ** 2
    linear = 2 * s * (4 * w * w + 2 * w * mlp) * layers
    attention = 4 * s * s * w * layers
    patch_embed = 2 * patches * cfg["patch_size"] ** 2 * 3 * w
    return {"int8_ops": n_crops * linear, "bf16_flops": n_crops * (attention + patch_embed)}


def vit_image_bound_s(cfg: dict, n_crops: int) -> float:
    """The least seconds an image takes at the peaks: its int8 operations at
    the int8 rate plus its bf16 operations at the bf16 rate."""
    work = vit_image_work(cfg, n_crops)
    return work["int8_ops"] / PEAK_OPS["int8"] + work["bf16_flops"] / PEAK_OPS["bf16"]


def attention_launch_s(b: int, s: int, w: int, in_bytes: int, out_bytes: int) -> float:
    """The least seconds of one packed attention launch over [b, s, 3w]:
    4·b·s²·w FLOPs at the bf16 rate (the int8 wire's kernel computes in bf16
    too), the packed q, k, v read once and the [b, s, w] output written once."""
    return bound_s(4.0 * b * s * s * w, PEAK_OPS["bf16"],
                   b * s * 3 * w * in_bytes + b * s * w * out_bytes)


def scan_work(n: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one all-pairs scan on the int8 wire: the N(N−1)/2
    pairs' d-long dot products at 2 operations an element, and the N·d int8
    rows read once."""
    return n * (n - 1) / 2 * d * 2.0, float(n * d)


def scan_bound_s(n: int, d: int) -> float:
    ops, nbytes = scan_work(n, d)
    return bound_s(ops, PEAK_OPS["int8"], nbytes)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
