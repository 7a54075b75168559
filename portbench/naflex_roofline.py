"""The least work of the NaFlex cells, from shapes and the window's real
lengths, at ``roofline``'s peaks (every product of a bfloat16 tower at the
bf16 rate). ``roofline.vit_image_work`` counts a fixed-length tower at the
configuration's ``seq_len`` and leaves out the readout; here each sequence
counts at its own length, the native rows' position resize and every MAP
head included."""
from __future__ import annotations

from portbench.roofline import PEAK_OPS, bound_s


def tower_flops(cfg: dict, n: int) -> float:
    """FLOPs of one sequence of ``n`` real tokens through the tower: the
    patch embedding 2·n·(p²·3)·w; a layer's linear products 2·n·(4w² +
    2w·mlp) and attention 4·n²·w (Q·Kᵀ and P·V); the MAP head: the keys and
    values of the n tokens 4·n·w², the probe's scores and sum 4·n·w, its
    query, output and MLP 2·(2w² + 2w·mlp)."""
    w, mlp, p = cfg["width"], cfg["mlp_dim"], cfg["patch_size"]
    block = 2 * n * (4 * w * w + 2 * w * mlp) + 4 * n * n * w
    head = 4 * n * w * w + 4 * n * w + 2 * (2 * w * w + 2 * w * mlp)
    return 2 * n * p * p * 3 * w + cfg["layers"] * block + head


def native_flops(cfg: dict, n: int) -> float:
    """A native row of ``n`` real patches: the tower, and the position
    table resized to its grid (an [n, grid²] by [grid², w] product)."""
    return tower_flops(cfg, n) + 2 * n * cfg["position_grid"] ** 2 * cfg["width"]


def window_bound_s(cfg: dict, crops: int, native_lengths: list[int]) -> float:
    """The least seconds of ``crops`` square crops at ``seq_len`` and the
    native rows of ``native_lengths`` patches, at the bf16 peak."""
    flops = crops * tower_flops(cfg, cfg["seq_len"])
    flops += sum(native_flops(cfg, n) for n in native_lengths)
    return flops / PEAK_OPS["bf16"]


def attention_bound_s(lengths: list[int], w: int, elem_bytes: int = 2) -> float:
    """One packed attention launch over sequences of the real ``lengths``:
    Σ 4·n²·w FLOPs at the bf16 peak, or the real tokens' q, k, v read once
    and their outputs written once, whichever takes longer."""
    return bound_s(sum(4.0 * n * n * w for n in lengths), PEAK_OPS["bf16"],
                   sum(n * 4 * w * elem_bytes for n in lengths))
