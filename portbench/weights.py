"""A ViT tower's weights made on the device from the seed, in float32 (the
type the port's encoder takes them in; int8_static quantizes them itself), in
the flat parameter layout that ``CLIPImageEncoder(params=...)`` accepts: the
stacked ``blocks/<name>`` leaves [layers, ...], then the stem's and the
readout's. One ``randn`` call fills every leaf; each leaf is a view of it,
scaled as open_clip initializes it (normal at fan-in scale), with layernorm
scales at 1 + 0.05·N(0, 1) and biases at 0.02·N(0, 1), so the check sees every
bias and scale applied."""
from __future__ import annotations

import math

import torch

from portbench.synth import generator


def leaf_specs(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(key, shape, kind, std) of every leaf; kind 'w' (weight: N(0, std)),
    'b' (bias) or 's' (layernorm scale)."""
    w, layers, e, mlp = cfg["width"], cfg["layers"], cfg["embed_dim"], cfg["mlp_dim"]
    p = cfg["patch_size"]
    scale = w ** -0.5
    specs = [
        ("patch_kernel", (p * p * 3, w), "w", scale),
        ("pos_emb", (cfg["seq_len"], w), "w", scale),
        ("blocks/ln1_scale", (layers, w), "s", 0.0),
        ("blocks/ln1_bias", (layers, w), "b", 0.0),
        ("blocks/qkv_kernel", (layers, w, 3 * w), "w", scale),
        ("blocks/qkv_bias", (layers, 3 * w), "b", 0.0),
        ("blocks/out_kernel", (layers, w, w), "w", scale),
        ("blocks/out_bias", (layers, w), "b", 0.0),
        ("blocks/ln2_scale", (layers, w), "s", 0.0),
        ("blocks/ln2_bias", (layers, w), "b", 0.0),
        ("blocks/fc1_kernel", (layers, w, mlp), "w", (2 * w) ** -0.5),
        ("blocks/fc1_bias", (layers, mlp), "b", 0.0),
        ("blocks/fc2_kernel", (layers, mlp, w), "w", scale),
        ("blocks/fc2_bias", (layers, w), "b", 0.0),
        ("ln_post_scale", (w,), "s", 0.0),
        ("ln_post_bias", (w,), "b", 0.0),
    ]
    if cfg["use_cls_token"]:
        specs.append(("class_emb", (w,), "w", scale))
    if cfg["use_ln_pre"]:
        specs += [("ln_pre_scale", (w,), "s", 0.0), ("ln_pre_bias", (w,), "b", 0.0)]
    if cfg["use_proj"]:
        specs.append(("proj", (w, e), "w", scale))
    if cfg["patch_bias"]:
        specs.append(("patch_bias", (w,), "b", 0.0))
    if cfg["pool"] == "map":
        specs += [
            ("pool_probe", (w,), "w", 0.02),
            ("pool_in_kernel", (w, 3 * w), "w", scale),
            ("pool_in_bias", (3 * w,), "b", 0.0),
            ("pool_out_kernel", (w, w), "w", scale),
            ("pool_out_bias", (w,), "b", 0.0),
            ("pool_ln_scale", (w,), "s", 0.0),
            ("pool_ln_bias", (w,), "b", 0.0),
            ("pool_fc1_kernel", (w, mlp), "w", (2 * w) ** -0.5),
            ("pool_fc1_bias", (mlp,), "b", 0.0),
            ("pool_fc2_kernel", (mlp, w), "w", scale),
            ("pool_fc2_bias", (w,), "b", 0.0),
        ]
    elif cfg["pool"] != "cls":
        raise ValueError(f"no weights for pool {cfg['pool']!r}")
    return specs


def vit_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf of the tower ``cfg`` from one float32 ``randn`` on ``device``."""
    specs = leaf_specs(cfg)
    sizes = [math.prod(shape) for _k, shape, _kind, _std in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, "weights"),
                       device=device)
    params, at = {}, 0
    for (key, shape, kind, std), size in zip(specs, sizes):
        leaf = flat[at: at + size].view(shape)
        at += size
        if kind == "w":
            leaf.mul_(std)
        elif kind == "b":
            leaf.mul_(0.02)
        else:
            leaf.mul_(0.05).add_(1.0)
        params[key] = leaf
    return params
