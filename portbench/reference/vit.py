"""The ViT towers plainly, in float32 with TF32 off (the caller's
``reference.tf32(False)``): the patch embedding as a product over flattened
(row, column, channel) patches (a stride-p convolution; trailing pixels that
p does not divide are dropped), a class token where the tower has one, the
position embedding, pre-norm blocks (layernorm, multi-head attention, the
MLP with the tower's activation), and the readout: layernorm of the class row
and the projection (CLIP), or layernorm of every token and the attention-pool
head, ``h + mlp(ln(h))`` over the probe's attention, with no projection
(SigLIP). No calibration: the float32 forward is what int8_static
approximates. ``control=True`` runs it in bfloat16 with every block's four
linear layers on int4 (weights per output channel, inputs per token): one
step below the configuration's int8."""
from __future__ import annotations

import math

import torch


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "gelu_tanh":
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    if kind == "gelu":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    raise ValueError(f"unknown activation {kind!r}")


def _int4(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Symmetric int4 rounding (levels -7..7), one scale along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 7.0
    return torch.clamp(torch.round(t / scale), -7, 7) * scale


def _linear(x, kernel, bias, control: bool):
    if control:
        return _int4(x, -1) @ _int4(kernel, 0) + bias
    return x @ kernel + bias


def _attention(q, k, v, heads: int):
    """q [B, Sq, w], k and v [B, S, w] → [B, Sq, w]."""
    b, sq, w = q.shape
    d = w // heads
    q = q.reshape(b, sq, heads, d).transpose(1, 2)
    k = k.reshape(b, -1, heads, d).transpose(1, 2)
    v = v.reshape(b, -1, heads, d).transpose(1, 2)
    p = torch.softmax((q @ k.transpose(-1, -2)).float() * d ** -0.5, dim=-1).to(v.dtype)
    return (p @ v).transpose(1, 2).reshape(b, sq, w)


def encode(params: dict, cfg: dict, crops: torch.Tensor, control: bool = False) -> torch.Tensor:
    """[B, R, R, 3] normalized crops → [B, embed_dim] float32 unit embeddings."""
    dt = torch.bfloat16 if control else torch.float32
    P = {k: v.to(dt) for k, v in params.items()}
    w, heads, eps, p = cfg["width"], cfg["heads"], cfg["ln_eps"], cfg["patch_size"]
    b, res = crops.shape[0], crops.shape[1]
    g = res // p
    x = crops[:, : g * p, : g * p].to(dt).reshape(b, g, p, g, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3) @ P["patch_kernel"]
    if cfg["patch_bias"]:
        x = x + P["patch_bias"]
    if cfg["use_cls_token"]:
        x = torch.cat([P["class_emb"].expand(b, 1, w), x], dim=1)
    x = x + P["pos_emb"]
    if cfg["use_ln_pre"]:
        x = _ln(x, P["ln_pre_scale"], P["ln_pre_bias"], eps)
    for i in range(cfg["layers"]):
        def leaf(name):
            return P["blocks/" + name][i]
        h = _ln(x, leaf("ln1_scale"), leaf("ln1_bias"), eps)
        q, k, v = _linear(h, leaf("qkv_kernel"), leaf("qkv_bias"), control).split(w, dim=-1)
        x = x + _linear(_attention(q, k, v, heads), leaf("out_kernel"), leaf("out_bias"), control)
        h = _ln(x, leaf("ln2_scale"), leaf("ln2_bias"), eps)
        h = _act(_linear(h, leaf("fc1_kernel"), leaf("fc1_bias"), control), cfg["act"])
        x = x + _linear(h, leaf("fc2_kernel"), leaf("fc2_bias"), control)
    if cfg["pool"] == "map":
        x = _ln(x, P["ln_post_scale"], P["ln_post_bias"], eps)
        wq, wk, wv = P["pool_in_kernel"].split(w, dim=1)
        bq, bk, bv = P["pool_in_bias"].split(w)
        probe = (P["pool_probe"] @ wq + bq).expand(b, 1, w)
        h = _attention(probe, x @ wk + bk, x @ wv + bv, cfg["pool_heads"])[:, 0]
        h = h @ P["pool_out_kernel"] + P["pool_out_bias"]
        y = _ln(h, P["pool_ln_scale"], P["pool_ln_bias"], eps)
        y = _act(y @ P["pool_fc1_kernel"] + P["pool_fc1_bias"], cfg["act"])
        emb = h + (y @ P["pool_fc2_kernel"] + P["pool_fc2_bias"])
    else:
        emb = _ln(x[:, 0], P["ln_post_scale"], P["ln_post_bias"], eps)
    if cfg["use_proj"]:
        emb = emb @ P["proj"]
    emb = emb.float()
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
