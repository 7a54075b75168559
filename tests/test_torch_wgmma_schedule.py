"""An emulation, in torch on the CPU, of the schedule of the bfloat16 attention
kernel that K1, K4, K5 and K10 share (``exact_wgmma_kernel`` in
csrc/attention_common.cuh): 128-row query tiles; 64-key chunks, the last one
cut at the panel's end (keys past it load as zeros and are masked, so S=577
leaves a one-key tail); float32 scores of the bf16 q·T(scale) (rotated with
RoPE) against bf16 k; per k panel (K5: ``flash_panel`` keys; K1: all S) the
row max over the panel's chunks, the running sum and output rescaled once by
exp(m − m'), then P = bf16(exp(s − m')) against that max, its unrounded sum,
and P·V added to the float32 output chunk by chunk; K5 divides by the sum,
K1 multiplies by its reciprocal. The card tests (tests/test_torch_cuda.py)
hold the kernel itself to account; this pins the arithmetic its schedule
computes, at ViT-L-14-336's and PE-Core-L14-336's head shapes (K1) and
ViT-SO400M-14-SigLIP-384's (K5), within the bf16 kernels' 2e-2 of the port's
plain versions and of the JAX package's Pallas kernels in interpret mode.

The int8 wires run the same schedule on heads dequantized first, as their
kernels convert each chunk to bf16 in shared memory: K3 per channel
(bf16(f32(x)·cs), the attention scale in cs[:w]), dividing by the sum and
rounding to int8; K7 per token (q by bf16(f32(x)·(ts·scale)), ts·scale formed
first; k and v by ts), multiplying by the reciprocal, to bf16, float32 or
quant_out's int8 rows. Each is held to its kernel's limits against the plain
version and the JAX kernel: K3 ±1 on ≤ 0.1% of entries; K7 bf16 within
max(2e-2, 2^-7·|ref|) of each value, float32 within 2e-2, quant_out ±1 on
≤ 0.1% with scales within 2^-8 relative and 1e-5 on ≥ 95% of tokens."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.ops.attention import (
    flash_attention_packed as jax_flash_attention_packed,
)
from clip_assisted_data_labeling_tpu.ops.attention import (
    fused_attention_packed as jax_fused_attention_packed,
)
from clip_assisted_data_labeling_tpu.ops.attention import (
    fused_attention_packed_q8 as jax_fused_attention_packed_q8,
)
from clip_assisted_data_labeling_tpu.ops.attention import (
    fused_attention_packed_q8s as jax_fused_attention_packed_q8s,
)
from clip_assisted_data_labeling_tpu_torch.models.vit import _rope2d_tables
from clip_assisted_data_labeling_tpu_torch.ops.attention import (
    _merge_heads,
    _rot_half,
    _split_heads,
    flash_attention_packed_plain,
    flash_panel,
    fused_attention_packed_plain,
    fused_attention_packed_q8_plain,
    fused_attention_packed_q8s_plain,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import rowquant_plain

TOL = 2e-2  # the bf16 kernels' limit against their plain versions
Q_TILE, CHUNK = 128, 64  # WG_Q and WG_K of the kernel

# (kernel, S, s_real, heads, head dim, RoPE grid with a cls row or None;
# K7's: its output, bfloat16, float32 or quant_out)
CASES = {
    "vit_l14_336": ("K1", 577, 577, 2, 64, None),         # a one-key tail chunk
    "vit_l14_336_masked": ("K1", 577, 500, 2, 64, None),  # keys past s_real masked
    "pe_l14_336_rope": ("K1", 577, 577, 2, 64, 24),
    "so400m_384": ("K5", 729, 729, 2, 72, None),          # 368-key panels, d padded to 80
    "so400m_384_masked": ("K5", 729, 700, 2, 72, None),
    # the int8 wires: SO400M-384's int8_static route (K3), and L-336's wire route
    "so400m_384_q8s": ("K3", 729, 729, 2, 72, None),
    "so400m_384_q8s_masked": ("K3", 729, 700, 2, 72, None),
    "vit_l14_336_q8s": ("K3", 577, 577, 2, 64, None),
    "vit_l14_336_q8": ("K7", 577, 577, 2, 64, "bfloat16"),
    "vit_l14_336_q8_quant_out": ("K7", 577, 577, 2, 64, "quant_out"),
    "so400m_384_q8_masked": ("K7", 729, 700, 2, 72, "float32"),
}
FLIP_SHARE = 1e-3  # int8 outputs: ±1 on at most this share of entries


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [..., m, d] with zero rows appended up to n (a chunk's keys past
    the panel's end load as zeros)."""
    return torch.cat([x, x.new_zeros(x.shape[:-2] + (n - x.shape[-2], x.shape[-1]))], dim=-2)


def _schedule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, s_real: int,
              panel: int | None, divide: bool) -> torch.Tensor:
    """The kernel's schedule on bf16 heads [B, h, S, d] (q scaled and
    rotated, or dequantized) to the float32 head outputs: ``panel`` None is
    one pass pair over all S keys, else K5's panels of that many keys;
    ``divide`` by the sum (K5, K3) or multiply by its reciprocal."""
    s = q.shape[2]
    width = s if panel is None else panel
    tiles = []
    for t0 in range(0, s, Q_TILE):
        qt = q[:, :, t0:t0 + Q_TILE].float()
        m = torch.full(qt.shape[:-1] + (1,), float("-inf"))
        l = torch.zeros(qt.shape[:-1] + (1,))
        o = torch.zeros(qt.shape)
        for p0 in range(0, s, width):
            pend, kend = min(p0 + width, s), min(p0 + width, s, s_real)
            chunks = []
            for c0 in range(p0, pend, CHUNK):
                c1 = min(c0 + CHUNK, pend)
                sc = torch.matmul(qt, _padded(k[:, :, c0:c1], CHUNK).float().transpose(-1, -2))
                sc[..., max(kend - c0, 0):] = float("-inf")
                chunks.append((_padded(v[:, :, c0:c1], CHUNK), sc))
            m_new = torch.stack([sc.amax(dim=-1, keepdim=True) for _, sc in chunks]).amax(dim=0)
            if panel is not None:  # the running max and the rescale by exp(m - m')
                m_new = torch.maximum(m, m_new)
                alpha = torch.exp(m - m_new)
                l, o = l * alpha, o * alpha
            m = m_new
            for vc, sc in chunks:
                p = torch.exp(sc - m)
                l = l + p.sum(dim=-1, keepdim=True)
                o = o + torch.matmul(p.to(q.dtype).float(), vc.float())
        tiles.append(o / l if divide else o * (1.0 / l))
    return torch.cat(tiles, dim=2)


def _emulated(qkv: torch.Tensor, heads: int, scale: float, s_real: int, rope,
              panel: int | None) -> torch.Tensor:
    """The kernel's schedule on bf16 qkv [B, S, 3w]: ``panel`` None is K1's
    (one pass pair over all S keys), else K5's panels of that many keys."""
    q, k, v = _split_heads(qkv, heads)
    q = q * torch.tensor(scale, dtype=qkv.dtype)
    if rope is not None:
        cos, sin = (t.to(qkv.dtype) for t in rope)
        q, k = _rot_half(q, cos, sin), _rot_half(k, cos, sin)
    o = _schedule(q, k, v, s_real, panel, divide=panel is not None)
    return _merge_heads(o).to(qkv.dtype)


def _emulated_q8(kernel: str, qkv: torch.Tensor, sc: torch.Tensor, heads: int, scale: float,
                 s_real: int, out: str | None):
    """The int8 wires' schedule on int8 qkv [B, S, 3w]: K3 with the folded
    channel scales sc [3w] to int8 [B, S, w]; K7 with the token scales sc
    [B, S, 1] to ``out``."""
    f = qkv.float()
    if kernel == "K3":
        deq = (f * sc).to(torch.bfloat16)
    else:
        w = qkv.shape[-1] // 3
        deq = torch.cat([(f[..., :w] * (sc * scale)).to(torch.bfloat16),
                         (f[..., w:] * sc).to(torch.bfloat16)], dim=-1)
    o = _merge_heads(_schedule(*_split_heads(deq, heads), s_real, None, divide=kernel == "K3"))
    if kernel == "K3":
        return o.round().clamp(-127, 127).to(torch.int8)
    if out != "quant_out":
        return o.to(getattr(torch, out))
    b, s, w = o.shape
    q, qs = rowquant_plain(o.reshape(b * s, w))
    return q.reshape(b, s, w), qs.reshape(b, s, 1)


def _inputs(case: str):
    kernel, s, s_real, heads, d, grid = CASES[case]
    qkv = torch.from_numpy(np.random.default_rng(s + s_real).normal(
        0, 1, (1, s, 3 * heads * d)).astype(np.float32)).to(torch.bfloat16)
    rope = (None if grid is None else
            tuple(torch.from_numpy(t) for t in _rope2d_tables(grid, d, 10000.0, True)))
    return kernel, qkv, heads, d ** -0.5, s_real, rope


def _jax(kernel: str, qkv: torch.Tensor, heads: int, scale: float, s_real: int, rope):
    fn = jax_fused_attention_packed if kernel == "K1" else jax_flash_attention_packed
    out = fn(jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16), heads=heads, scale=scale,
             s_real=s_real, interpret=True,
             rope=None if rope is None else tuple(jnp.asarray(t.numpy()) for t in rope))
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _q8_inputs(case: str):
    """K3: int8 qkv and folded channel scales with scores of std ~3 and
    outputs over much of the int8 range; K7: a per-token quantize of normal
    values and its [B, S, 1] scales, with scores of std ~2 (as the kernel
    tests make them)."""
    kernel, s, s_real, heads, d, out = CASES[case]
    rng = np.random.default_rng(s + s_real)
    w = heads * d
    if kernel == "K3":
        qkv = rng.integers(-127, 128, (1, s, 3 * w)).astype(np.int8)
        sc = np.concatenate([rng.uniform(0.5, 1.5, 2 * w) * 8e-3,
                             rng.uniform(0.5, 1.5, w) * 0.5]).astype(np.float32)
    else:
        x = rng.normal(0, 1, (1, s, 3 * w)).astype(np.float32)
        amax = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8)
        qkv = np.clip(np.round(x / (amax / 127)), -127, 127).astype(np.int8)
        sc = (amax / 127 * 1.7).astype(np.float32)
    return kernel, torch.from_numpy(qkv), torch.from_numpy(sc), heads, d ** -0.5, s_real, out


def _q8_reference(ref: str, kernel: str, qkv, sc, heads: int, scale: float, s_real: int,
                  out: str | None):
    if ref == "plain" and kernel == "K3":
        return fused_attention_packed_q8s_plain(qkv, sc, heads, s_real)
    if ref == "plain":
        kw = {"quant_out": True} if out == "quant_out" else {"out_dtype": getattr(torch, out)}
        return fused_attention_packed_q8_plain(qkv, sc, heads, scale, s_real=s_real, **kw)
    if kernel == "K3":
        got = jax_fused_attention_packed_q8s(jnp.asarray(qkv.numpy()), jnp.asarray(sc.numpy()),
                                             heads=heads, scale=scale, interpret=True,
                                             s_real=s_real)
        return torch.from_numpy(np.array(got))
    got = jax_fused_attention_packed_q8(
        jnp.asarray(qkv.numpy()), jnp.asarray(sc.numpy()), heads=heads, scale=scale,
        interpret=True, s_real=s_real, quant_out=out == "quant_out",
        out_dtype=jnp.float32 if out == "float32" else jnp.bfloat16)
    if out == "quant_out":
        return tuple(torch.from_numpy(np.array(t)) for t in got)
    return torch.from_numpy(np.array(got.astype(jnp.float32))).to(getattr(torch, out))


def _flips(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of int8 entries off by one; fails on any off by more."""
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1
    return (diff > 0).float().mean().item()


def _check_q8(case: str, ref: str):
    kernel, qkv, sc, heads, scale, s_real, out = _q8_inputs(case)
    got = _emulated_q8(kernel, qkv, sc, heads, scale, s_real, out)
    want = _q8_reference(ref, kernel, qkv, sc, heads, scale, s_real, out)
    if kernel == "K3":
        assert got.dtype == torch.int8 and want.abs().float().mean().item() > 5
        assert _flips(got[:, :s_real], want[:, :s_real]) <= FLIP_SHARE, case
    elif out == "quant_out":
        (q, qs), (wq, wqs) = got, want
        assert _flips(q[:, :s_real], wq[:, :s_real]) <= FLIP_SHARE, case
        rel = (qs[:, :s_real] / wqs[:, :s_real] - 1).abs()
        assert (rel > 1e-5).float().mean().item() <= 5e-2 and rel.max().item() <= 2.0 ** -8
    else:
        assert got.dtype == want.dtype == getattr(torch, out)
        err = (got.float() - want.float())[:, :s_real].abs()
        bound = (torch.clamp(2.0 ** -7 * want.float().abs(), min=2e-2)[:, :s_real]
                 if out == "bfloat16" else 2e-2)
        assert bool((err <= bound).all()), f"{case}: max abs err {err.max().item()} against {ref}"


@pytest.mark.parametrize("ref", ["plain", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wgmma_schedule_matches_reference(case, ref):
    if CASES[case][0] in ("K3", "K7"):
        _check_q8(case, ref)
        return
    kernel, qkv, heads, scale, s_real, rope = _inputs(case)
    panel = flash_panel(qkv.shape[1]) if kernel == "K5" else None
    if panel is not None:
        assert qkv.shape[1] > panel and panel % CHUNK  # panels end inside a chunk
    got = _emulated(qkv, heads, scale, s_real, rope, panel)
    if ref == "jax":
        want = _jax(kernel, qkv, heads, scale, s_real, rope)
    elif kernel == "K1":
        want = fused_attention_packed_plain(qkv, heads, scale, s_real, rope)
    else:
        want = flash_attention_packed_plain(qkv, heads, scale, s_real, rope)
    err = (got.float() - want.float())[:, :s_real].abs().max().item()
    assert err <= TOL, f"{case}: max abs err {err} against {ref}"
