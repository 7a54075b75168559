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
plain versions and of the JAX package's Pallas kernels in interpret mode."""
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
from clip_assisted_data_labeling_tpu_torch.models.vit import _rope2d_tables
from clip_assisted_data_labeling_tpu_torch.ops.attention import (
    _merge_heads,
    _rot_half,
    _split_heads,
    flash_attention_packed_plain,
    flash_panel,
    fused_attention_packed_plain,
)

TOL = 2e-2  # the bf16 kernels' limit against their plain versions
Q_TILE, CHUNK = 128, 64  # WG_Q and WG_K of the kernel

# (kernel, S, s_real, heads, head dim, RoPE grid with a cls row or None)
CASES = {
    "vit_l14_336": ("K1", 577, 577, 2, 64, None),         # a one-key tail chunk
    "vit_l14_336_masked": ("K1", 577, 500, 2, 64, None),  # keys past s_real masked
    "pe_l14_336_rope": ("K1", 577, 577, 2, 64, 24),
    "so400m_384": ("K5", 729, 729, 2, 72, None),          # 368-key panels, d padded to 80
    "so400m_384_masked": ("K5", 729, 700, 2, 72, None),
}


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [..., m, d] with zero rows appended up to n (a chunk's keys past
    the panel's end load as zeros)."""
    return torch.cat([x, x.new_zeros(x.shape[:-2] + (n - x.shape[-2], x.shape[-1]))], dim=-2)


def _emulated(qkv: torch.Tensor, heads: int, scale: float, s_real: int, rope,
              panel: int | None) -> torch.Tensor:
    """The kernel's schedule on bf16 qkv [B, S, 3w]: ``panel`` None is K1's
    (one pass pair over all S keys), else K5's panels of that many keys."""
    q, k, v = _split_heads(qkv, heads)
    q = q * torch.tensor(scale, dtype=qkv.dtype)
    if rope is not None:
        cos, sin = (t.to(qkv.dtype) for t in rope)
        q, k = _rot_half(q, cos, sin), _rot_half(k, cos, sin)
    s = qkv.shape[1]
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
                o = o + torch.matmul(p.to(qkv.dtype).float(), vc.float())
        tiles.append(o * (1.0 / l) if panel is None else o / l)
    return _merge_heads(torch.cat(tiles, dim=2)).to(qkv.dtype)


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


@pytest.mark.parametrize("ref", ["plain", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wgmma_schedule_matches_reference(case, ref):
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
