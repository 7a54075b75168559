"""An error model of the 3xTF32 split products that the float32 kernels of K1,
K4, K10 and K5 run on the tensor cores (csrc/attention_common.cuh). Each float32
operand x splits into hi = tf32(x), rounded to nearest with ties away from
zero as ``cvt.rna.tf32.f32`` rounds, and lo = tf32(x - hi); a product is
a_lo·b_hi + a_hi·b_lo + a_hi·b_hi. The emulation applies that to both
products of K1's arithmetic (P kept in float32) and sums the products in
float64: it models the split, not the tensor core's own float32
accumulation, which the card tests (tests/test_torch_cuda.py) hold to
account. At ViT-L-14-336's head shape and PE-Core-G14-448's with RoPE it
stays within the kernels' 1e-5 of the port's plain version and of the JAX
package's ``attention_xla``; one TF32 pass does not. K5's schedule (the
online softmax rescaled at the ends of the JAX flash kernel's k panels, an
exact two-pass inside each panel over 32-key chunks cut at the panel's end,
each chunk's P·V summed apart) is emulated at ViT-SO400M-14-SigLIP-384's head
shape and PE-Core-G14-448's with RoPE, and held within 1e-5 of
``flash_attention_packed_plain`` and of the JAX ``flash_attention_packed``
run in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.ops.attention import attention_xla as jax_attention_xla
from clip_assisted_data_labeling_tpu.ops.attention import (
    flash_attention_packed as jax_flash_attention_packed,
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

TOL = 1e-5  # the float32 kernels' limit against their plain versions

# (S, heads, head dim, RoPE grid or None): ViT-L-14-336 (577 tokens of 16 heads of
# 64; two heads here) and PE-Core-G14-448 (1024 tokens, 16 heads of 96, RoPE)
CASES = {"vit_l14_336": (577, 2, 64, None), "pe_g14_448_rope": (1024, 2, 96, 32)}
# K5's: ViT-SO400M-14-SigLIP-384 (729 tokens, heads of 72: two 368-key panels)
# and PE-Core-G14-448 with RoPE (1024 tokens, heads of 96: four 256-key panels)
FLASH_CASES = {"so400m_384": (729, 2, 72, None), "pe_g14_448_rope": (1024, 2, 96, 32)}
CHUNK = 32  # keys per chunk of the float32 kernel (TF32_KEYS)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero: add half of the 13 dropped bits' range to the magnitude's
    bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b of float32 operands as the tensor cores take them: three TF32
    products (the split) or one, summed in float64, rounded to float32."""
    if not split:
        return (_tf32(a).double() @ _tf32(b).double()).float()
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


def _emulated_k1(qkv: torch.Tensor, heads: int, scale: float, rope, split: bool):
    """K1's float32 arithmetic (``_exact_heads_f32``) with its two products
    emulated on the tensor cores."""
    q, k, v = _split_heads(qkv, heads)
    q = q * torch.tensor(scale, dtype=torch.float32)
    if rope is not None:
        q, k = _rot_half(q, *rope), _rot_half(k, *rope)
    scores = _matmul(q, k.transpose(-1, -2), split)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    inv_norm = 1.0 / probs.sum(dim=-1, keepdim=True)
    return _merge_heads(_matmul(probs, v, split) * inv_norm)


def _emulated_k5(qkv: torch.Tensor, heads: int, scale: float, rope, split: bool):
    """K5's float32 schedule with its products emulated on the tensor cores:
    per k panel of ``flash_panel(S)`` keys, pass 1 takes the panel's row max
    m' = max(m, ·) over 32-key chunks cut at the panel's end, the sum l and
    the output o are rescaled once by exp(m − m'), and pass 2 adds each
    chunk's exp(s − m') to l and its P·V, a product of its own, to o in
    float32; o / l at the end."""
    q, k, v = _split_heads(qkv, heads)
    q = q * torch.tensor(scale, dtype=torch.float32)
    if rope is not None:
        q, k = _rot_half(q, *rope), _rot_half(k, *rope)
    s = q.shape[2]
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros(q.shape[:-1] + (1,))
    o = torch.zeros(q.shape)
    panel = flash_panel(s)
    for p0 in range(0, s, panel):
        chunks = [(c, min(c + CHUNK, p0 + panel, s)) for c in range(p0, min(p0 + panel, s),
                                                                     CHUNK)]
        scores = [_matmul(q, k[:, :, c0:c1].transpose(-1, -2), split) for c0, c1 in chunks]
        m_new = torch.maximum(m, torch.stack([t.amax(dim=-1, keepdim=True)
                                              for t in scores]).amax(dim=0))
        alpha = torch.exp(m - m_new)
        l, o, m = l * alpha, o * alpha, m_new
        for (c0, c1), sc in zip(chunks, scores):
            p = torch.exp(sc - m)
            l = l + p.sum(dim=-1, keepdim=True)
            o = o + _matmul(p, v[:, :, c0:c1], split)
    return _merge_heads(o / l)


def _inputs(case: str, cases=CASES):
    s, heads, d, grid = cases[case]
    qkv = torch.from_numpy(
        np.random.default_rng(s).normal(0, 1, (1, s, 3 * heads * d)).astype(np.float32))
    rope = (None if grid is None else
            tuple(torch.from_numpy(t) for t in _rope2d_tables(grid, d, 10000.0, False)))
    return qkv, heads, d ** -0.5, rope


def _jax_reference(qkv: torch.Tensor, heads: int, scale: float, rope) -> torch.Tensor:
    """The JAX package's ``attention_xla`` in float32 on the same q', k', v:
    q scaled (and q, k rotated) as the kernels do, then scale 1."""
    q, k, v = _split_heads(qkv, heads)
    q = q * torch.tensor(scale, dtype=torch.float32)
    if rope is not None:
        q, k = _rot_half(q, *rope), _rot_half(k, *rope)
    out = jax_attention_xla(*(jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)), 1.0)
    return _merge_heads(torch.from_numpy(np.array(out)))


@pytest.mark.parametrize("ref", ["plain", "jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_stays_within_float32(case, ref):
    qkv, heads, scale, rope = _inputs(case)
    got = _emulated_k1(qkv, heads, scale, rope, split=True)
    want = (fused_attention_packed_plain(qkv, heads, scale, None, rope) if ref == "plain"
            else _jax_reference(qkv, heads, scale, rope))
    err = (got - want).abs().max().item()
    assert err <= TOL, f"3xTF32 {case}: max abs err {err} against {ref}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_tf32_pass_misses_float32(case):
    """Why the kernels split: one TF32 product keeps 11 bits of each operand,
    and the outputs move by ~1e-4."""
    qkv, heads, scale, rope = _inputs(case)
    got = _emulated_k1(qkv, heads, scale, rope, split=False)
    err = (got - fused_attention_packed_plain(qkv, heads, scale, None, rope)).abs().max().item()
    assert err > 10 * TOL, f"one TF32 pass {case}: max abs err {err}"


@pytest.mark.parametrize("ref", ["plain", "jax"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_3xtf32_panels_stay_within_float32(case, ref):
    """K5's float32 kernel: the split products inside its panel schedule."""
    qkv, heads, scale, rope = _inputs(case, FLASH_CASES)
    assert qkv.shape[1] > flash_panel(qkv.shape[1])  # more than one panel
    got = _emulated_k5(qkv, heads, scale, rope, split=True)
    if ref == "plain":
        want = flash_attention_packed_plain(qkv, heads, scale, None, rope)
    else:
        want = torch.from_numpy(np.array(jax_flash_attention_packed(
            jnp.asarray(qkv.numpy()), heads, scale, interpret=True,
            rope=None if rope is None else tuple(jnp.asarray(t.numpy()) for t in rope))))
    err = (got - want).abs().max().item()
    assert err <= TOL, f"3xTF32 K5 {case}: max abs err {err} against {ref}"


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_one_tf32_pass_misses_float32_in_panels(case):
    qkv, heads, scale, rope = _inputs(case, FLASH_CASES)
    got = _emulated_k5(qkv, heads, scale, rope, split=False)
    err = (got - flash_attention_packed_plain(qkv, heads, scale, None, rope)).abs().max().item()
    assert err > 10 * TOL, f"one TF32 pass K5 {case}: max abs err {err}"
