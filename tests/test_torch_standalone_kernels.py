"""The kernels that no entry point of the JAX package calls — K8 (the fused
block linear ``q_block_linear``), K7 (``fused_attention_packed_q8``), K10
(``fused_attention``) — and K5's RoPE option: each plain version against the
JAX Pallas function in interpret mode, from numpy inputs made from a seed;
and ``packed_attention_auto`` with RoPE on the flash route."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.ops import attention as jattn
from clip_assisted_data_labeling_tpu.ops.quant import quantize_weight
from clip_assisted_data_labeling_tpu.ops.quant_kernel import q_block_linear as jax_qbl
from clip_assisted_data_labeling_tpu.ops.quant_kernel import rowquant as jax_rowquant
from clip_assisted_data_labeling_tpu_torch.models.vit import _rope2d_tables
from clip_assisted_data_labeling_tpu_torch.ops import attention as tattn
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    q_block_linear,
    q_block_linear_plain,
    rowquant_plain,
)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FLIP_SHARE = 1e-3  # int8 values may differ by ±1 on at most this share of entries


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(JDT[dtype])


# ---- K8: q_block_linear -----------------------------------------------------

M, K, N = 40, 128, 256


def _flip_tol(amax, w_scale, n_flips=2, base=2e-3):
    """tests/test_quant_kernel.py's tolerance: one flipped int8 input
    decision at (i, k) moves y[i, j] by at most amax_i·ws_j; two a row."""
    return base + n_flips * amax * np.asarray(w_scale).reshape(1, -1)


def _input_flip_rows(x, dtype, lns, lnb):
    """Rows whose prologue quantize rounds differently in the two packages
    (the JAX K6 in interpret mode runs K8's prologue arithmetic), and each
    row's amax [M, 1] there."""
    jq, _ = jax_rowquant(_j(x, dtype), None if lns is None else _j(lns),
                         None if lnb is None else _j(lnb), block_m=8, interpret=True)
    tq, ts = rowquant_plain(_t(x, dtype), None if lns is None else _t(lns),
                            None if lnb is None else _t(lnb))
    return (np.asarray(jq) != tq.numpy()).any(axis=1), ts.numpy() * 127


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", [
    "ln", "residual", "ln_gelu_tanh_residual_bf16", "int8_in",
    "quick_gelu_quant_out", "gelu_tanh_quant_out", "gelu_quant_out", "ln_residual_quant_out",
])
def test_q_block_linear_plain_matches_jax(rng, variant, dtype):
    """Every variant of the TPU kernel's own test (ln, residual, act with
    quant_out, int8 input) and combinations of them, float32 or bfloat16 in.
    Rows whose input quantize rounds alike in both packages: float32 out
    within 1e-5 relative, bfloat16 out within one bf16 step, int8 out ±1 on
    ≤ 0.1% of entries with row scales within 1e-6; the other rows (none, as
    a rule) within the flip-aware tolerance of tests/test_quant_kernel.py."""
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    wq, ws = quantize_weight(rng.normal(0, 0.05, (K, N)).astype(np.float32))
    b = rng.normal(0, 0.1, (N,)).astype(np.float32)
    ln = variant.startswith("ln")
    lns = rng.normal(1, 0.1, (K,)).astype(np.float32) if ln else None
    lnb = rng.normal(0, 0.1, (K,)).astype(np.float32) if ln else None
    res = rng.normal(0, 1, (M, N)).astype(np.float32) if "residual" in variant else None
    act = {"ln_gelu_tanh_residual_bf16": "gelu_tanh", "quick_gelu_quant_out": "quick_gelu",
           "gelu_tanh_quant_out": "gelu_tanh", "gelu_quant_out": "gelu"}.get(variant)
    quant_out = variant.endswith("quant_out")
    out_dtype = torch.bfloat16 if variant.endswith("bf16") else torch.float32
    x_scale = None
    if variant == "int8_in":  # the int8 rows and scales of a quant_out linear
        hq, hs = rowquant_plain(_t(x, dtype))
        x, x_scale = hq.numpy(), hs.numpy()
    kw = dict(act=act, quant_out=quant_out)
    ref = jax_qbl(_j(x, None if x_scale is not None else dtype), _j(wq), _j(ws), _j(b),
                  x_scale=None if x_scale is None else _j(x_scale),
                  ln_scale=None if lns is None else _j(lns),
                  ln_bias=None if lnb is None else _j(lnb),
                  residual=None if res is None else _j(res), block_m=8, interpret=True,
                  out_dtype=JDT[out_dtype], **kw)
    got = q_block_linear(_t(x, None if x_scale is not None else dtype), _t(wq.T), _t(ws), _t(b),
                         x_scale=None if x_scale is None else _t(x_scale),
                         ln_scale=None if lns is None else _t(lns),
                         ln_bias=None if lnb is None else _t(lnb),
                         residual=None if res is None else _t(res), out_dtype=out_dtype, **kw)
    flipped, amax = ((np.zeros(M, bool), x_scale * 127) if x_scale is not None
                     else _input_flip_rows(x, dtype, lns, lnb))
    assert flipped.mean() <= 0.1
    if quant_out:
        (gq, gs), (rq, rs) = got, ref
        assert gq.dtype == torch.int8 and gq.shape == (M, N) and gs.shape == (M, 1)
        gq, gs, rq, rs = gq.numpy(), gs.numpy(), np.asarray(rq), np.asarray(rs)
        diff = np.abs(gq.astype(np.int32) - rq.astype(np.int32))[~flipped]
        assert diff.max(initial=0) <= 1 and (diff > 0).mean() <= FLIP_SHARE
        np.testing.assert_allclose(gs[~flipped], rs[~flipped], rtol=1e-6)
        tol = np.maximum(gs, rs) + _flip_tol(amax, ws) * 1.2  # an output step + input flips
        assert np.all((np.abs(gq * gs - rq * rs) <= tol)[flipped])
        return
    assert got.dtype == out_dtype and got.shape == (M, N)
    got, ref = got.float().numpy(), np.asarray(ref).astype(np.float32)
    rel = 1e-5 if out_dtype == torch.float32 else 2.0 ** -7
    err = np.abs(got - ref)
    assert np.all((err <= rel * np.abs(ref) + 1e-6)[~flipped])
    assert np.all((err <= _flip_tol(amax, ws))[flipped])


def test_q_block_linear_refuses_as_jax():
    """The TPU kernel's two refusals, on every device: a fused layernorm over
    K % 128 != 0, and quant_out over N % 128 != 0."""
    x = torch.zeros((8, 96))
    wq = torch.zeros((128, 96), dtype=torch.int8)
    ws = torch.ones(128)
    with pytest.raises(ValueError, match="K % 128"):
        q_block_linear(x, wq, ws, ln_scale=torch.ones(96), ln_bias=torch.zeros(96))
    with pytest.raises(ValueError, match="K % 128"):
        jax_qbl(jnp.zeros((8, 96)), jnp.zeros((96, 128), jnp.int8), jnp.ones(128),
                ln_scale=jnp.ones(96), ln_bias=jnp.zeros(96), interpret=True)
    with pytest.raises(ValueError, match="N % 128"):
        q_block_linear_plain(torch.zeros((8, 128)), torch.zeros((72, 128), dtype=torch.int8),
                             torch.ones(72), quant_out=True)
    with pytest.raises(ValueError, match="N % 128"):
        jax_qbl(jnp.zeros((8, 128)), jnp.zeros((128, 72), jnp.int8), jnp.ones(72),
                quant_out=True, interpret=True)


# ---- K7: int8 qkv with per-token scales ---------------------------------------

def _q8_inputs(rng, b, s, w):
    """int8 qkv from a dynamic per-token quantize of normal values, with its
    float32 [B, S, 1] scales (the int8 wire's own producer)."""
    qkv = rng.normal(0, 1, (b, s, 3 * w)).astype(np.float32)
    amax = np.maximum(np.abs(qkv).max(-1, keepdims=True), 1e-8)
    q = np.clip(np.round(qkv / (amax / 127)), -127, 127).astype(np.int8)
    return q, (amax / 127 * 1.7).astype(np.float32)  # scores of std ~2


@pytest.mark.parametrize("out", ["bfloat16", "float32", "quant_out"])
@pytest.mark.parametrize("b,s,s_real,w,heads", [
    (2, 17, 17, 128, 2), (2, 50, 43, 128, 2), (1, 577, 577, 128, 2), (1, 40, 40, 144, 2),
])
def test_q8_attention_plain_matches_jax(rng, b, s, s_real, w, heads, out):
    """K7's plain version against ``fused_attention_packed_q8`` in interpret
    mode: bfloat16 and float32 outputs within 2e-2 (K1's bf16 tolerance: the
    heads are bf16); quant_out int8 ±1 on ≤ 0.1% of entries, per-token
    scales within 1e-5 on ≥ 95% of tokens and 2^-8 on all (K1's quant_out
    tolerances: a P value on the other bf16 neighbour moves a few)."""
    qkv, sc = _q8_inputs(rng, b, s, w)
    scale = (w // heads) ** -0.5
    kw = dict(quant_out=out == "quant_out")
    if out != "quant_out":
        kw["out_dtype"] = getattr(torch, out)
    ref = jattn.fused_attention_packed_q8(
        _j(qkv), _j(sc), heads=heads, scale=scale, interpret=True, s_real=s_real,
        **{k: JDT.get(v, v) for k, v in kw.items()})
    got = tattn.fused_attention_packed_q8(_t(qkv), _t(sc), heads, scale, s_real=s_real, **kw)
    if out != "quant_out":
        assert got.dtype == kw["out_dtype"] and got.shape == (b, s, w)
        err = np.abs(got.float().numpy() - np.asarray(ref).astype(np.float32))[:, :s_real]
        assert err.max() <= 2e-2
        return
    (gq, gs), (rq, rs) = got, ref
    assert gq.dtype == torch.int8 and gq.shape == (b, s, w) and gs.shape == (b, s, 1)
    diff = np.abs(gq.numpy().astype(np.int32) - np.asarray(rq).astype(np.int32))[:, :s_real]
    assert diff.max() <= 1 and (diff > 0).mean() <= FLIP_SHARE
    rel = np.abs(gs.numpy() / np.asarray(rs) - 1)[:, :s_real]
    assert (rel > 1e-5).mean() <= 5e-2 and rel.max() <= 2.0 ** -8


@pytest.mark.parametrize("kernel", ["K1", "K7"])
def test_quant_out_long_sequence_plain_matches_jax(rng, kernel):
    """quant_out at S=4096 (one head of 128): K1's and K7's plain versions
    against ``fused_attention_packed`` and ``fused_attention_packed_q8`` in
    interpret mode. The int8 values stay within ±1 on ≤ 0.1% of entries and
    every token's scale within 2^-8; the share of tokens over 1e-5, held to
    5% up to S=729, grows with S here too (the two sum P·V in other orders),
    so the card's long-sequence miss is the reference's as well."""
    s, w = 4096, 128
    if kernel == "K1":
        qkv = rng.normal(0, 1, (1, s, 3 * w)).astype(np.float32)
        rq, rs = jattn.fused_attention_packed(_j(qkv, torch.bfloat16), heads=1, scale=w ** -0.5,
                                              interpret=True, quant_out=True)
        gq, gs = tattn.fused_attention_packed(_t(qkv, torch.bfloat16), 1, w ** -0.5,
                                              quant_out=True)
    else:
        qkv, sc = _q8_inputs(rng, 1, s, w)
        rq, rs = jattn.fused_attention_packed_q8(_j(qkv), _j(sc), heads=1, scale=w ** -0.5,
                                                 interpret=True, quant_out=True)
        gq, gs = tattn.fused_attention_packed_q8(_t(qkv), _t(sc), 1, w ** -0.5, quant_out=True)
    diff = np.abs(gq.numpy().astype(np.int32) - np.asarray(rq).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= FLIP_SHARE
    assert np.abs(gs.numpy() / np.asarray(rs) - 1).max() <= 2.0 ** -8


def test_q8_attention_is_not_the_xla_fold(rng):
    """K7 multiplies q by rs·scale before the bf16 cast; the JAX package's
    ``attention_packed_q8_xla`` folds the scale into the dequantized q. At a
    scale that is not a power of two the two differ, and the plain version
    follows the kernel."""
    qkv, sc = _q8_inputs(rng, 1, 33, 96)
    ref = np.asarray(jattn.fused_attention_packed_q8(_j(qkv), _j(sc), heads=2, scale=0.3,
                                                     interpret=True, out_dtype=jnp.float32))
    xla = np.asarray(jattn.attention_packed_q8_xla(_j(qkv), _j(sc), 2, 0.3)).astype(np.float32)
    got = tattn.fused_attention_packed_q8(_t(qkv), _t(sc), 2, 0.3, out_dtype=torch.float32)
    assert np.abs(got.numpy() - ref).max() < np.abs(xla - ref).max()


# ---- K10: unpacked [B, h, S, d] attention -------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,scale", [
    (2, 3, 9, 8, 0.3), (2, 3, 37, 32, 32 ** -0.5), (1, 2, 577, 64, 0.125), (1, 2, 50, 72, 0.3),
])
def test_unpacked_attention_plain_matches_jax(rng, b, h, s, d, scale, dtype):
    """K10's plain version against ``fused_attention`` in interpret mode (S
    padded to a multiple of 8 and masked there): float32 within 1e-5,
    bfloat16 within 2e-2."""
    q, k, v = (rng.normal(0, 1, (b, h, s, d)).astype(np.float32) for _ in range(3))
    ref = jattn.fused_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype), scale=scale,
                                interpret=True)
    got = tattn.fused_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), scale)
    assert got.dtype == dtype and got.shape == (b, h, s, d)
    assert np.abs(got.float().numpy() - np.asarray(ref).astype(np.float32)).max() <= TOL[dtype]


# ---- K5 with RoPE -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,grid,cls,s_real,w,heads", [
    (2, 10, False, 100, 256, 2),   # one panel
    (1, 27, False, 729, 128, 2),   # two panels of 368 keys
    (1, 27, True, 700, 192, 2),    # S = 730 with a cls row, masked tail, head dim 96
])
def test_flash_rope_plain_matches_jax(rng, b, grid, cls, s_real, w, heads, dtype):
    """K5 with RoPE: q scaled in the input dtype and then rotated, k rotated
    unscaled, each k panel with its own table rows, against the JAX flash
    kernel in interpret mode: float32 within 1e-5, bfloat16 within 2e-2."""
    s, d = grid * grid + cls, w // heads
    cos, sin = _rope2d_tables(grid, d, 10000.0, cls)
    qkv = rng.normal(0, 1, (b, s, 3 * w)).astype(np.float32)
    ref = jattn.flash_attention_packed(_j(qkv, dtype), heads=heads, scale=d ** -0.5,
                                       interpret=True, s_real=s_real, rope=(_j(cos), _j(sin)))
    got = tattn.flash_attention_packed(_t(qkv, dtype), heads, d ** -0.5, s_real,
                                       rope=(_t(cos), _t(sin)))
    err = np.abs(got.float().numpy() - np.asarray(ref).astype(np.float32))[:, :s_real]
    assert err.max() <= TOL[dtype]


def test_packed_attention_auto_rope_on_the_flash_route(rng, monkeypatch):
    """The smallest S whose route is flash for bf16 qkv of width 384 (4 heads
    of 96: the grouped gate depends on S and the head dim): the port's
    ``packed_attention_auto`` runs K5 with RoPE there (it raised before K5
    had the option) and matches the JAX ``packed_attention_auto`` (Pallas in
    interpret mode) within 2e-2."""
    w, heads = 384, 4
    d = w // heads
    s = next(s for s in range(8, 4096, 8) if tattn.attention_route(s, w, heads, 2) == "flash")
    s = next(t for t in range(s - 7, s + 1) if tattn.attention_route(t, w, heads, 2) == "flash")
    assert tattn.attention_route(s - 1, w, heads, 2) == "grouped"
    ang = rng.uniform(0, 30, (s, d // 2))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    qkv = rng.normal(0, 1, (1, s, 3 * w)).astype(np.float32)
    before = tattn.flash_attention_packed.launches
    got = tattn.packed_attention_auto(_t(qkv, torch.bfloat16), heads, d ** -0.5,
                                      rope=(_t(cos), _t(sin)))
    assert tattn.flash_attention_packed.launches == before  # the plain version on the CPU
    monkeypatch.setenv("CTPU_PALLAS_INTERPRET", "1")  # read when the JAX kernel is traced
    ref = jattn.packed_attention_auto(_j(qkv, torch.bfloat16), heads=heads, scale=d ** -0.5,
                                      rope=(_j(cos), _j(sin)))
    err = np.abs(got.float().numpy() - np.asarray(ref).astype(np.float32))
    assert err.max() <= 2e-2
