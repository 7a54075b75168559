"""The port's kernel plain versions against the JAX package's Pallas kernels
(run in interpret mode on the CPU): K1 packed attention (with and without
RoPE), K2 layernorm + static int8 quantize, K3 the int8 attention wire, K4
head-grouped attention, K5 flash attention; the port's calibration attention
against the JAX package's XLA path; and the port's attention route against
the JAX package's choice. On a CPU tensor each port wrapper takes its plain
version, so these tests also pin the dispatch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.ops.attention import attention_xla as jax_attention_xla
from clip_assisted_data_labeling_tpu.ops.attention import (
    flash_attention_packed as jax_flash_attention_packed,
)
from clip_assisted_data_labeling_tpu.ops import attention as jattn
from clip_assisted_data_labeling_tpu.ops.attention import (
    fused_attention_packed as jax_fused_attention_packed,
)
from clip_assisted_data_labeling_tpu.ops.attention import (
    fused_attention_packed_grouped as jax_fused_attention_packed_grouped,
)
from clip_assisted_data_labeling_tpu.ops.attention import (
    fused_attention_packed_q8s as jax_fused_attention_packed_q8s,
)
from clip_assisted_data_labeling_tpu.ops.quant import quant_static as jax_quant_static
from clip_assisted_data_labeling_tpu.ops.quant_kernel import (
    rowquant_static as jax_rowquant_static,
)
from clip_assisted_data_labeling_tpu_torch.models import vit as tvit
from clip_assisted_data_labeling_tpu_torch.ops.attention import (
    attention_route,
    attention_xla,
    flash_attention_packed,
    flash_attention_packed_plain,
    fused_attention_packed,
    fused_attention_packed_grouped,
    fused_attention_packed_grouped_plain,
    fused_attention_packed_plain,
    fused_attention_packed_q8s,
    packed_attention_auto,
)
from clip_assisted_data_labeling_tpu_torch.ops.quant import quant_static
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    rowquant_static,
    rowquant_static_plain,
)

W, HEADS = 128, 2  # head dim 64: the scale 0.125 is exact in bf16
# f32: the same arithmetic, summed in another order; bf16: ~2 bf16 ulps on
# unit-scale outputs (the output rounds to bf16 after float32 sums)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_attention(qkv32: np.ndarray, dtype, s_real):
    out = jax_fused_attention_packed(
        jnp.asarray(qkv32).astype(JNP[dtype]), heads=HEADS, scale=64 ** -0.5,
        s_real=s_real, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_real", [(2, 17, 17), (2, 50, 43), (1, 577, 577)])
def test_packed_attention_plain_matches_pallas(rng, dtype, b, s, s_real):
    qkv = rng.normal(0, 1, (b, s, 3 * W)).astype(np.float32)
    qkv_t = torch.from_numpy(qkv).to(dtype)
    got = fused_attention_packed(qkv_t, heads=HEADS, scale=64 ** -0.5, s_real=s_real)
    assert got.dtype == dtype and got.shape == (b, s, W)
    ref = _jax_attention(qkv_t.float().numpy(), dtype, s_real)
    # rows past s_real are never read downstream; compare the real ones
    err = np.abs(got.float().numpy()[:, :s_real] - ref[:, :s_real]).max()
    assert err <= TOL[dtype], f"{dtype} S={s}: max abs err {err}"


def _rope(s, d):
    """PE's RoPE tables for S tokens (a square grid, with a cls row when S is
    one more than a square), float32 [S, d/2] each."""
    cls = round((s - 1) ** 0.5) ** 2 == s - 1
    cos, sin = tvit._rope2d_tables(round((s - cls) ** 0.5), d, 10000.0, cls)
    assert cos.shape == (s, d // 2)
    return cos, sin


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_real,heads,d", [
    (2, 50, 43, 2, 64),    # 7x7 + cls, masked tail
    (1, 577, 577, 2, 64),  # PE-Core-L14-336's grid: two 296-row tiles in the TPU kernel
    (2, 100, 100, 2, 96),  # head dim 96 (PE-Core-G14-448), no cls row
    (1, 16, 16, 4, 16),    # PE-Test/tiny
])
def test_packed_attention_rope_plain_matches_pallas(rng, dtype, b, s, s_real, heads, d):
    """K1 with RoPE: q scaled in the input dtype, then q and k rotated with
    tables in the input dtype, as the TPU kernel does."""
    w = heads * d
    cos, sin = _rope(s, d)
    qkv_t = torch.from_numpy(rng.normal(0, 1, (b, s, 3 * w)).astype(np.float32)).to(dtype)
    got = fused_attention_packed(qkv_t, heads, d ** -0.5, s_real,
                                 rope=(torch.from_numpy(cos), torch.from_numpy(sin)))
    assert got.dtype == dtype and got.shape == (b, s, w)
    ref = np.asarray(jax_fused_attention_packed(
        jnp.asarray(qkv_t.float().numpy()).astype(JNP[dtype]), heads=heads, scale=d ** -0.5,
        s_real=s_real, rope=(jnp.asarray(cos), jnp.asarray(sin)),
        interpret=True).astype(jnp.float32))
    err = np.abs(got.float().numpy()[:, :s_real] - ref[:, :s_real]).max()
    assert err <= TOL[dtype], f"{dtype} S={s}: max abs err {err}"
    # the rotation matters: without it the outputs move far past the tolerance
    plain = fused_attention_packed(qkv_t, heads, d ** -0.5, s_real)
    assert np.abs(plain.float().numpy()[:, :s_real] - ref[:, :s_real]).max() > 10 * TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_real,heads,d,rope,whole_scores", [
    (2, 50, 43, 2, 64, False, False),
    (2, 50, 43, 2, 64, True, False),
    (1, 577, 577, 2, 64, True, False),   # row-tiled: two 296-row tiles
    (1, 577, 577, 2, 64, True, True),    # the pipelined whole-scores schedule
    (1, 577, 530, 2, 64, False, True),
    (2, 100, 91, 2, 96, True, False),    # head dim 96, PE-Core-G14-448's
])
def test_grouped_attention_plain_matches_pallas(rng, dtype, b, s, s_real, heads, d, rope,
                                                whole_scores):
    """K4: the plain version against ``fused_attention_packed_grouped`` in
    interpret mode, with and without RoPE, a masked tail, and both of the
    TPU kernel's schedules (the same arithmetic)."""
    w = heads * d
    qkv_t = torch.from_numpy(rng.normal(0, 1, (b, s, 3 * w)).astype(np.float32)).to(dtype)
    tables = _rope(s, d) if rope else None
    got = fused_attention_packed_grouped(
        qkv_t, heads, d ** -0.5, s_real,
        rope=None if tables is None else tuple(map(torch.from_numpy, tables)))
    assert got.dtype == dtype and got.shape == (b, s, w)
    ref = np.asarray(jax_fused_attention_packed_grouped(
        jnp.asarray(qkv_t.float().numpy()).astype(JNP[dtype]), heads=heads, scale=d ** -0.5,
        s_real=s_real, rope=None if tables is None else tuple(map(jnp.asarray, tables)),
        whole_scores=whole_scores, head_group=heads if whole_scores else None,
        interpret=True).astype(jnp.float32))
    err = np.abs(got.float().numpy()[:, :s_real] - ref[:, :s_real]).max()
    assert err <= TOL[dtype], f"{dtype} S={s}: max abs err {err}"


def _jax_choice(s, w, heads, itemsize, monkeypatch):
    """Which kernel the JAX package's packed_attention_auto calls for this
    shape (its three kernels replaced by name tags; nothing runs)."""
    for fn, tag in (("fused_attention_packed", "packed"),
                    ("fused_attention_packed_grouped", "grouped"),
                    ("flash_attention_packed", "flash")):
        monkeypatch.setattr(jattn, fn, lambda *a, tag=tag, **k: tag)
    dtype = {2: jnp.bfloat16, 4: jnp.float32}[itemsize]
    return jattn.packed_attention_auto(jax.ShapeDtypeStruct((1, s, 3 * w), dtype),
                                       heads=heads, scale=0.1)


@pytest.mark.parametrize("name", sorted(set(tvit.MODEL_REGISTRY) | {
    "ViT-B-16-SigLIP2-384/webli", "ViT-SO400M-14-SigLIP2-378/webli",
    "ViT-L-16-SigLIP2-512/webli", "ViT-gopt-16-SigLIP2-384/webli"}))
def test_attention_route_is_the_jax_choice(monkeypatch, name):
    """For every tower the port resolves, in bf16 and f32: K1, K4 or K5
    exactly where the JAX package runs whole-block, grouped or flash."""
    cfg = tvit.resolve_config(name)
    for itemsize in (2, 4):
        assert attention_route(cfg.seq_len, cfg.width, cfg.heads, itemsize) == _jax_choice(
            cfg.seq_len, cfg.width, cfg.heads, itemsize, monkeypatch), itemsize


def test_pe_routes():
    """The routes the PE slice rests on: PE-L14 bf16 (the int8_static path's
    qkv) → K1, f32 → K4; PE-G14 in both → K4; ViT-L-14-336 f32 → K4."""
    route = {n: tvit.resolve_config(n) for n in ("PE-Core-L14-336", "PE-Core-G14-448",
                                                 "PE-Core-B16-224", "ViT-L-14-336/openai")}
    got = {n: tuple(attention_route(c.seq_len, c.width, c.heads, i) for i in (2, 4))
           for n, c in route.items()}
    assert got == {"PE-Core-L14-336": ("packed", "grouped"),
                   "PE-Core-G14-448": ("grouped", "grouped"),
                   "PE-Core-B16-224": ("packed", "packed"),
                   "ViT-L-14-336/openai": ("packed", "grouped")}


def test_auto_refuses_rope_on_the_flash_route(rng):
    """No registered RoPE tower reaches flash; a shape that would is no
    longer refused: K5 now has the RoPE option, and the route runs it with
    the rotation (as the JAX package's flash kernel does), not without it."""
    s, heads, d = 729, 16, 72  # SO400M-384's float32 shape
    assert attention_route(s, heads * d, heads, 4) == "flash"
    qkv = torch.from_numpy(rng.normal(0, 1, (1, s, 3 * heads * d)).astype(np.float32))
    ang = torch.from_numpy(rng.uniform(0, 30, (s, d // 2)).astype(np.float32))
    tables = (torch.cos(ang), torch.sin(ang))
    got = packed_attention_auto(qkv, heads, 0.1, rope=tables)
    assert torch.equal(got, flash_attention_packed_plain(qkv, heads, 0.1, rope=tables))
    assert not torch.equal(got, flash_attention_packed_plain(qkv, heads, 0.1))


def test_grouped_wrapper_uses_plain_on_cpu(rng):
    qkv = torch.from_numpy(rng.normal(0, 1, (1, 9, 3 * W)).astype(np.float32))
    before = fused_attention_packed_grouped.launches
    a = fused_attention_packed_grouped(qkv, heads=HEADS, scale=0.125)
    b = fused_attention_packed_grouped_plain(qkv, heads=HEADS, scale=0.125)
    assert torch.equal(a, b)
    assert fused_attention_packed_grouped.launches == before  # no kernel launch on the CPU


def test_packed_attention_wrapper_uses_plain_on_cpu(rng):
    qkv = torch.from_numpy(rng.normal(0, 1, (1, 9, 3 * W)).astype(np.float32))
    before = fused_attention_packed.launches
    a = fused_attention_packed(qkv, heads=HEADS, scale=0.125)
    b = fused_attention_packed_plain(qkv, heads=HEADS, scale=0.125)
    assert torch.equal(a, b)
    assert fused_attention_packed.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [18, 577])
def test_rowquant_static_plain_matches_pallas(rng, dtype, m):
    k = 128
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    lns = rng.normal(1, 0.1, (k,)).astype(np.float32)
    lnb = rng.normal(0, 0.1, (k,)).astype(np.float32)
    amax = np.float32(6.0)
    x_t = torch.from_numpy(x).to(dtype)
    got = rowquant_static(x_t, torch.from_numpy(lns), torch.from_numpy(lnb),
                          torch.tensor([amax]))
    assert got.dtype == torch.int8 and got.shape == (m, k)
    ref = np.asarray(jax_rowquant_static(
        jnp.asarray(x_t.float().numpy()).astype(JNP[dtype]), jnp.asarray(lns),
        jnp.asarray(lnb), amax, block_m=8, interpret=True))
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    # sums taken in another order can flip a round-half boundary: ±1, rarely
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_rowquant_static_no_amax_floor_and_clip():
    """Like the TPU kernel: no 1e-8 floor on amax, values beyond ±amax clip."""
    x = torch.tensor([[0.0, 1.0, 2.0, 3.0] * 32])
    q = rowquant_static_plain(x, torch.ones(128), torch.zeros(128), torch.tensor([0.5]))
    assert q.max().item() == 127 and q.min().item() == -127


@pytest.mark.parametrize("b,s,heads,d", [(2, 9, 3, 8), (1, 729, 2, 72)])
def test_q8s_attention_plain_matches_pallas(rng, b, s, heads, d):
    """K3. At S=729 the JAX kernel pads to 736 and runs two 368-row tiles."""
    w = heads * d
    qkv = rng.integers(-127, 128, (b, s, 3 * w)).astype(np.int8)
    # scores of std ~3 at d=72, outputs over much of the int8 range
    cs = np.concatenate([rng.uniform(0.5, 1.5, 2 * w) * 8e-3,
                         rng.uniform(0.5, 1.5, w) * 0.5]).astype(np.float32)
    got = fused_attention_packed_q8s(torch.from_numpy(qkv), torch.from_numpy(cs), heads)
    assert got.dtype == torch.int8 and got.shape == (b, s, w)
    ref = np.asarray(jax_fused_attention_packed_q8s(
        jnp.asarray(qkv), jnp.asarray(cs), heads=heads, scale=d ** -0.5, interpret=True))
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    # float32 sums in another order can move a value across a half: ±1, rarely
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    assert np.abs(ref).mean() > 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,s_real,heads,d", [(1, 729, 729, 2, 72), (2, 50, 43, 2, 64)])
def test_flash_attention_plain_matches_pallas(rng, dtype, b, s, s_real, heads, d):
    """K5, with the JAX flash kernel's panels (368 keys at S=729)."""
    w = heads * d
    qkv_t = torch.from_numpy(rng.normal(0, 1, (b, s, 3 * w)).astype(np.float32)).to(dtype)
    got = flash_attention_packed(qkv_t, heads, d ** -0.5, s_real)
    assert got.dtype == dtype and got.shape == (b, s, w)
    ref = np.asarray(jax_flash_attention_packed(
        jnp.asarray(qkv_t.float().numpy()).astype(JNP[dtype]), heads=heads, scale=d ** -0.5,
        s_real=s_real, interpret=True).astype(jnp.float32))
    err = np.abs(got.float().numpy()[:, :s_real] - ref[:, :s_real]).max()
    # bf16: at most one bf16 ulp of these outputs (seen: 9.8e-4 at S=729;
    # f32 4.2e-7)
    assert err <= TOL[dtype], f"{dtype} S={s}: max abs err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_xla_matches_jax(rng, dtype):
    q, k, v = (rng.normal(0, 1, (2, 3, 20, 16)).astype(np.float32) for _ in range(3))
    got = attention_xla(*(torch.from_numpy(t).to(dtype) for t in (q, k, v)), scale=0.3)
    assert got.dtype == dtype
    ref = np.asarray(jax_attention_xla(*(jnp.asarray(t).astype(JNP[dtype]) for t in (q, k, v)),
                                       0.3).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL[dtype] / 2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_static_per_channel_bit_exact(rng, dtype):
    """The int8 wire's per-channel quantize (and the per-tensor one) equal
    the JAX package's, bit for bit; a dead channel quantizes to zeros."""
    x = rng.normal(0, 2, (7, 48)).astype(np.float32)
    amax = rng.uniform(0.5, 4, 48).astype(np.float32)
    x[:, 3], amax[3] = 0.0, 0.0  # a dead channel: no NaN from 0 * (127 / 0)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy()).astype(JNP[dtype])
    for a in (amax, amax[5]):
        got = quant_static(xt, torch.from_numpy(np.asarray(a)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_quant_static(xj, a)))
    assert not quant_static(xt, torch.from_numpy(amax))[:, 3].any()
